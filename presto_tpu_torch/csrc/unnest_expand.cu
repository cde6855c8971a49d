// K13 unnest_expand: container rows expanded into one row per element
// (UNNEST, WITH ORDINALITY, several containers zipped to the longest),
// and the flattening of a lambda's containers into element lanes.
//
// Replaces: presto_tpu/ops/container.py unnest_expand (:472; executor
// presto_tpu/exec/local.py:1275), which XLA ran as a static
// capacity x slots repeat of every column with a liveness mask, and
// the lambdas' repeat of the page over the slot axis
// (presto_tpu/expr/compile.py :2116-:2355).
//
// Bound on the H100: memory.  Pass 1 reads each row's length slots,
// validity and row mask once and writes one int64 count; the scan
// reads and writes them again.  Pass 2 writes every output column once
// per output row and reads, per output row, one slot of each container
// and the outer row (the replicated columns repeat their row's bytes,
// which the L2 serves).  Unnesting 15M arrays of ~4 int64 elements
// (TPC-H SF10 lineitem by order) writes ~60M rows of three 8-byte
// columns and their validity: ~1.6 GB, ~0.5 ms at 3.35 TB/s.
//
// Design: the shape of K8 join_expand.  Pass 1, one thread per row:
// the row's count is the longest of its containers (a NULL container
// counts 0, a dead row 0), at most the widest slot count; a
// device-wide exclusive scan (scan.cuh, 64-bit) gives the offsets and
// the total, which the host reads once to size the output (count,
// allocate, write).  Pass 2 gives each thread one OUTPUT row
// (grid-stride): a binary search of the offsets finds the source row,
// the rank within it is the slot, and the thread writes the outer
// columns (any width, in 8-, 4- or 1-byte words), each container's
// element in its output type (NULL past that container's length or on
// a sentinel), and the ordinality.  The output keeps the reference's
// order: row first, then slot.

#include "scan.cuh"

#define K13_MAX_ARGS 8
#define K13_MAX_HALVES 16
#define K13_MAX_COLS 64

enum { U_BOOL = 0, U_I32 = 1, U_I64 = 2, U_F64 = 3 };

struct K13Args {
  int n;
  const uint8_t* data[K13_MAX_ARGS];
  const uint8_t* valid[K13_MAX_ARGS];
  int kind[K13_MAX_ARGS];
  int width[K13_MAX_ARGS];
  int slots[K13_MAX_ARGS];
};

struct K13Out {
  int n_halves;
  int arg[K13_MAX_HALVES];
  int first[K13_MAX_HALVES];
  int kind[K13_MAX_HALVES];
  uint8_t* dst[K13_MAX_HALVES];
  uint8_t* dst_valid[K13_MAX_HALVES];
  int n_cols;
  const uint8_t* src[K13_MAX_COLS];
  const uint8_t* src_valid[K13_MAX_COLS];
  uint8_t* col_dst[K13_MAX_COLS];
  uint8_t* col_dst_valid[K13_MAX_COLS];
  int bytes[K13_MAX_COLS];
  i64* ord;
};

// slot j of row r of container a, as an int64 or a double, and whether
// it is NULL
__device__ __forceinline__ bool k13_slot(const K13Args& a, int k, i64 r, i64 j, i64* iv,
                                         double* dv) {
  const i64 idx = r * a.width[k] + j;
  switch (a.kind[k]) {
    case U_I32: {
      const int x = ((const int*)a.data[k])[idx];
      *iv = x;
      *dv = (double)x;
      return x == (int)0x80000000;
    }
    case U_I64: {
      const i64 x = ((const i64*)a.data[k])[idx];
      *iv = x;
      *dv = (double)x;
      return x == I64_MIN;
    }
    default: {
      const double x = ((const double*)a.data[k])[idx];
      *dv = x;
      *iv = isnan(x) ? 0 : (i64)x;
      return isnan(x);
    }
  }
}

__device__ __forceinline__ i64 k13_len(const K13Args& a, int k, i64 r) {
  i64 iv;
  double dv;
  if (k13_slot(a, k, r, 0, &iv, &dv)) return 0;
  return iv < 0 ? 0 : iv;
}

static __global__ void k13_count(K13Args a, i64 n, const uint8_t* __restrict__ row_mask,
                                 u64* __restrict__ counts) {
  int widest = 0;
  for (int k = 0; k < a.n; ++k) widest = a.slots[k] > widest ? a.slots[k] : widest;
  const i64 stride = (i64)gridDim.x * blockDim.x;
  for (i64 r = (i64)blockIdx.x * blockDim.x + threadIdx.x; r < n; r += stride) {
    i64 c = 0;
    if (row_mask[r]) {
      for (int k = 0; k < a.n; ++k) {
        const i64 l = a.valid[k][r] ? k13_len(a, k, r) : 0;
        c = l > c ? l : c;
      }
      c = c < widest ? c : widest;
    }
    counts[r] = (u64)c;
  }
}

// the last row whose offset is <= j
__device__ __forceinline__ i64 k13_row_of(const i64* __restrict__ offsets, i64 n, i64 j) {
  i64 lo = 0, hi = n;
  while (lo < hi) {
    const i64 mid = (lo + hi) >> 1;
    if (offsets[mid] <= j) lo = mid + 1;
    else hi = mid;
  }
  return lo - 1;
}

__device__ __forceinline__ void k13_copy(const uint8_t* src, uint8_t* dst, int bytes, i64 from,
                                         i64 to) {
  if ((bytes & 7) == 0) {
    const i64* s = (const i64*)(src + from * bytes);
    i64* d = (i64*)(dst + to * bytes);
    for (int w = 0; w < bytes / 8; ++w) d[w] = s[w];
  } else if ((bytes & 3) == 0) {
    const int* s = (const int*)(src + from * bytes);
    int* d = (int*)(dst + to * bytes);
    for (int w = 0; w < bytes / 4; ++w) d[w] = s[w];
  } else {
    for (int w = 0; w < bytes; ++w) dst[to * bytes + w] = src[from * bytes + w];
  }
}

static __global__ void k13_expand(K13Args a, K13Out o, i64 n, const i64* __restrict__ offsets,
                                  i64 total) {
  const i64 stride = (i64)gridDim.x * blockDim.x;
  for (i64 j = (i64)blockIdx.x * blockDim.x + threadIdx.x; j < total; j += stride) {
    const i64 r = k13_row_of(offsets, n, j);
    const i64 s = j - offsets[r];
    for (int c = 0; c < o.n_cols; ++c) {
      k13_copy(o.src[c], o.col_dst[c], o.bytes[c], r, j);
      o.col_dst_valid[c][j] = o.src_valid[c][r];
    }
    for (int h = 0; h < o.n_halves; ++h) {
      const int k = o.arg[h];
      i64 iv = 0;
      double dv = 0.0;
      bool ok = a.valid[k][r] && s < a.slots[k] && s < k13_len(a, k, r);
      if (ok) ok = !k13_slot(a, k, r, o.first[h] + s, &iv, &dv);
      switch (o.kind[h]) {
        case U_BOOL: o.dst[h][j] = ok ? (a.kind[k] == U_F64 ? dv != 0.0 : iv != 0) : 0; break;
        case U_I32: ((int*)o.dst[h])[j] = ok ? (int)iv : 0; break;
        case U_I64: ((i64*)o.dst[h])[j] = ok ? iv : 0; break;
        default: ((double*)o.dst[h])[j] = ok ? (a.kind[k] == U_F64 ? dv : (double)iv) : 0.0;
      }
      o.dst_valid[h][j] = ok;
    }
    if (o.ord != nullptr) o.ord[j] = s + 1;
  }
}

static inline int fill_args(K13Args* a, int n_args, const i64* data, const i64* valid,
                            const int* kind, const int* width, const int* slots) {
  if (n_args < 1 || n_args > K13_MAX_ARGS) return 1;
  a->n = n_args;
  for (int k = 0; k < n_args; ++k) {
    if (kind[k] < U_I32 || kind[k] > U_F64 || width[k] < 1 || slots[k] < 0) return 1;
    a->data[k] = (const uint8_t*)data[k];
    a->valid[k] = (const uint8_t*)valid[k];
    a->kind[k] = kind[k];
    a->width[k] = width[k];
    a->slots[k] = slots[k];
  }
  return 0;
}

// Pass 1 and the scan: offsets (n + 1 int64) and the total at [n];
// partials: scan_tiles(n) + 1 int64.
extern "C" int k13_unnest_count(i64 n, const void* row_mask, int n_args, const i64* data,
                                const i64* valid, const int* kind, const int* width,
                                const int* slots, void* offsets, void* partials,
                                void* stream) {
  K13Args a;
  if (fill_args(&a, n_args, data, valid, kind, width, slots)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (n > 0)
    k13_count<<<grid_for(n, 256, 8), 256, 0, s>>>(a, n, (const uint8_t*)row_mask,
                                                    (u64*)offsets);
  scan_exclusive_inplace<u64>((u64*)offsets, n, (u64*)partials, s);
  return (int)cudaGetLastError();
}

// Pass 2: `total` output rows.
extern "C" int k13_unnest_expand(i64 n, const void* offsets, i64 total, int n_args,
                                 const i64* data, const i64* valid, const int* kind,
                                 const int* width, const int* slots, int n_halves,
                                 const int* half_arg, const int* half_first,
                                 const int* half_kind, const i64* dst, const i64* dst_valid,
                                 int n_cols, const i64* src, const i64* src_valid,
                                 const i64* col_dst, const i64* col_dst_valid,
                                 const int* bytes, void* ord, void* stream) {
  K13Args a;
  if (fill_args(&a, n_args, data, valid, kind, width, slots)) return (int)cudaErrorInvalidValue;
  if (n_halves < 1 || n_halves > K13_MAX_HALVES || n_cols < 0 || n_cols > K13_MAX_COLS)
    return (int)cudaErrorInvalidValue;
  K13Out o;
  o.n_halves = n_halves;
  for (int h = 0; h < n_halves; ++h) {
    if (half_arg[h] < 0 || half_arg[h] >= n_args || half_kind[h] < U_BOOL ||
        half_kind[h] > U_F64 || half_first[h] < 1)
      return (int)cudaErrorInvalidValue;
    o.arg[h] = half_arg[h];
    o.first[h] = half_first[h];
    o.kind[h] = half_kind[h];
    o.dst[h] = (uint8_t*)dst[h];
    o.dst_valid[h] = (uint8_t*)dst_valid[h];
  }
  o.n_cols = n_cols;
  for (int c = 0; c < n_cols; ++c) {
    if (bytes[c] < 1) return (int)cudaErrorInvalidValue;
    o.src[c] = (const uint8_t*)src[c];
    o.src_valid[c] = (const uint8_t*)src_valid[c];
    o.col_dst[c] = (uint8_t*)col_dst[c];
    o.col_dst_valid[c] = (uint8_t*)col_dst_valid[c];
    o.bytes[c] = bytes[c];
  }
  o.ord = (i64*)ord;
  if (total > 0)
    k13_expand<<<grid_for(total, 256, 8), 256, 0, (cudaStream_t)stream>>>(
        a, o, n, (const i64*)offsets, total);
  return (int)cudaGetLastError();
}
