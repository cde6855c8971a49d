// K5 join_probe: the row-aligned probe of an inner join with a
// unique (or first-match) build.
//
// Replaces: presto_tpu/ops/join.py _probe_keys, _lookup_first and
// probe_join (kind inner), which XLA fused into the probe chain.
//
// Bound on the H100: memory.  Each probe row reads its key columns and
// row mask once and writes the new row mask; a live row then touches
// two 32-byte sectors for the lookup (starts[k], starts[k+1]; perm)
// and one sector per gathered build column, and writes each gathered
// value once.  For TPC-H Q14 and Q3 at SF10 that is ~10-20 B per probe
// row plus ~100 B per matched row, per 2^23-row lineitem split.
//
// Design: one fused kernel, one thread per probe row (grid-stride):
// pack the key exactly (keys.cuh); dead rows and NULL keys take a
// sentinel that never matches; read starts[k] and starts[k+1] of the
// direct table (or, without one, binary-search the sorted keys); write
// the match into the row mask; gather each build output column's data
// and valid bit through perm.  An unmatched row's gathered data is 0.
// Simple first: gathers are per element, not vectorised, and the build
// table is not staged in shared memory.

#include "keys.cuh"

#define K5_MAX_COLS 32

struct K5Cols {
  int n;
  const uint8_t* src[K5_MAX_COLS];
  const uint8_t* src_valid[K5_MAX_COLS];
  uint8_t* dst[K5_MAX_COLS];
  uint8_t* dst_valid[K5_MAX_COLS];
  int width[K5_MAX_COLS];  // bytes per element: 1, 4, 8 or 16
};

__device__ __forceinline__ void copy_elem(const uint8_t* src, uint8_t* dst, int width,
                                          i64 from, i64 to, bool keep) {
  switch (width) {
    case 1: dst[to] = keep ? src[from] : 0; break;
    case 4: ((int*)dst)[to] = keep ? ((const int*)src)[from] : 0; break;
    case 8: ((i64*)dst)[to] = keep ? ((const i64*)src)[from] : 0; break;
    default:
      ((i64*)dst)[2 * to] = keep ? ((const i64*)src)[2 * from] : 0;
      ((i64*)dst)[2 * to + 1] = keep ? ((const i64*)src)[2 * from + 1] : 0;
  }
}

static __global__ void k5_probe(PackDesc k, i64 n, const uint8_t* __restrict__ row_mask,
                                const int* __restrict__ starts, i64 domain,
                                const i64* __restrict__ sorted_keys, i64 build_cap,
                                const int* __restrict__ perm, K5Cols cols,
                                uint8_t* __restrict__ out_mask) {
  const i64 stride = (i64)gridDim.x * blockDim.x;
  for (i64 i = (i64)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride) {
    const bool live = row_mask[i] != 0;
    bool ok;
    i64 key = pack_key(k, i, &ok);
    if (!(live && ok)) key = I64_MAX - 1;  // distinct from the build's sentinel
    i64 pos;
    bool found;
    if (starts != nullptr) {
      const i64 kk = key < 0 ? 0 : (key >= domain ? domain - 1 : key);
      const i64 lo = starts[kk], hi = starts[kk + 1];
      found = hi > lo && key >= 0 && key < domain;
      pos = lo;
    } else {
      i64 lo = 0, hi = build_cap;  // lower bound of key in the sorted keys
      while (lo < hi) {
        const i64 mid = (lo + hi) >> 1;
        if (sorted_keys[mid] < key) lo = mid + 1;
        else hi = mid;
      }
      pos = lo < build_cap ? lo : build_cap - 1;
      found = sorted_keys[pos] == key;
    }
    pos = pos < 0 ? 0 : (pos >= build_cap ? build_cap - 1 : pos);
    const bool match = found && live;
    out_mask[i] = match;
    const i64 row = match ? perm[pos] : 0;
    for (int c = 0; c < cols.n; ++c) {
      copy_elem(cols.src[c], cols.dst[c], cols.width[c], row, i, match);
      cols.dst_valid[c][i] = match && cols.src_valid[c][row] != 0;
    }
  }
}

// Probes n rows.  starts (domain + 1 ints) may be null: then the
// sorted keys are binary-searched.  Each of the n_cols build output
// columns gathers into dst/dst_valid (n elements of width bytes).
extern "C" int k5_join_probe(i64 n, const void* row_mask, int n_keys, const i64* key_data,
                             const i64* key_valid, const int* key_kind, const i64* key_lo,
                             const i64* key_card, const void* starts, i64 domain,
                             const void* sorted_keys, i64 build_cap, const void* perm,
                             int n_cols, const i64* src, const i64* src_valid,
                             const i64* dst, const i64* dst_valid, const int* width,
                             void* out_mask, void* stream) {
  PackDesc k;
  if (fill_pack_desc(&k, n_keys, key_data, key_valid, key_kind, key_lo, key_card) ||
      n_cols > K5_MAX_COLS || build_cap < 1)
    return (int)cudaErrorInvalidValue;
  K5Cols cols;
  cols.n = n_cols;
  for (int c = 0; c < n_cols; ++c) {
    cols.src[c] = (const uint8_t*)src[c];
    cols.src_valid[c] = (const uint8_t*)src_valid[c];
    cols.dst[c] = (uint8_t*)dst[c];
    cols.dst_valid[c] = (uint8_t*)dst_valid[c];
    cols.width[c] = width[c];
  }
  if (n > 0)
    k5_probe<<<grid_for(n, 256, 8), 256, 0, (cudaStream_t)stream>>>(
        k, n, (const uint8_t*)row_mask, (const int*)starts, domain,
        (const i64*)sorted_keys, build_cap, (const int*)perm, cols, (uint8_t*)out_mask);
  return (int)cudaGetLastError();
}
