// K6 sorted_group_agg: grouped aggregation states over sorted packed
// keys, for key domains too large for a direct table.
//
// Replaces: presto_tpu/ops/aggregate.py _sorted_group_ids,
// _SortCtx.sum and the sort path of grouped_aggregate, and
// merge_aggregate with _merge_states (count, sum, avg, min and max
// states; _seg_min/_seg_max, _minmax_long), which XLA ran as a gather
// + cumsum + boundary difference over the sort's permutation; and
// _presorted_group_ids, grouped_aggregate's streaming branch.
//
// Bound on the H100: memory.  Past the sort (torch.sort, as the
// reference leaves its argsort to XLA), the sorted keys and the sort
// permutation are read once, each argument column once through the
// permutation (a gather), and the group states and representative
// keys written once.  TPC-H Q3 at SF10 groups each ~2^23-row lineitem
// split's probe output (~10^5 live rows) and then merges the partials.
//
// Design: keys.cu writes the masked key, exact or hashed (K9) (NULL
// keys group together, dead rows take a sentinel that sorts last).  After the sort, k6_heads flags each run's first position and
// the exclusive scan of scan.cuh numbers the groups in packed-key
// order, the reference's group order; the host reads the group count
// once and sizes the outputs from it (count, allocate, write), so a
// partial emits every group it sees.  k6_accumulate gives each thread
// K6_CHUNK consecutive sorted positions: it adds its rows' states
// locally while the group stays the same and flushes each run with one
// 64-bit atomicAdd per non-zero slot, so a long run costs one atomic
// per chunk and short runs (Q3's few rows per order) one per run.  The
// thread at a run's head writes the group's representative key (its
// first row in input order, since the sort is stable).  Long sums add
// four base-10^9 limbs, so every add is an exact integer add and the
// result does not depend on the order of the atomics.  k6_finish
// normalises the limbs to the reference's two base-10^18 limbs.
//
// min/max: a slot that starts at the int64 extreme no value passes;
// a run folds its rows locally and flushes with one atomicMin or
// atomicMax.  A long decimal orders limb by limb, high limb first, so
// it takes the reference's phased walk: a first accumulate launch
// reduces the high limb, a second one the low limb over the rows whose
// high limb ties the group's.  An empty state keeps the identity (an
// int32 state the int32 one).
//
// Presorted mode (streaming aggregation, equal keys arrive together):
// no sort.  k6_presorted_order numbers the live rows by an exclusive
// scan of their live flags and writes each live row's key and position
// to its rank, the dead rows' sentinel after them; the heads, scan and
// states passes then run unchanged over that page-order sequence, so a
// run's head is a live row whose key differs from the previous live
// row's (the reference's forward fill across dead rows) and groups
// come out in first-appearance order.

#include "keys.cuh"
#include "scan.cuh"

#define K6_MAX_STATES 16
#define K6_MAX_SLOTS 64
#define K6_CHUNK 16

// state kinds: keep in step with kernels/sorted_group_agg.py
enum { S_ONE = 0, S_VALID = 1, S_SUM = 2, S_LIMBS_SHORT = 3, S_LIMBS_LONG = 4, S_MIN = 5,
       S_MAX = 6, S_MIN_LONG = 7, S_MAX_LONG = 8 };

__host__ __device__ __forceinline__ int state_width(int kind) {
  return (kind == S_LIMBS_SHORT || kind == S_LIMBS_LONG) ? 4
      : (kind == S_MIN_LONG || kind == S_MAX_LONG) ? 2 : 1;
}

struct K6Desc {
  int n_keys;
  const uint8_t* key_src[PK_MAX_KEYS];
  const uint8_t* key_valid[PK_MAX_KEYS];
  uint8_t* key_dst[PK_MAX_KEYS];
  uint8_t* key_dst_valid[PK_MAX_KEYS];
  int key_width[PK_MAX_KEYS];
  int n_states;
  int kind[K6_MAX_STATES];
  int slot[K6_MAX_STATES];  // first raw slot
  const void* data[K6_MAX_STATES];
  int data_kind[K6_MAX_STATES];
  const uint8_t* valid[K6_MAX_STATES];
  i64* out[K6_MAX_STATES];  // (G,) or (G, 2) limbs; int32 where out_i32
  int out_i32[K6_MAX_STATES];
  int raw_width;
  uint8_t slot_kind[K6_MAX_SLOTS];  // SLOT_ADD, SLOT_MIN or SLOT_MAX
};

__device__ __forceinline__ void copy_key(const uint8_t* src, uint8_t* dst, int width,
                                         i64 from, i64 to) {
  if (width == 1) dst[to] = src[from];
  else if (width == 4) ((int*)dst)[to] = ((const int*)src)[from];
  else ((i64*)dst)[to] = ((const i64*)src)[from];
}

__device__ __forceinline__ bool is_head(const i64* sk, i64 i) {
  return sk[i] != I64_MAX && (i == 0 || sk[i] != sk[i - 1]);
}

static __global__ void k6_flags(const i64* __restrict__ sk, i64 n, int* __restrict__ flags) {
  const i64 stride = (i64)gridDim.x * blockDim.x;
  for (i64 i = (i64)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride)
    flags[i] = is_head(sk, i);
}

// phase 0: every state but the low limb of a long min/max; phase 1:
// that low limb, for rows whose high limb equals the group's (raw)
__device__ __forceinline__ void add_row(const K6Desc& d, i64 row, i64* acc, int phase,
                                        const i64* group_raw) {
  for (int s = 0; s < d.n_states; ++s) {
    i64* a = acc + d.slot[s];
    const int kind = d.kind[s];
    const bool long_extreme = kind == S_MIN_LONG || kind == S_MAX_LONG;
    if (phase == 1) {
      if (!long_extreme || !d.valid[s][row]) continue;
      const i64* x = (const i64*)d.data[s] + 2 * row;
      if (x[0] == group_raw[d.slot[s]])
        a[1] = kind == S_MIN_LONG ? (x[1] < a[1] ? x[1] : a[1]) : (x[1] > a[1] ? x[1] : a[1]);
      continue;
    }
    if (kind == S_ONE) { a[0] += 1; continue; }
    if (!d.valid[s][row]) continue;
    if (kind == S_VALID) { a[0] += 1; continue; }
    if (kind == S_SUM) {
      a[0] = wadd(a[0], pk_load(d.data[s], d.data_kind[s], row));
      continue;
    }
    if (kind == S_MIN || kind == S_MAX) {
      const i64 x = pk_load(d.data[s], d.data_kind[s], row);
      a[0] = kind == S_MIN ? (x < a[0] ? x : a[0]) : (x > a[0] ? x : a[0]);
      continue;
    }
    if (long_extreme) {  // the high limb; phase 1 takes the low one
      const i64 x = ((const i64*)d.data[s])[2 * row];
      a[0] = kind == S_MIN_LONG ? (x < a[0] ? x : a[0]) : (x > a[0] ? x : a[0]);
      continue;
    }
    i64 hi, lo;
    if (kind == S_LIMBS_SHORT) {  // from_int64
      const i64 x = pk_load(d.data[s], d.data_kind[s], row);
      hi = fdiv(x, B18);
      lo = x - hi * B18;
    } else {
      hi = ((const i64*)d.data[s])[2 * row];
      lo = ((const i64*)d.data[s])[2 * row + 1];
    }
    a[0] += fdiv(hi, B9);  // to_sum_limbs: each limb below 10^9 in size
    a[1] += fmod_(hi, B9);
    a[2] += fdiv(lo, B9);
    a[3] += fmod_(lo, B9);
  }
}

__device__ __forceinline__ void flush(const K6Desc& d, i64 g, i64* acc, u64* raw) {
  u64* r = raw + g * d.raw_width;
  for (int j = 0; j < d.raw_width; ++j) {
    const int kind = d.slot_kind[j];
    if (acc[j] != slot_identity(kind)) slot_combine(r + j, acc[j], kind);
    acc[j] = slot_identity(kind);
  }
}

static __global__ void k6_init(const K6Desc d, i64 slots, i64* __restrict__ raw) {
  const i64 stride = (i64)gridDim.x * blockDim.x;
  for (i64 j = (i64)blockIdx.x * blockDim.x + threadIdx.x; j < slots; j += stride)
    raw[j] = slot_identity(d.slot_kind[j % d.raw_width]);
}

static __global__ void k6_accumulate(const K6Desc d, const i64* __restrict__ sk,
                                     const i64* __restrict__ order, i64 n,
                                     const int* __restrict__ scan, u64* __restrict__ raw,
                                     int phase) {
  i64 acc[K6_MAX_SLOTS];
  for (int j = 0; j < d.raw_width; ++j) acc[j] = slot_identity(d.slot_kind[j]);
  const i64 stride = (i64)gridDim.x * blockDim.x * K6_CHUNK;
  for (i64 base = ((i64)blockIdx.x * blockDim.x + threadIdx.x) * K6_CHUNK; base < n;
       base += stride) {
    i64 cur = -1;
    const i64 end = base + K6_CHUNK < n ? base + K6_CHUNK : n;
    for (i64 i = base; i < end; ++i) {
      if (sk[i] == I64_MAX) break;  // dead rows sort last
      const bool head = is_head(sk, i);
      const i64 g = scan[i] + (head ? 1 : 0) - 1;
      if (g != cur) {
        if (cur >= 0) flush(d, cur, acc, raw);
        cur = g;
      }
      const i64 row = order[i];
      if (head && phase == 0) {
        for (int k = 0; k < d.n_keys; ++k) {
          copy_key(d.key_src[k], d.key_dst[k], d.key_width[k], row, g);
          d.key_dst_valid[k][g] = d.key_valid[k][row];
        }
      }
      add_row(d, row, acc, phase, (const i64*)raw + g * d.raw_width);
    }
    if (cur >= 0) flush(d, cur, acc, raw);
  }
}

static __global__ void k6_finish(const K6Desc d, i64 groups, const i64* __restrict__ raw) {
  const i64 stride = (i64)gridDim.x * blockDim.x;
  for (i64 g = (i64)blockIdx.x * blockDim.x + threadIdx.x; g < groups; g += stride) {
    const i64* r = raw + g * d.raw_width;
    for (int s = 0; s < d.n_states; ++s) {
      const i64* v = r + d.slot[s];
      if (d.kind[s] == S_MIN_LONG || d.kind[s] == S_MAX_LONG) {
        d.out[s][2 * g] = v[0];
        d.out[s][2 * g + 1] = v[1];
        continue;
      }
      if (d.out_i32[s]) {
        ((int*)d.out[s])[g] = narrow_extreme(v[0]);
        continue;
      }
      if (d.kind[s] != S_LIMBS_SHORT && d.kind[s] != S_LIMBS_LONG) {
        d.out[s][g] = v[0];
        continue;
      }
      // from_sum_limbs, then normalize (ops/decimal128.py)
      i64 h1 = v[0], h0 = v[1], l1 = v[2], l0 = v[3];
      i64 c = fdiv(l0, B9);
      l0 -= c * B9;
      l1 += c;
      c = fdiv(l1, B9);
      l1 -= c * B9;
      const i64 hi_extra = c;
      i64 lo = l1 * B9 + l0;
      c = fdiv(h0, B9);
      h0 -= c * B9;
      h1 += c;
      i64 hi = wadd(wadd(wmul(h1, B9), h0), hi_extra);
      c = fdiv(lo, B18);
      lo -= c * B18;
      d.out[s][2 * g] = wadd(hi, c);
      d.out[s][2 * g + 1] = lo;
    }
  }
}

static __global__ void k6_live_flags(const i64* __restrict__ masked, i64 n,
                                     int* __restrict__ flags) {
  const i64 stride = (i64)gridDim.x * blockDim.x;
  for (i64 i = (i64)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride)
    flags[i] = masked[i] != I64_MAX;
}

static __global__ void k6_compact(const i64* __restrict__ masked, i64 n,
                                  const int* __restrict__ rank, i64* __restrict__ sk,
                                  i64* __restrict__ order) {
  const i64 live = rank[n];
  const i64 stride = (i64)gridDim.x * blockDim.x;
  for (i64 i = (i64)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride) {
    if (masked[i] != I64_MAX) {
      sk[rank[i]] = masked[i];
      order[rank[i]] = i;
    }
    if (i >= live) {  // dead rows' sentinel after the live ones
      sk[i] = I64_MAX;
      order[i] = i;
    }
  }
}

// Presorted mode: the page-order sequence of live rows that stands in
// for the sort.  masked: the masked keys (I64_MAX where dead); sk,
// order: n int64 each; rank: n + 1 ints and partials scan_tiles(n) + 1
// ints of scratch.
extern "C" int k6_presorted_order(const void* masked, i64 n, void* sk, void* order,
                                  void* rank, void* partials, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (n > 0)
    k6_live_flags<<<grid_for(n, 256, 8), 256, 0, s>>>((const i64*)masked, n, (int*)rank);
  scan_exclusive_inplace((int*)rank, n, (int*)partials, s);
  if (n > 0)
    k6_compact<<<grid_for(n, 256, 8), 256, 0, s>>>((const i64*)masked, n, (const int*)rank,
                                                   (i64*)sk, (i64*)order);
  return (int)cudaGetLastError();
}

// scan (n + 1 ints): the exclusive count of run heads before each
// sorted position, the group count at [n].  partials: scan_tiles(n) + 1.
extern "C" int k6_group_heads(const void* sorted_keys, i64 n, void* scan, void* partials,
                              void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (n > 0)
    k6_flags<<<grid_for(n, 256, 8), 256, 0, s>>>((const i64*)sorted_keys, n, (int*)scan);
  scan_exclusive_inplace((int*)scan, n, (int*)partials, s);
  return (int)cudaGetLastError();
}

// Per-group states of `groups` groups.  raw: groups * raw_width int64
// of scratch.  Key columns gather into key_dst (groups elements of
// key_width bytes); state s writes out[s].
extern "C" int k6_group_states(const void* sorted_keys, const void* order, i64 n,
                               const void* scan, i64 groups, int n_keys, const i64* key_src,
                               const i64* key_valid, const i64* key_dst,
                               const i64* key_dst_valid, const int* key_width, int n_states,
                               const int* kind, const i64* data, const int* data_kind,
                               const i64* valid, const i64* out, const int* out_i32,
                               void* raw, void* stream) {
  if (n_keys > PK_MAX_KEYS || n_states > K6_MAX_STATES) return (int)cudaErrorInvalidValue;
  K6Desc d;
  d.n_keys = n_keys;
  for (int k = 0; k < n_keys; ++k) {
    d.key_src[k] = (const uint8_t*)key_src[k];
    d.key_valid[k] = (const uint8_t*)key_valid[k];
    d.key_dst[k] = (uint8_t*)key_dst[k];
    d.key_dst_valid[k] = (uint8_t*)key_dst_valid[k];
    d.key_width[k] = key_width[k];
  }
  d.n_states = n_states;
  int w = 0;
  bool phased = false;
  for (int s = 0; s < n_states; ++s) {
    if (kind[s] < S_ONE || kind[s] > S_MAX_LONG) return (int)cudaErrorInvalidValue;
    const int width = state_width(kind[s]);
    if (w + width > K6_MAX_SLOTS) return (int)cudaErrorInvalidValue;
    d.kind[s] = kind[s];
    d.slot[s] = w;
    const int sk_kind = (kind[s] == S_MIN || kind[s] == S_MIN_LONG) ? SLOT_MIN
        : (kind[s] == S_MAX || kind[s] == S_MAX_LONG) ? SLOT_MAX : SLOT_ADD;
    for (int j = 0; j < width; ++j) d.slot_kind[w + j] = sk_kind;
    phased = phased || kind[s] == S_MIN_LONG || kind[s] == S_MAX_LONG;
    w += width;
    d.data[s] = (const void*)data[s];
    d.data_kind[s] = data_kind[s];
    d.valid[s] = (const uint8_t*)valid[s];
    d.out[s] = (i64*)out[s];
    d.out_i32[s] = out_i32[s];
  }
  d.raw_width = w;
  cudaStream_t st = (cudaStream_t)stream;
  if (groups == 0) return (int)cudaGetLastError();
  k6_init<<<grid_for(groups * w, 256, 8), 256, 0, st>>>(d, groups * w, (i64*)raw);
  const i64 chunks = (n + K6_CHUNK - 1) / K6_CHUNK;
  k6_accumulate<<<grid_for(chunks, 256, 8), 256, 0, st>>>(
      d, (const i64*)sorted_keys, (const i64*)order, n, (const int*)scan, (u64*)raw, 0);
  if (phased)
    k6_accumulate<<<grid_for(chunks, 256, 8), 256, 0, st>>>(
        d, (const i64*)sorted_keys, (const i64*)order, n, (const int*)scan, (u64*)raw, 1);
  k6_finish<<<grid_for(groups, 256, 8), 256, 0, st>>>(d, groups, (const i64*)raw);
  return (int)cudaGetLastError();
}
