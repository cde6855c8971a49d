// K6 sorted_group_agg: grouped aggregation states over sorted packed
// keys, for key domains too large for a direct table.
//
// Replaces: presto_tpu/ops/aggregate.py _sorted_group_ids,
// _SortCtx.sum and the sort path of grouped_aggregate, and
// merge_aggregate with _merge_states (count, sum, avg, min and max
// states; _seg_min/_seg_max, _minmax_long), which XLA ran as a gather
// + cumsum + boundary difference over the sort's permutation; and
// _presorted_group_ids, grouped_aggregate's streaming branch; and the
// function surface's states and their merge (_partial_states :454,
// :492, :498, :569; _merge_states :1136, :1144, :1171).
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
// Double states (a double sum; the variance state (s, m2, cnt) of
// _partial_states' two passes; its merge, _merge_states' Chan form
// M2 = sum of m2_i + c_i (mu_i - mu)^2) take no atomics: a double
// atomicAdd's order changes from run to run.  Each group's sorted run
// splits into chunks of K6_DSUM_CHUNK positions; k6_dchunks gives each
// chunk one thread that adds its values in sorted order from 0.0, and
// k6_dtree one thread per group that adds its chunk partials pairwise
// in place (stride 1, 2, 4, ...: the twin's level-by-level order).
// The counts come from integer states of the same launch.  Every double
// operation is an _rn intrinsic, so nothing contracts into an FMA and
// the card rounds as the plain twin (run_sums_plain) does, bit for bit.
//
// Presorted mode (streaming aggregation, equal keys arrive together):
// no sort.  k6_presorted_order numbers the live rows by an exclusive
// scan of their live flags and writes each live row's key and position
// to its rank, the dead rows' sentinel after them; the heads, scan and
// states passes then run unchanged over that page-order sequence, so a
// run's head is a live row whose key differs from the previous live
// row's (the reference's forward fill across dead rows) and groups
// come out in first-appearance order.
//
// The function surface: a double's min/max reduces an int64 order key
// (common.cuh minmax_key: -0.0 below 0.0, NaN moved to win, as the
// reference's segment reductions propagate it) and turns it back at the
// end; a boolean's min/max reads 0/1 and stores the fold's neutral
// value in an empty state; bitwise_and_agg / bitwise_or_agg fold by and
// / or (slot_fold locally, atomicAnd / atomicOr on a flush; the
// reference's _seg_assoc); hll_merge's sum of 2^-rho (S_HLL) takes the
// double states' fixed order, each weight exact from its bits.
//
// The coupled and statistical states (_partial_states :480, :536 and
// _merge_states :1118, :1151): S_MOM runs the double pass four times,
// s, then sum dx*dx, (dx*dx)*dx and (dx*dx)*(dx*dx) with dx = x - mu;
// S_MOM_MERGE adds s_i, then m2_i + c_i d^2, m3_i + 3 m2_i d + c_i d^3
// and m4_i + 4 m3_i d + 6 m2_i d^2 + c_i d^4 with d = mu_i - mu, each
// in the reference's association.  min_by / max_by are three states,
// S_BY_X, S_BY_XV and S_BY_Y_MIN or S_BY_Y_MAX: the first accumulate
// launch reduces y's order key (a double's minmax_key), the second one
// (the phase of the long extremes) reads the group's reduced y and, over
// the rows whose y equals it as a value (a NaN extreme ties nothing),
// takes the greatest x by its order key (S_BY_X) and counts the rows
// with a valid x (S_BY_XV, stored as the 0/1 flag).  checksum is an
// S_SUM of K1's hashes (wadd wraps).

#include "keys.cuh"
#include "scan.cuh"

#define K6_MAX_STATES 32
#define K6_MAX_SLOTS 64
#define K6_CHUNK 16
#define K6_DSUM_CHUNK 256

// state kinds: keep in step with kernels/sorted_group_agg.py
enum { S_ONE = 0, S_VALID = 1, S_SUM = 2, S_LIMBS_SHORT = 3, S_LIMBS_LONG = 4, S_MIN = 5,
       S_MAX = 6, S_MIN_LONG = 7, S_MAX_LONG = 8, S_DSUM = 9, S_VAR = 10, S_VAR_MERGE = 11,
       S_MIN_F64 = 12, S_MAX_F64 = 13, S_BAND = 14, S_BOR = 15, S_HLL = 16, S_MOM = 17,
       S_MOM_MERGE = 18, S_BY_Y_MIN = 19, S_BY_Y_MAX = 20, S_BY_X = 21, S_BY_XV = 22 };
// how k6_finish stores a state (kernels/sorted_group_agg.py _OUT_KINDS)
enum { OUT_I64 = 0, OUT_I32 = 1, OUT_BOOL = 2, OUT_F64 = 3 };
// a state's data: pk_load's kinds, or a double's bits (DATA_F64)
#define DATA_F64 3

__host__ __device__ __forceinline__ bool is_int_state(int kind) {
  return (kind >= S_ONE && kind <= S_MAX_LONG) || (kind >= S_MIN_F64 && kind <= S_BOR) ||
         (kind >= S_BY_Y_MIN && kind <= S_BY_XV);
}

// min_by / max_by: the order key of a y (is_min: min_by's) or an x
// (the max side)
__device__ __forceinline__ i64 by_key(const void* p, int kind, i64 row, bool is_min) {
  if (kind == DATA_F64) return minmax_key(((const i64*)p)[row], is_min);
  return pk_load(p, kind, row);
}

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
  i64* out[K6_MAX_STATES];  // (G,) or (G, 2) limbs; int32 or bool by out_kind
  int out_kind[K6_MAX_STATES];
  int raw_width;
  uint8_t slot_kind[K6_MAX_SLOTS];  // SLOT_ADD, SLOT_MIN, SLOT_MAX, SLOT_AND or SLOT_OR
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
      if (kind == S_BY_X || kind == S_BY_XV) {  // over the rows tied at y's extreme
        const int y = s + (kind == S_BY_X ? 2 : 1);
        if (!d.valid[s][row] || !d.valid[y][row]) continue;
        const bool y_min = d.kind[y] == S_BY_Y_MIN;
        const i64 best = group_raw[d.slot[y]];
        const bool tie = d.data_kind[y] == DATA_F64
            ? __longlong_as_double(((const i64*)d.data[y])[row]) ==
                  __longlong_as_double(minmax_value(best, y_min))
            : pk_load(d.data[y], d.data_kind[y], row) == best;
        if (!tie) continue;
        if (kind == S_BY_XV) a[0] += 1;
        else a[0] = slot_fold(a[0], by_key(d.data[s], d.data_kind[s], row, false), SLOT_MAX);
        continue;
      }
      if (!long_extreme || !d.valid[s][row]) continue;
      const i64* x = (const i64*)d.data[s] + 2 * row;
      if (x[0] == group_raw[d.slot[s]])
        a[1] = kind == S_MIN_LONG ? (x[1] < a[1] ? x[1] : a[1]) : (x[1] > a[1] ? x[1] : a[1]);
      continue;
    }
    if (kind == S_ONE) { a[0] += 1; continue; }
    if (kind == S_BY_X || kind == S_BY_XV || !d.valid[s][row]) continue;  // BY_X(V): phase 1
    if (kind == S_BY_Y_MIN || kind == S_BY_Y_MAX) {
      a[0] = slot_fold(a[0], by_key(d.data[s], d.data_kind[s], row, kind == S_BY_Y_MIN),
                       d.slot_kind[d.slot[s]]);
      continue;
    }
    if (kind == S_VALID) { a[0] += 1; continue; }
    if (kind == S_SUM) {
      a[0] = wadd(a[0], pk_load(d.data[s], d.data_kind[s], row));
      continue;
    }
    if (kind == S_MIN || kind == S_MAX || kind == S_BAND || kind == S_BOR) {
      a[0] = slot_fold(a[0], pk_load(d.data[s], d.data_kind[s], row), d.slot_kind[d.slot[s]]);
      continue;
    }
    if (kind == S_MIN_F64 || kind == S_MAX_F64) {  // by the order key (common.cuh)
      a[0] = slot_fold(a[0], minmax_key(((const i64*)d.data[s])[row], kind == S_MIN_F64),
                       d.slot_kind[d.slot[s]]);
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
      if (d.kind[s] == S_MIN_F64 || d.kind[s] == S_MAX_F64) {
        d.out[s][g] = minmax_value(v[0], d.kind[s] == S_MIN_F64);
        continue;
      }
      if (d.kind[s] == S_BY_XV) {
        d.out[s][g] = v[0] > 0;
        continue;
      }
      if (d.out_kind[s] == OUT_F64) {  // a min_by / max_by double: its order key back
        d.out[s][g] = minmax_value(v[0], d.kind[s] == S_BY_Y_MIN);
        continue;
      }
      if (d.out_kind[s] == OUT_I32) {
        ((int*)d.out[s])[g] = narrow_extreme(v[0]);
        continue;
      }
      if (d.out_kind[s] == OUT_BOOL) {  // an empty state: the fold's neutral value
        ((uint8_t*)d.out[s])[g] = v[0] == I64_MIN ? 0 : v[0] != 0;
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

// The run of each group: starts[g] = the first sorted position of group
// g, starts[groups] = the live positions' count (dead rows sort last, on
// the sentinel key).  starts: groups + 1 int64.
static __global__ void k6_starts(const i64* __restrict__ sk, i64 n, const int* __restrict__ scan,
                                 i64 groups, i64* __restrict__ starts) {
  const i64 stride = (i64)gridDim.x * blockDim.x;
  for (i64 p = (i64)blockIdx.x * blockDim.x + threadIdx.x; p < n; p += stride) {
    if (scan[p + 1] != scan[p]) starts[scan[p]] = p;
    if (sk[p] != I64_MAX && (p + 1 == n || sk[p + 1] == I64_MAX)) starts[groups] = p + 1;
  }
}

extern "C" int k6_run_starts(const void* sorted_keys, i64 n, const void* scan, i64 groups,
                             void* starts, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  cudaMemsetAsync(starts, 0, (size_t)(groups + 1) * sizeof(i64), s);
  if (n > 0)
    k6_starts<<<grid_for(n, 256, 8), 256, 0, s>>>((const i64*)sorted_keys, n,
                                                   (const int*)scan, groups, (i64*)starts);
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
                               const i64* valid, const i64* out, const int* out_kind,
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
    if (!is_int_state(kind[s])) return (int)cudaErrorInvalidValue;
    const int width = state_width(kind[s]);
    if (w + width > K6_MAX_SLOTS) return (int)cudaErrorInvalidValue;
    d.kind[s] = kind[s];
    d.slot[s] = w;
    // S_BY_X's partner y is two states on, S_BY_XV's one
    if ((kind[s] == S_BY_X && !(s + 2 < n_states && kind[s + 1] == S_BY_XV &&
                                (kind[s + 2] == S_BY_Y_MIN || kind[s + 2] == S_BY_Y_MAX))) ||
        (kind[s] == S_BY_XV && (s == 0 || kind[s - 1] != S_BY_X)))
      return (int)cudaErrorInvalidValue;
    const int sk_kind = (kind[s] == S_MIN || kind[s] == S_MIN_LONG || kind[s] == S_MIN_F64 ||
                         kind[s] == S_BY_Y_MIN)
        ? SLOT_MIN
        : (kind[s] == S_MAX || kind[s] == S_MAX_LONG || kind[s] == S_MAX_F64 ||
           kind[s] == S_BY_Y_MAX || kind[s] == S_BY_X) ? SLOT_MAX
        : kind[s] == S_BAND ? SLOT_AND : kind[s] == S_BOR ? SLOT_OR : SLOT_ADD;
    for (int j = 0; j < width; ++j) d.slot_kind[w + j] = sk_kind;
    phased = phased || kind[s] == S_MIN_LONG || kind[s] == S_MAX_LONG || kind[s] == S_BY_X;
    w += width;
    d.data[s] = (const void*)data[s];
    d.data_kind[s] = data_kind[s];
    d.valid[s] = (const uint8_t*)valid[s];
    d.out[s] = (i64*)out[s];
    d.out_kind[s] = out_kind[s];
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

// ---------------------------------------------------------------------------
// double states
// ---------------------------------------------------------------------------

// starts[g]: the sorted position of group g's first row; starts[groups]:
// the number of live rows
static __global__ void k6_run_starts(const i64* __restrict__ sk, i64 n,
                                     const int* __restrict__ scan, i64 groups,
                                     i64* __restrict__ starts) {
  const i64 stride = (i64)gridDim.x * blockDim.x;
  for (i64 i = (i64)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride) {
    if (sk[i] == I64_MAX) continue;
    if (is_head(sk, i)) starts[scan[i]] = i;
    if (i == n - 1 || sk[i + 1] == I64_MAX) starts[groups] = i + 1;
  }
}

// base[g]: the number of chunks of group g (base[groups]: 0), to be
// scanned into each group's first chunk
static __global__ void k6_run_chunks(const i64* __restrict__ starts, i64 groups,
                                     int* __restrict__ base) {
  const i64 g = (i64)blockIdx.x * blockDim.x + threadIdx.x;
  if (g < groups) base[g] = (int)((starts[g + 1] - starts[g] + K6_DSUM_CHUNK - 1) / K6_DSUM_CHUNK);
  else if (g == groups) base[g] = 0;
}

static __global__ void k6_chunk_groups(const int* __restrict__ base, i64 groups,
                                       int* __restrict__ chunk_group) {
  const i64 g = (i64)blockIdx.x * blockDim.x + threadIdx.x;
  if (g >= groups) return;
  for (int c = base[g]; c < base[g + 1]; ++c) chunk_group[c] = (int)g;
}

// One thread per chunk: the chunk's values in sorted order from 0.0.
// pass 0 adds x (a merge: s_i); pass 1 adds (x - mu)^2 (a variance
// merge: m2_i + c_i (mu_i - mu)^2, mu_i = s_i / max(c_i, 1)); the
// moments' passes 1..3 add dx^2, dx^2 dx, dx^2 dx^2 (a merge: the M2,
// M3, M4 terms of Chan's form with d = mu_i - mu).
static __global__ void k6_dchunks(const i64* __restrict__ order, const i64* __restrict__ starts,
                                  const int* __restrict__ base,
                                  const int* __restrict__ chunk_group, i64 groups, int kind,
                                  int pass, const double* __restrict__ x,
                                  const uint8_t* __restrict__ valid,
                                  const double* __restrict__ m2_in,
                                  const double* __restrict__ m3_in,
                                  const double* __restrict__ m4_in,
                                  const i64* __restrict__ c_in, const double* __restrict__ mu,
                                  double* __restrict__ part) {
  const i64 chunks = base[groups];
  const i64 stride = (i64)gridDim.x * blockDim.x;
  for (i64 t = (i64)blockIdx.x * blockDim.x + threadIdx.x; t < chunks; t += stride) {
    const int g = chunk_group[t];
    const i64 p0 = starts[g] + (t - base[g]) * K6_DSUM_CHUNK;
    const i64 p1 = p0 + K6_DSUM_CHUNK < starts[g + 1] ? p0 + K6_DSUM_CHUNK : starts[g + 1];
    double acc = 0.0;
    for (i64 p = p0; p < p1; ++p) {
      const i64 row = order[p];
      if (!valid[row]) continue;
      double v = kind == S_HLL ? hll_weight(((const i64*)x)[row]) : x[row];
      if (pass == 1 && kind == S_VAR_MERGE) {
        const i64 c = c_in[row];
        const double cf = __ll2double_rn(c);
        const double mu_i = __ddiv_rn(v, cf > 1.0 ? cf : 1.0);
        const double dev = c > 0 ? __dsub_rn(mu_i, mu[g]) : 0.0;
        v = __dadd_rn(m2_in[row], __dmul_rn(__dmul_rn(cf, dev), dev));
      } else if (pass > 0 && kind == S_MOM_MERGE) {
        double t[3];
        moment_terms(v, m2_in[row], m3_in[row], m4_in[row], c_in[row], mu[g], t);
        v = t[pass - 1];
      } else if (pass > 0) {
        const double dx = __dsub_rn(v, mu[g]);
        const double dx2 = __dmul_rn(dx, dx);
        v = pass == 1 ? dx2 : pass == 2 ? __dmul_rn(dx2, dx) : __dmul_rn(dx2, dx2);
      }
      acc = __dadd_rn(acc, v);
    }
    part[t] = acc;
  }
}

// One thread per group: its chunk partials pairwise in place, the sum
// into out; with cnt set, mu = sum / max(cnt, 1) into mu_out.
static __global__ void k6_dtree(const int* __restrict__ base, i64 groups,
                                double* __restrict__ part, double* __restrict__ out,
                                const i64* __restrict__ cnt, double* __restrict__ mu_out) {
  const i64 g = (i64)blockIdx.x * blockDim.x + threadIdx.x;
  if (g >= groups) return;
  double* p = part + base[g];
  const int m = base[g + 1] - base[g];
  for (int w = 1; w < m; w *= 2)
    for (int k = 0; k + w < m; k += 2 * w) p[k] = __dadd_rn(p[k], p[k + w]);
  out[g] = p[0];
  if (cnt != nullptr) mu_out[g] = __ddiv_rn(p[0], __ll2double_rn(cnt[g] > 1 ? cnt[g] : 1));
}

// A double state over the sorted run of each of `groups` groups: kind
// S_DSUM and S_HLL write out_s; S_VAR and S_VAR_MERGE write out_s and
// out_m2 (out_m2 holds mu between the passes), S_MOM and S_MOM_MERGE
// out_s, out_m2, out_m3 and out_m4 (out_m4 holds mu until the last
// pass), with cnt the group counts of their integer state.  x: the
// double argument (a merge: s_i), m2_in, m3_in, m4_in and c_in a
// merge's m2_i, m3_i, m4_i and c_i.  Scratch: starts groups + 1 int64,
// base groups + 1 ints, partials scan_tiles(groups + 1) + 1 ints,
// chunk_group and part `bound` (>= the chunk count) ints and doubles.
extern "C" int k6_double_state(const void* sorted_keys, const void* order, i64 n,
                               const void* scan, i64 groups, int kind, const void* x,
                               const void* valid, const void* m2_in, const void* m3_in,
                               const void* m4_in, const void* c_in, const void* cnt,
                               void* out_s, void* out_m2, void* out_m3, void* out_m4,
                               void* starts, void* base, void* partials, void* chunk_group,
                               void* part, i64 bound, void* stream) {
  if ((kind < S_DSUM || kind > S_VAR_MERGE) && kind != S_HLL && kind != S_MOM &&
      kind != S_MOM_MERGE)
    return (int)cudaErrorInvalidValue;
  if (groups == 0) return (int)cudaGetLastError();
  if ((n + K6_DSUM_CHUNK - 1) / K6_DSUM_CHUNK + groups > bound) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  k6_run_starts<<<grid_for(n, 256, 8), 256, 0, st>>>((const i64*)sorted_keys, n,
                                                     (const int*)scan, groups, (i64*)starts);
  k6_run_chunks<<<(int)((groups + 256) / 256), 256, 0, st>>>((const i64*)starts, groups,
                                                             (int*)base);
  scan_exclusive_inplace((int*)base, groups + 1, (int*)partials, st);
  k6_chunk_groups<<<(int)((groups + 255) / 256), 256, 0, st>>>((const int*)base, groups,
                                                               (int*)chunk_group);
  const bool var = kind == S_VAR || kind == S_VAR_MERGE;
  const bool mom = kind == S_MOM || kind == S_MOM_MERGE;
  double* outs[4] = {(double*)out_s, (double*)out_m2, (double*)out_m3, (double*)out_m4};
  double* mu = mom ? (double*)out_m4 : (double*)out_m2;
  for (int pass = 0; pass < (var ? 2 : mom ? 4 : 1); ++pass) {
    k6_dchunks<<<grid_for(bound, 128, 8), 128, 0, st>>>(
        (const i64*)order, (const i64*)starts, (const int*)base, (const int*)chunk_group,
        groups, kind, pass, (const double*)x, (const uint8_t*)valid, (const double*)m2_in,
        (const double*)m3_in, (const double*)m4_in, (const i64*)c_in,
        pass ? (const double*)mu : nullptr, (double*)part);
    k6_dtree<<<(int)((groups + 127) / 128), 128, 0, st>>>(
        (const int*)base, groups, (double*)part, outs[pass],
        (var || mom) && pass == 0 ? (const i64*)cnt : nullptr, mu);
  }
  return (int)cudaGetLastError();
}
