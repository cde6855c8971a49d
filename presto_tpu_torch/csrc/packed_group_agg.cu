// K2 packed_group_agg: per-group partial aggregation states for an
// exact (packed-direct) group key, or for a global aggregation.
//
// Replaces: presto_tpu/ops/aggregate.py pack_or_hash_keys/_key_codes
// (exact mixed-radix branch), grouped_aggregate's global and
// packed-direct branches with _partial_states/_seg_sum, and the
// decimal128 limb sums (ops/decimal128.py from_int64, to_sum_limbs,
// from_sum_limbs) that XLA lowered to segment sums, and the min/max
// states (_seg_min/_seg_max, and _minmax_long for long decimals).
//
// Bound on the H100: memory.  Each row's key codes, argument values,
// their validity and the row mask are read once; the state table is a
// few KB.  The state output is negligible beside the row stream.
//
// Design: one thread per row (grid-stride).  The packed gid is the
// mixed-radix number of the key codes, NULL as code 0, exactly as the
// reference packs it; a global aggregation has gid 0.  Sums whose
// argument precision is <= 15 add in one int64 slot; longer ones add
// four base-10^9 limbs, so every add is an exact integer add and no
// lane wraps.  Integer adds are associative, so the result does not
// depend on the order of the atomics.  When the table (groups x raw
// slots) fits 48 KB, each block accumulates in shared memory and
// merges with one 64-bit atomicAdd per non-zero slot; else the same
// kernel adds straight into the global table.  A second small kernel
// turns the raw table into the reference's partial-state columns
// (limbs normalised to two base-10^18 limbs, the `present` flags).
// min/max keep the extreme in a slot that starts at the int64 extreme
// no value passes and combines by 64-bit atomicMin/atomicMax, beside
// a count of non-null rows; an empty group keeps the identity, as the
// reference's segment_min/segment_max leave it (narrowed to int32's
// for an int32 state).  A long decimal is ordered limb by limb, high
// limb first (canonical limbs order as their values do), so it takes
// the reference's phased walk: a first launch reduces the high limb,
// a second one reduces the low limb over the rows whose high limb
// ties the group's final one.
//
// Double states (a double sum, and the variance state (s, m2, cnt) of
// _partial_states' two-pass form) never use double atomics: their
// order would change from run to run.  They add in one fixed order,
// the same as the plain twin's (chunk_sums_plain): the rows split into
// chunks of K2_DSUM_CHUNK; one block per chunk stages its rows' slots
// and values in shared memory, and one thread per slot adds its rows in
// row order from 0.0; the chunk partials then add pairwise, one launch
// per level (chunk 2i + chunk 2i + 1, ping-pong between two scratch
// halves, an odd last chunk passing up).  Variance runs that twice:
// s, then mu = s / max(cnt, 1), then m2 = sum of (x - mu)^2.  Every
// double operation is an _rn intrinsic, so nothing contracts into an
// FMA and the card rounds as the twin does.  At most
// K2_DOUBLE_SLOT_LIMIT slot: the global aggregate's (the executor sends
// keyed double states to K6).
// Simple first: contended shared atomics on a few groups (TPC-H Q1)
// are the known cost; warp-private tables are a later step.

#include "common.cuh"

#define K2_MAX_KEYS 16
#define K2_MAX_AGGS 32
#define K2_MAX_SLOTS (1 + 5 * K2_MAX_AGGS)
#define K2_SHARED_LIMIT (48 * 1024)
#define K2_DSUM_CHUNK 256
#define K2_DOUBLE_SLOT_LIMIT 1

// aggregate kinds: keep in step with kernels/packed_group_agg.py
enum { AGG_COUNT_STAR = 0, AGG_COUNT = 1, AGG_SUM_SHORT = 2, AGG_SUM_LONG = 3,
       AGG_MIN_SHORT = 4, AGG_MAX_SHORT = 5, AGG_MIN_LONG = 6, AGG_MAX_LONG = 7,
       AGG_SUM_LONG_ARG = 8, AGG_SUM_DOUBLE = 9, AGG_VARIANCE = 10 };
enum { KIND_BOOL = 0, KIND_I32 = 1, KIND_I64 = 2, KIND_D128 = 3, KIND_F64 = 4 };

__host__ __device__ __forceinline__ bool is_double_agg(int kind) {
  return kind == AGG_SUM_DOUBLE || kind == AGG_VARIANCE;
}

__host__ __device__ __forceinline__ int agg_width(int kind) {
  switch (kind) {
    case AGG_SUM_LONG: case AGG_SUM_LONG_ARG: return 5;
    case AGG_MIN_LONG: case AGG_MAX_LONG: return 3;
    case AGG_SUM_SHORT: case AGG_MIN_SHORT: case AGG_MAX_SHORT: return 2;
    default: return 1;
  }
}

__host__ __device__ __forceinline__ bool is_long_extreme(int kind) {
  return kind == AGG_MIN_LONG || kind == AGG_MAX_LONG;
}

struct K2Desc {
  int n_keys;
  const void* key_data[K2_MAX_KEYS];
  const uint8_t* key_valid[K2_MAX_KEYS];
  int key_kind[K2_MAX_KEYS];
  i64 key_lo[K2_MAX_KEYS];
  i64 key_card[K2_MAX_KEYS];
  int n_aggs;
  int agg_kind[K2_MAX_AGGS];
  int agg_slot[K2_MAX_AGGS];  // first raw slot of the aggregate
  const void* arg_data[K2_MAX_AGGS];
  const uint8_t* arg_valid[K2_MAX_AGGS];
  int arg_kind[K2_MAX_AGGS];
  i64* out0[K2_MAX_AGGS];  // count, or sum ((G,) or (G, 2) limbs, or doubles)
  i64* out1[K2_MAX_AGGS];  // count of a sum or a min/max; m2 of a variance
  i64* out2[K2_MAX_AGGS];  // count of a variance
  int raw_width;           // raw slots per group; slot 0 counts live rows
  uint8_t slot_kind[K2_MAX_SLOTS];  // SLOT_ADD, SLOT_MIN or SLOT_MAX
};

__device__ __forceinline__ i64 load_int(const void* p, int kind, i64 i) {
  if (kind == KIND_I64) return ((const i64*)p)[i];
  if (kind == KIND_I32) return ((const int*)p)[i];
  return ((const uint8_t*)p)[i] != 0;
}

__device__ __forceinline__ void add_slot(u64* tab, i64 v) {
  if (v != 0) atomicAdd(tab, (u64)v);  // adding zero changes nothing
}

// the packed gid of row i: the mixed-radix number of its key codes
__device__ __forceinline__ i64 row_key(const K2Desc& d, i64 i) {
  i64 key = 0;
  for (int k = 0; k < d.n_keys; ++k) {
    const i64 code = d.key_valid[k][i]
        ? load_int(d.key_data[k], d.key_kind[k], i) - d.key_lo[k] + 1 : 0;
    key = key * d.key_card[k] + code;
  }
  return key;
}

// phase 0: every state but the low limb of a long min/max; phase 1
// (tab is the device table): that low limb, over the rows whose high
// limb equals the group's reduced one
__device__ __forceinline__ void accumulate_row(const K2Desc& d, i64 i, i64 n_groups,
                                               u64* tab, int phase) {
  const i64 key = row_key(d, i);
  if (key < 0 || key >= n_groups) return;  // out-of-domain ids are dropped
  u64* base = tab + key * d.raw_width;
  if (phase == 1) {
    for (int a = 0; a < d.n_aggs; ++a) {
      const int kind = d.agg_kind[a];
      if (!is_long_extreme(kind) || !d.arg_valid[a][i]) continue;
      const i64* x = (const i64*)d.arg_data[a] + 2 * i;
      u64* s = base + d.agg_slot[a];
      if (x[0] == (i64)*s) slot_combine(s + 1, x[1], kind == AGG_MIN_LONG ? SLOT_MIN : SLOT_MAX);
    }
    return;
  }
  atomicAdd(base, 1ull);
  for (int a = 0; a < d.n_aggs; ++a) {
    u64* s = base + d.agg_slot[a];
    const int kind = d.agg_kind[a];
    if (kind == AGG_COUNT_STAR) { atomicAdd(s, 1ull); continue; }
    if (!d.arg_valid[a][i]) continue;
    if (kind == AGG_COUNT || is_double_agg(kind)) { atomicAdd(s, 1ull); continue; }
    if (is_long_extreme(kind)) {  // the high limb; phase 1 takes the low one
      slot_combine(s, ((const i64*)d.arg_data[a])[2 * i],
                   kind == AGG_MIN_LONG ? SLOT_MIN : SLOT_MAX);
      atomicAdd(s + 2, 1ull);
      continue;
    }
    if (kind == AGG_SUM_LONG_ARG) {  // to_sum_limbs of the argument's limbs
      const i64* x = (const i64*)d.arg_data[a] + 2 * i;
      add_slot(s, fdiv(x[0], B9));
      add_slot(s + 1, fmod_(x[0], B9));
      add_slot(s + 2, fdiv(x[1], B9));
      add_slot(s + 3, fmod_(x[1], B9));
      atomicAdd(s + 4, 1ull);
      continue;
    }
    const i64 x = load_int(d.arg_data[a], d.arg_kind[a], i);
    if (kind == AGG_MIN_SHORT || kind == AGG_MAX_SHORT) {
      slot_combine(s, x, kind == AGG_MIN_SHORT ? SLOT_MIN : SLOT_MAX);
      atomicAdd(s + 1, 1ull);
      continue;
    }
    if (kind == AGG_SUM_SHORT) {
      add_slot(s, x);
      atomicAdd(s + 1, 1ull);
      continue;
    }
    // AGG_SUM_LONG: from_int64 then to_sum_limbs
    const i64 hi = fdiv(x, B18);
    const i64 lo = x - hi * B18;
    add_slot(s, fdiv(hi, B9));
    add_slot(s + 1, fmod_(hi, B9));
    add_slot(s + 2, fdiv(lo, B9));
    add_slot(s + 3, fmod_(lo, B9));
    atomicAdd(s + 4, 1ull);
  }
}

__global__ void k2_init(const K2Desc d, i64 slots, i64* __restrict__ raw) {
  const i64 stride = (i64)gridDim.x * blockDim.x;
  for (i64 j = (i64)blockIdx.x * blockDim.x + threadIdx.x; j < slots; j += stride)
    raw[j] = slot_identity(d.slot_kind[j % d.raw_width]);
}

__global__ void k2_accumulate(const K2Desc d, i64 n, const uint8_t* __restrict__ row_mask,
                              i64 n_groups, u64* __restrict__ raw, int use_shared, int phase) {
  extern __shared__ u64 smem[];
  const i64 slots = n_groups * d.raw_width;
  u64* tab = raw;
  if (use_shared) {
    for (i64 j = threadIdx.x; j < slots; j += blockDim.x)
      smem[j] = (u64)slot_identity(d.slot_kind[j % d.raw_width]);
    __syncthreads();
    tab = smem;
  }
  const i64 stride = (i64)gridDim.x * blockDim.x;
  for (i64 i = (i64)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride) {
    if (row_mask[i]) accumulate_row(d, i, n_groups, tab, phase);
  }
  if (use_shared) {
    __syncthreads();
    for (i64 j = threadIdx.x; j < slots; j += blockDim.x) {
      const int kind = d.slot_kind[j % d.raw_width];
      if ((i64)smem[j] != slot_identity(kind)) slot_combine(raw + j, (i64)smem[j], kind);
    }
  }
}

__global__ void k2_finish(const K2Desc d, i64 n_groups, const i64* __restrict__ raw,
                          uint8_t* __restrict__ present) {
  const i64 g = (i64)blockIdx.x * blockDim.x + threadIdx.x;
  if (g >= n_groups) return;
  const i64* r = raw + g * d.raw_width;
  present[g] = r[0] > 0;
  for (int a = 0; a < d.n_aggs; ++a) {
    const i64* s = r + d.agg_slot[a];
    switch (d.agg_kind[a]) {
      case AGG_COUNT_STAR: case AGG_COUNT: d.out0[a][g] = s[0]; break;
      case AGG_SUM_DOUBLE: d.out1[a][g] = s[0]; break;  // the sum comes later
      case AGG_VARIANCE: d.out2[a][g] = s[0]; break;
      case AGG_SUM_SHORT: d.out0[a][g] = s[0]; d.out1[a][g] = s[1]; break;
      case AGG_MIN_SHORT: case AGG_MAX_SHORT:
        if (d.arg_kind[a] == KIND_I32) ((int*)d.out0[a])[g] = narrow_extreme(s[0]);
        else d.out0[a][g] = s[0];
        d.out1[a][g] = s[1];
        break;
      case AGG_MIN_LONG: case AGG_MAX_LONG:
        d.out0[a][2 * g] = s[0];
        d.out0[a][2 * g + 1] = s[1];
        d.out1[a][g] = s[2];
        break;
      default: {  // AGG_SUM_LONG(_ARG): from_sum_limbs, then normalize
        i64 h1 = s[0], h0 = s[1], l1 = s[2], l0 = s[3];
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
        hi = wadd(hi, c);
        d.out0[a][2 * g] = hi;
        d.out0[a][2 * g + 1] = lo;
        d.out1[a][g] = s[4];
      }
    }
  }
}

// One block per chunk of K2_DSUM_CHUNK rows: the chunk's partial sum
// per slot, each slot's rows in row order from 0.0.  With mu set, a
// row adds (x - mu[slot])^2 in place of x (variance's second pass).
__global__ void k2_dsum_chunks(const K2Desc d, int a, i64 n,
                               const uint8_t* __restrict__ row_mask, i64 n_groups,
                               const double* __restrict__ mu, double* __restrict__ part) {
  __shared__ int sg[K2_DSUM_CHUNK];
  __shared__ double sx[K2_DSUM_CHUNK];
  const i64 base = (i64)blockIdx.x * K2_DSUM_CHUNK;
  for (int j = threadIdx.x; j < K2_DSUM_CHUNK; j += blockDim.x) {
    const i64 i = base + j;
    int g = -1;
    double x = 0.0;
    if (i < n && row_mask[i] && d.arg_valid[a][i]) {
      const i64 key = row_key(d, i);
      if (key >= 0 && key < n_groups) {
        g = (int)key;
        x = ((const double*)d.arg_data[a])[i];
        if (mu != nullptr) {
          const double dx = __dsub_rn(x, mu[g]);
          x = __dmul_rn(dx, dx);
        }
      }
    }
    sg[j] = g;
    sx[j] = x;
  }
  __syncthreads();
  for (i64 g = threadIdx.x; g < n_groups; g += blockDim.x) {
    double acc = 0.0;
    for (int j = 0; j < K2_DSUM_CHUNK; ++j)
      if (sg[j] == g) acc = __dadd_rn(acc, sx[j]);
    part[(i64)blockIdx.x * n_groups + g] = acc;
  }
}

// One level of the pairwise sum over chunk rows: dst row i = src row
// 2i + src row 2i + 1 (an odd last row passes up).
__global__ void k2_dsum_level(const double* __restrict__ src, i64 rows, i64 n_groups,
                              double* __restrict__ dst) {
  const i64 half = (rows + 1) / 2;
  const i64 stride = (i64)gridDim.x * blockDim.x;
  for (i64 t = (i64)blockIdx.x * blockDim.x + threadIdx.x; t < half * n_groups; t += stride) {
    const i64 i = t / n_groups, g = t % n_groups;
    const double l = src[2 * i * n_groups + g];
    dst[t] = 2 * i + 1 < rows ? __dadd_rn(l, src[(2 * i + 1) * n_groups + g]) : l;
  }
}

// The pairwise total into out; with cnt set, mu = total / max(cnt, 1)
// into mu_out as well.
__global__ void k2_dsum_out(const double* __restrict__ total, i64 n_groups,
                            double* __restrict__ out, const i64* __restrict__ cnt,
                            double* __restrict__ mu_out) {
  const i64 g = (i64)blockIdx.x * blockDim.x + threadIdx.x;
  if (g >= n_groups) return;
  out[g] = total[g];
  if (cnt != nullptr)
    mu_out[g] = __ddiv_rn(total[g], __ll2double_rn(cnt[g] > 1 ? cnt[g] : 1));
}

// The fixed-order per-slot sum of aggregate a (mu: see k2_dsum_chunks)
// into out; scratch holds chunks * n_groups + (chunks + 1) / 2 *
// n_groups doubles.
static void k2_double_pass(const K2Desc& d, int a, i64 n, const uint8_t* row_mask,
                           i64 n_groups, const double* mu, double* scratch, double* out,
                           const i64* cnt, double* mu_out, cudaStream_t s) {
  i64 rows = n > 0 ? (n + K2_DSUM_CHUNK - 1) / K2_DSUM_CHUNK : 1;
  double* a_buf = scratch;
  double* b_buf = scratch + rows * n_groups;
  if (n > 0)
    k2_dsum_chunks<<<(unsigned)rows, 128, 0, s>>>(d, a, n, row_mask, n_groups, mu, a_buf);
  else
    cudaMemsetAsync(a_buf, 0, n_groups * sizeof(double), s);
  while (rows > 1) {
    const i64 half = (rows + 1) / 2;
    k2_dsum_level<<<grid_for(half * n_groups, 256, 4), 256, 0, s>>>(a_buf, rows, n_groups,
                                                                     b_buf);
    double* t = a_buf;
    a_buf = b_buf;
    b_buf = t;
    rows = half;
  }
  k2_dsum_out<<<(int)((n_groups + 127) / 128), 128, 0, s>>>(a_buf, n_groups, out, cnt, mu_out);
}

// raw: int64 scratch of n_groups * raw_width.  out0/out1: the output
// columns per aggregate (out1 only for sums and min/max; out0 of a
// min/max has the argument's storage).  present: (G,) bool.  Returns
// cudaGetLastError() after the launches.
extern "C" int k2_packed_group_agg(i64 n, const void* row_mask,
                                   int n_keys, const i64* key_data, const i64* key_valid,
                                   const int* key_kind, const i64* key_lo, const i64* key_card,
                                   int n_aggs, const int* agg_kind, const i64* arg_data,
                                   const i64* arg_valid, const int* arg_kind,
                                   i64 n_groups, int raw_width, void* raw,
                                   const i64* out0, const i64* out1, const i64* out2,
                                   void* present, void* scratch, void* stream) {
  if (n_keys > K2_MAX_KEYS || n_aggs > K2_MAX_AGGS || n_groups < 1)
    return (int)cudaErrorInvalidValue;
  K2Desc d;
  d.n_keys = n_keys;
  for (int k = 0; k < n_keys; ++k) {
    d.key_data[k] = (const void*)key_data[k];
    d.key_valid[k] = (const uint8_t*)key_valid[k];
    d.key_kind[k] = key_kind[k];
    d.key_lo[k] = key_lo[k];
    d.key_card[k] = key_card[k];
  }
  d.n_aggs = n_aggs;
  int slot = 1;
  bool phased = false;
  d.slot_kind[0] = SLOT_ADD;
  for (int a = 0; a < n_aggs; ++a) {
    const int kind = agg_kind[a];
    if (kind < AGG_COUNT_STAR || kind > AGG_VARIANCE) return (int)cudaErrorInvalidValue;
    if (is_double_agg(kind) && n_groups > K2_DOUBLE_SLOT_LIMIT)
      return (int)cudaErrorInvalidValue;
    d.agg_kind[a] = kind;
    d.agg_slot[a] = slot;
    for (int j = 0; j < agg_width(kind); ++j) d.slot_kind[slot + j] = SLOT_ADD;
    if (kind == AGG_MIN_SHORT || kind == AGG_MIN_LONG) d.slot_kind[slot] = SLOT_MIN;
    if (kind == AGG_MAX_SHORT || kind == AGG_MAX_LONG) d.slot_kind[slot] = SLOT_MAX;
    if (is_long_extreme(kind)) d.slot_kind[slot + 1] = d.slot_kind[slot];
    phased = phased || is_long_extreme(kind);
    slot += agg_width(kind);
    d.arg_data[a] = (const void*)arg_data[a];
    d.arg_valid[a] = (const uint8_t*)arg_valid[a];
    d.arg_kind[a] = arg_kind[a];
    d.out0[a] = (i64*)out0[a];
    d.out1[a] = (i64*)out1[a];
    d.out2[a] = (i64*)out2[a];
  }
  if (slot != raw_width) return (int)cudaErrorInvalidValue;
  d.raw_width = raw_width;
  cudaStream_t s = (cudaStream_t)stream;
  const int threads = 256;
  const i64 smem = n_groups * (i64)raw_width * 8;
  const int use_shared = smem <= K2_SHARED_LIMIT;
  k2_init<<<grid_for(n_groups * raw_width, threads, 4), threads, 0, s>>>(
      d, n_groups * raw_width, (i64*)raw);
  if (n > 0) {
    k2_accumulate<<<grid_for(n, threads, 4), threads, use_shared ? (size_t)smem : 0, s>>>(
        d, n, (const uint8_t*)row_mask, n_groups, (u64*)raw, use_shared, 0);
    if (phased)
      k2_accumulate<<<grid_for(n, threads, 4), threads, 0, s>>>(
          d, n, (const uint8_t*)row_mask, n_groups, (u64*)raw, 0, 1);
    const int err = (int)cudaGetLastError();
    if (err != 0) return err;
  }
  k2_finish<<<(int)((n_groups + threads - 1) / threads), threads, 0, s>>>(
      d, n_groups, (const i64*)raw, (uint8_t*)present);
  for (int a = 0; a < n_aggs; ++a) {
    if (!is_double_agg(d.agg_kind[a])) continue;
    const bool var = d.agg_kind[a] == AGG_VARIANCE;
    double* sum = (double*)d.out0[a];
    double* m2 = (double*)d.out1[a];  // holds mu until the second pass ends
    k2_double_pass(d, a, n, (const uint8_t*)row_mask, n_groups, nullptr, (double*)scratch,
                   sum, var ? d.out2[a] : nullptr, var ? m2 : nullptr, s);
    if (var)
      k2_double_pass(d, a, n, (const uint8_t*)row_mask, n_groups, m2, (double*)scratch, m2,
                     nullptr, nullptr, s);
  }
  return (int)cudaGetLastError();
}
