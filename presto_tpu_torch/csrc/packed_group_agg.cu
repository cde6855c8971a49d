// K2 packed_group_agg: per-group partial aggregation states for an
// exact (packed-direct) group key, or for a global aggregation.
//
// Replaces: presto_tpu/ops/aggregate.py pack_or_hash_keys/_key_codes
// (exact mixed-radix branch), grouped_aggregate's global and
// packed-direct branches with _partial_states/_seg_sum, and the
// decimal128 limb sums (ops/decimal128.py from_int64, to_sum_limbs,
// from_sum_limbs) that XLA lowered to segment sums, and the min/max
// states (_seg_min/_seg_max, and _minmax_long for long decimals); and
// the function surface's partial states (_partial_states :454 min/max
// over doubles, booleans and varchar ranks, :492 the bitwise folds of
// _seg_assoc :361, :498 bool_and/bool_or/every, :569 hll_merge).
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
//
// The function surface: a double's min/max runs as an int64 min/max
// of an order key (common.cuh minmax_key: -0.0 below 0.0, NaN moved
// to win, as the reference's segment reductions propagate it), turned
// back into the double at the end (an empty state: +inf or -inf); a
// boolean's min/max reads 0/1 and stores the fold's neutral value in
// an empty state; bool_and / bool_or / every add their true rows;
// bitwise_and_agg / bitwise_or_agg fold by 64-bit atomicAnd / atomicOr
// (the reference's _seg_assoc, an associative scan); hll_merge adds
// 2^-rho per row (exact, from the double's bits) in the fixed double
// order.  An aggregate's FILTER reaches the kernel as its argument's
// validity lane, which K1 computes.
//
// The wide decimals (_partial_states :434 over decimal(37..38), with
// decimal128.to_sum_limbs' identity and from_sum_limbs' _norm_wide;
// _minmax_long :1644 over five limbs): a wide sum adds the argument's
// five base-10^9 limbs as they are (each below 10^9 in size, so 2^23
// rows stay far inside int64) and normalises them at the end; a wide
// min/max reduces limb 0 in the first launch and limb p in launch p over
// the rows whose limbs before it tie the group's, five launches in all
// (the reference's phased walk fixes the answer, not the launches).
//
// The narrow types: a SMALLINT or TINYINT argument or key reads
// sign-extended, and its min/max stores back narrowed (an empty state:
// its own type's identity); a REAL argument widens exactly to a double,
// for a double sum in the fixed order or for its min/max order key, and
// a REAL min/max stores back as float32.
//
// The coupled and statistical aggregates (_partial_states :480
// moments, :518 checksum, :536 min_by/max_by): checksum adds K1's
// per-row splitmix64 hashes by a wrapping 64-bit atomicAdd (a NULL row
// already carries the reference's constant, a dead row adds nothing);
// the central moments (s, m2, m3, m4, cnt) take four fixed-order double
// passes, s, then the sums of dx*dx, dx*dx*dx and dx*dx*dx*dx with
// dx = x - s / max(cnt, 1), each in the reference's association;
// min_by / max_by come as two entries, BY_X and the BY_Y right after
// it: the first launch reduces y's order key (a double's minmax_key,
// else the integer or collation rank) with its count, a second launch
// takes, over the rows whose y equals the group's extreme (compared as
// values, so a NaN extreme ties nothing, as the reference's ==), the
// greatest x by its order key and counts them.

#include "common.cuh"

#define K2_MAX_KEYS 16
#define K2_MAX_AGGS 32
#define K2_MAX_SLOTS (1 + 6 * K2_MAX_AGGS)
#define K2_SHARED_LIMIT (48 * 1024)
#define K2_DSUM_CHUNK 256
#define K2_DOUBLE_SLOT_LIMIT 1
#define K2_OUTS 5

// aggregate kinds: keep in step with kernels/packed_group_agg.py
enum { AGG_COUNT_STAR = 0, AGG_COUNT = 1, AGG_SUM_SHORT = 2, AGG_SUM_LONG = 3,
       AGG_MIN_SHORT = 4, AGG_MAX_SHORT = 5, AGG_MIN_LONG = 6, AGG_MAX_LONG = 7,
       AGG_SUM_LONG_ARG = 8, AGG_SUM_DOUBLE = 9, AGG_VARIANCE = 10, AGG_MIN_DOUBLE = 11,
       AGG_MAX_DOUBLE = 12, AGG_BOOL_COUNT = 13, AGG_BIT_AND = 14, AGG_BIT_OR = 15,
       AGG_HLL_SUM = 16, AGG_CHECKSUM = 17, AGG_MOMENTS = 18, AGG_BY_Y_MIN = 19,
       AGG_BY_Y_MAX = 20, AGG_BY_X = 21, AGG_SUM_D38 = 22, AGG_MIN_D38 = 23, AGG_MAX_D38 = 24,
       AGG_LAST = AGG_MAX_D38 };
enum { KIND_BOOL = 0, KIND_I32 = 1, KIND_I64 = 2, KIND_D128 = 3, KIND_F64 = 4, KIND_I16 = 5,
       KIND_I8 = 6, KIND_F32 = 7, KIND_D38 = 8 };

// the states that add doubles in the fixed order (their slot counts)
__host__ __device__ __forceinline__ bool is_double_agg(int kind) {
  return kind == AGG_SUM_DOUBLE || kind == AGG_VARIANCE || kind == AGG_HLL_SUM ||
         kind == AGG_MOMENTS;
}

__host__ __device__ __forceinline__ bool is_by_y(int kind) {
  return kind == AGG_BY_Y_MIN || kind == AGG_BY_Y_MAX;
}

__host__ __device__ __forceinline__ int agg_width(int kind) {
  switch (kind) {
    case AGG_SUM_D38: case AGG_MIN_D38: case AGG_MAX_D38: return 6;
    case AGG_SUM_LONG: case AGG_SUM_LONG_ARG: return 5;
    case AGG_MIN_LONG: case AGG_MAX_LONG: return 3;
    case AGG_SUM_SHORT: case AGG_MIN_SHORT: case AGG_MAX_SHORT: case AGG_MIN_DOUBLE:
    case AGG_MAX_DOUBLE: case AGG_BOOL_COUNT: case AGG_BIT_AND: case AGG_BIT_OR:
    case AGG_BY_Y_MIN: case AGG_BY_Y_MAX: case AGG_BY_X: return 2;
    default: return 1;
  }
}

__host__ __device__ __forceinline__ bool is_long_extreme(int kind) {
  return kind == AGG_MIN_LONG || kind == AGG_MAX_LONG;
}

__host__ __device__ __forceinline__ bool is_d38_extreme(int kind) {
  return kind == AGG_MIN_D38 || kind == AGG_MAX_D38;
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
  // out[0]: count, or sum ((G,) or (G, 2) limbs, or doubles), or a
  // value; out[1]: count of a sum or a min/max, m2; out[2]: count of a
  // variance, m3; out[3]: m4; out[4]: count of the moments
  i64* out[K2_OUTS][K2_MAX_AGGS];
  int raw_width;           // raw slots per group; slot 0 counts live rows
  uint8_t slot_kind[K2_MAX_SLOTS];  // SLOT_ADD, SLOT_MIN, SLOT_MAX, SLOT_AND or SLOT_OR
};

__device__ __forceinline__ i64 load_int(const void* p, int kind, i64 i) {
  if (kind == KIND_I64) return ((const i64*)p)[i];
  if (kind == KIND_I32) return ((const int*)p)[i];
  if (kind == KIND_I16) return ((const short*)p)[i];
  if (kind == KIND_I8) return ((const signed char*)p)[i];
  return ((const uint8_t*)p)[i] != 0;
}

// a double argument's bits, a REAL's widened exactly
__device__ __forceinline__ i64 load_bits(const void* p, int kind, i64 i) {
  return kind == KIND_F32 ? f32_bits(p, i) : ((const i64*)p)[i];
}

// min_by / max_by: the order key of a y (is_min: min_by's) or an x
// (the max side), a double's minmax_key, an integer as it is
__device__ __forceinline__ i64 by_key(const void* p, int kind, i64 i, bool is_min) {
  if (kind == KIND_F64) return minmax_key(((const i64*)p)[i], is_min);
  return load_int(p, kind, i);
}

// whether y at row i equals the reduced key (compared as values)
__device__ __forceinline__ bool by_tie(const void* p, int kind, i64 i, i64 key, bool is_min) {
  if (kind == KIND_F64)
    return __longlong_as_double(((const i64*)p)[i]) ==
           __longlong_as_double(minmax_value(key, is_min));
  return load_int(p, kind, i) == key;
}

// a reduced key back in the state's storage (an empty state: the identity)
__device__ __forceinline__ void by_store(i64* out, int kind, i64 g, i64 key, bool is_min) {
  if (kind == KIND_F64) out[g] = minmax_value(key, is_min);
  else if (kind == KIND_I32) ((int*)out)[g] = narrow_extreme(key);
  else if (kind == KIND_BOOL) ((uint8_t*)out)[g] = key == I64_MIN ? 0 : key != 0;
  else out[g] = key;
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

// phase 0: every state but the lower limbs of a long or wide min/max;
// phase p >= 1 (tab is the device table): limb p, over the rows whose
// limbs before it equal the group's reduced ones (a long min/max and
// min_by / max_by's x take phase 1 only)
__device__ __forceinline__ void accumulate_row(const K2Desc& d, i64 i, i64 n_groups,
                                               u64* tab, int phase) {
  const i64 key = row_key(d, i);
  if (key < 0 || key >= n_groups) return;  // out-of-domain ids are dropped
  u64* base = tab + key * d.raw_width;
  if (phase > 0) {
    for (int a = 0; a < d.n_aggs; ++a) {
      const int kind = d.agg_kind[a];
      if (is_d38_extreme(kind)) {
        if (!d.arg_valid[a][i]) continue;
        const i64* x = (const i64*)d.arg_data[a] + D38_LIMBS * i;
        u64* s = base + d.agg_slot[a];
        bool tie = true;
        for (int j = 0; j < phase; ++j) tie = tie && x[j] == (i64)s[j];
        if (tie) slot_combine(s + phase, x[phase], kind == AGG_MIN_D38 ? SLOT_MIN : SLOT_MAX);
        continue;
      }
      if (phase != 1) continue;
      if (kind == AGG_BY_X) {  // x over the rows tied at the y extreme (entry a + 1)
        const int y = a + 1;
        const bool y_min = d.agg_kind[y] == AGG_BY_Y_MIN;
        if (!d.arg_valid[a][i] || !d.arg_valid[y][i]) continue;
        if (!by_tie(d.arg_data[y], d.arg_kind[y], i, (i64)base[d.agg_slot[y]], y_min)) continue;
        u64* s = base + d.agg_slot[a];
        slot_combine(s, by_key(d.arg_data[a], d.arg_kind[a], i, false), SLOT_MAX);
        atomicAdd(s + 1, 1ull);
        continue;
      }
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
    if (kind == AGG_BY_X || !d.arg_valid[a][i]) continue;  // BY_X: phase 1
    if (kind == AGG_CHECKSUM) {  // a wrapping sum of the hashes
      add_slot(s, ((const i64*)d.arg_data[a])[i]);
      continue;
    }
    if (is_by_y(kind)) {
      const bool is_min = kind == AGG_BY_Y_MIN;
      slot_combine(s, by_key(d.arg_data[a], d.arg_kind[a], i, is_min),
                   is_min ? SLOT_MIN : SLOT_MAX);
      atomicAdd(s + 1, 1ull);
      continue;
    }
    if (kind == AGG_COUNT || is_double_agg(kind)) { atomicAdd(s, 1ull); continue; }
    if (is_d38_extreme(kind)) {  // limb 0; the later phases take the others
      slot_combine(s, ((const i64*)d.arg_data[a])[D38_LIMBS * i],
                   kind == AGG_MIN_D38 ? SLOT_MIN : SLOT_MAX);
      atomicAdd(s + D38_LIMBS, 1ull);
      continue;
    }
    if (kind == AGG_SUM_D38) {  // a wide argument's limbs add as they are
      const i64* x = (const i64*)d.arg_data[a] + D38_LIMBS * i;
      for (int j = 0; j < D38_LIMBS; ++j) add_slot(s + j, x[j]);
      atomicAdd(s + D38_LIMBS, 1ull);
      continue;
    }
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
    if (kind == AGG_MIN_DOUBLE || kind == AGG_MAX_DOUBLE) {  // by the order key
      const bool is_min = kind == AGG_MIN_DOUBLE;
      slot_combine(s, minmax_key(load_bits(d.arg_data[a], d.arg_kind[a], i), is_min),
                   is_min ? SLOT_MIN : SLOT_MAX);
      atomicAdd(s + 1, 1ull);
      continue;
    }
    const i64 x = load_int(d.arg_data[a], d.arg_kind[a], i);
    if (kind == AGG_BOOL_COUNT || kind == AGG_BIT_AND || kind == AGG_BIT_OR) {
      if (kind == AGG_BOOL_COUNT) add_slot(s, x != 0);
      else slot_combine(s, x, kind == AGG_BIT_AND ? SLOT_AND : SLOT_OR);
      atomicAdd(s + 1, 1ull);
      continue;
    }
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
      case AGG_COUNT_STAR: case AGG_COUNT: case AGG_CHECKSUM: d.out[0][a][g] = s[0]; break;
      case AGG_SUM_DOUBLE: case AGG_HLL_SUM: d.out[1][a][g] = s[0]; break;  // sums later
      case AGG_MOMENTS: d.out[4][a][g] = s[0]; break;
      case AGG_BY_Y_MIN: case AGG_BY_Y_MAX:
        by_store(d.out[0][a], d.arg_kind[a], g, s[0], d.agg_kind[a] == AGG_BY_Y_MIN);
        d.out[1][a][g] = s[1];
        break;
      case AGG_BY_X:
        by_store(d.out[0][a], d.arg_kind[a], g, s[0], false);
        d.out[1][a][g] = s[1] > 0;
        break;
      case AGG_MIN_DOUBLE: case AGG_MAX_DOUBLE: {
        const i64 x = minmax_value(s[0], d.agg_kind[a] == AGG_MIN_DOUBLE);
        if (d.arg_kind[a] == KIND_F32) ((float*)d.out[0][a])[g] = bits_f32(x);
        else d.out[0][a][g] = x;
        d.out[1][a][g] = s[1];
        break;
      }
      case AGG_BOOL_COUNT: case AGG_BIT_AND: case AGG_BIT_OR:
        d.out[0][a][g] = s[0];
        d.out[1][a][g] = s[1];
        break;
      case AGG_VARIANCE: d.out[2][a][g] = s[0]; break;
      case AGG_SUM_SHORT: d.out[0][a][g] = s[0]; d.out[1][a][g] = s[1]; break;
      case AGG_MIN_SHORT: case AGG_MAX_SHORT:
        if (d.arg_kind[a] == KIND_I32) ((int*)d.out[0][a])[g] = narrow_extreme(s[0]);
        else if (d.arg_kind[a] == KIND_I16)
          ((short*)d.out[0][a])[g] = (short)narrow_extreme_bits(s[0], 16);
        else if (d.arg_kind[a] == KIND_I8)
          ((signed char*)d.out[0][a])[g] = (signed char)narrow_extreme_bits(s[0], 8);
        else if (d.arg_kind[a] == KIND_BOOL)  // an empty state: the fold's neutral value
          ((uint8_t*)d.out[0][a])[g] = s[0] == I64_MIN ? 0 : s[0] != 0;
        else d.out[0][a][g] = s[0];
        d.out[1][a][g] = s[1];
        break;
      case AGG_MIN_LONG: case AGG_MAX_LONG:
        d.out[0][a][2 * g] = s[0];
        d.out[0][a][2 * g + 1] = s[1];
        d.out[1][a][g] = s[2];
        break;
      case AGG_SUM_D38: case AGG_MIN_D38: case AGG_MAX_D38: {
        i64 w[D38_LIMBS];
        for (int j = 0; j < D38_LIMBS; ++j) w[j] = s[j];
        if (d.agg_kind[a] == AGG_SUM_D38) w_norm(w);  // from_sum_limbs: _norm_wide
        for (int j = 0; j < D38_LIMBS; ++j) d.out[0][a][D38_LIMBS * g + j] = w[j];
        d.out[1][a][g] = s[D38_LIMBS];
        break;
      }
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
        d.out[0][a][2 * g] = hi;
        d.out[0][a][2 * g + 1] = lo;
        d.out[1][a][g] = s[4];
      }
    }
  }
}

// One block per chunk of K2_DSUM_CHUNK rows: the chunk's partial sum
// per slot, each slot's rows in row order from 0.0.  pass 0 adds x;
// with dx = x - mu[slot], pass 1 adds dx*dx (variance's second pass),
// pass 2 (dx*dx)*dx and pass 3 (dx*dx)*(dx*dx) (the central moments).
__global__ void k2_dsum_chunks(const K2Desc d, int a, i64 n,
                               const uint8_t* __restrict__ row_mask, i64 n_groups,
                               const double* __restrict__ mu, int pass,
                               double* __restrict__ part) {
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
        x = d.agg_kind[a] == AGG_HLL_SUM
            ? hll_weight(load_int(d.arg_data[a], d.arg_kind[a], i))
            : __longlong_as_double(load_bits(d.arg_data[a], d.arg_kind[a], i));
        if (pass > 0) {
          const double dx = __dsub_rn(x, mu[g]);
          const double dx2 = __dmul_rn(dx, dx);
          x = pass == 1 ? dx2 : pass == 2 ? __dmul_rn(dx2, dx) : __dmul_rn(dx2, dx2);
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

// The fixed-order per-slot sum of aggregate a (mu, pass: see
// k2_dsum_chunks) into out; scratch holds chunks * n_groups + (chunks
// + 1) / 2 * n_groups doubles.
static void k2_double_pass(const K2Desc& d, int a, i64 n, const uint8_t* row_mask,
                           i64 n_groups, const double* mu, int pass, double* scratch,
                           double* out, const i64* cnt, double* mu_out, cudaStream_t s) {
  i64 rows = n > 0 ? (n + K2_DSUM_CHUNK - 1) / K2_DSUM_CHUNK : 1;
  double* a_buf = scratch;
  double* b_buf = scratch + rows * n_groups;
  if (n > 0)
    k2_dsum_chunks<<<(unsigned)rows, 128, 0, s>>>(d, a, n, row_mask, n_groups, mu, pass,
                                                   a_buf);
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

// raw: int64 scratch of n_groups * raw_width.  out0..out4: the output
// columns per aggregate (out1 only for sums, min/max and the coupled
// states; out0 of a min/max or a coupled state has the argument's
// storage; out2..out4 for the variance and the moments).  present: (G,)
// bool.  Returns cudaGetLastError() after the launches.
extern "C" int k2_packed_group_agg(i64 n, const void* row_mask,
                                   int n_keys, const i64* key_data, const i64* key_valid,
                                   const int* key_kind, const i64* key_lo, const i64* key_card,
                                   int n_aggs, const int* agg_kind, const i64* arg_data,
                                   const i64* arg_valid, const int* arg_kind,
                                   i64 n_groups, int raw_width, void* raw,
                                   const i64* out0, const i64* out1, const i64* out2,
                                   const i64* out3, const i64* out4,
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
  int phases = 1;  // accumulate launches: 2 for a long min/max or min_by, 5 for a wide min/max
  d.slot_kind[0] = SLOT_ADD;
  for (int a = 0; a < n_aggs; ++a) {
    const int kind = agg_kind[a];
    if (kind < AGG_COUNT_STAR || kind > AGG_LAST) return (int)cudaErrorInvalidValue;
    // a BY_Y entry follows its BY_X
    if (kind == AGG_BY_X && !(a + 1 < n_aggs && is_by_y(agg_kind[a + 1])))
      return (int)cudaErrorInvalidValue;
    if (is_by_y(kind) && (a == 0 || agg_kind[a - 1] != AGG_BY_X)) return (int)cudaErrorInvalidValue;
    if (is_double_agg(kind) && n_groups > K2_DOUBLE_SLOT_LIMIT)
      return (int)cudaErrorInvalidValue;
    d.agg_kind[a] = kind;
    d.agg_slot[a] = slot;
    for (int j = 0; j < agg_width(kind); ++j) d.slot_kind[slot + j] = SLOT_ADD;
    if (kind == AGG_MIN_SHORT || kind == AGG_MIN_LONG || kind == AGG_MIN_DOUBLE)
      d.slot_kind[slot] = SLOT_MIN;
    if (kind == AGG_MAX_SHORT || kind == AGG_MAX_LONG || kind == AGG_MAX_DOUBLE ||
        kind == AGG_BY_Y_MAX || kind == AGG_BY_X)
      d.slot_kind[slot] = SLOT_MAX;
    if (is_d38_extreme(kind))
      for (int j = 0; j < D38_LIMBS; ++j)
        d.slot_kind[slot + j] = kind == AGG_MIN_D38 ? SLOT_MIN : SLOT_MAX;
    if (kind == AGG_BY_Y_MIN) d.slot_kind[slot] = SLOT_MIN;
    if (kind == AGG_BIT_AND) d.slot_kind[slot] = SLOT_AND;
    if (kind == AGG_BIT_OR) d.slot_kind[slot] = SLOT_OR;
    if (is_long_extreme(kind)) d.slot_kind[slot + 1] = d.slot_kind[slot];
    if ((is_long_extreme(kind) || kind == AGG_BY_X) && phases < 2) phases = 2;
    if (is_d38_extreme(kind)) phases = D38_LIMBS;
    slot += agg_width(kind);
    d.arg_data[a] = (const void*)arg_data[a];
    d.arg_valid[a] = (const uint8_t*)arg_valid[a];
    d.arg_kind[a] = arg_kind[a];
    d.out[0][a] = (i64*)out0[a];
    d.out[1][a] = (i64*)out1[a];
    d.out[2][a] = (i64*)out2[a];
    d.out[3][a] = (i64*)out3[a];
    d.out[4][a] = (i64*)out4[a];
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
    for (int phase = 1; phase < phases; ++phase)
      k2_accumulate<<<grid_for(n, threads, 4), threads, 0, s>>>(
          d, n, (const uint8_t*)row_mask, n_groups, (u64*)raw, 0, phase);
    const int err = (int)cudaGetLastError();
    if (err != 0) return err;
  }
  k2_finish<<<(int)((n_groups + threads - 1) / threads), threads, 0, s>>>(
      d, n_groups, (const i64*)raw, (uint8_t*)present);
  for (int a = 0; a < n_aggs; ++a) {
    if (!is_double_agg(d.agg_kind[a])) continue;
    const bool var = d.agg_kind[a] == AGG_VARIANCE, mom = d.agg_kind[a] == AGG_MOMENTS;
    double* sum = (double*)d.out[0][a];
    // mu lives in the last pass's output until that pass ends
    double* mu = (double*)d.out[var ? 1 : 3][a];
    const i64* cnt = var ? d.out[2][a] : mom ? d.out[4][a] : nullptr;
    k2_double_pass(d, a, n, (const uint8_t*)row_mask, n_groups, nullptr, 0, (double*)scratch,
                   sum, cnt, cnt ? mu : nullptr, s);
    for (int pass = 1; pass <= (var ? 1 : mom ? 3 : 0); ++pass)
      k2_double_pass(d, a, n, (const uint8_t*)row_mask, n_groups, mu, pass, (double*)scratch,
                     (double*)d.out[pass][a], nullptr, nullptr, s);
  }
  return (int)cudaGetLastError();
}

// The raw varchar extremes (the reference's _minmax_lanes :1627 over
// ops/rawstring.py pack_lanes' k int64 lanes, for _partial_states :410):
// the same phased walk as a wide decimal's limbs, k launches: launch p
// reduces lane p by a 64-bit atomicMin / atomicMax over the valid live
// rows whose lanes before p equal the group's reduced ones.  Strings
// that share a prefix tie on their first lanes (every TPC-H c_name
// begins "Customer"), so every row reaches the later launches and the
// atomics of a few groups serialise; that is this design's cost.
static __global__ void k2_lanes_init(i64* best, i64 total, i64 identity) {
  const i64 stride = (i64)gridDim.x * blockDim.x;
  for (i64 i = (i64)blockIdx.x * blockDim.x + threadIdx.x; i < total; i += stride)
    best[i] = identity;
}

static __global__ void k2_lanes_phase(K2Desc d, i64 n, const uint8_t* __restrict__ row_mask,
                                      const i64* __restrict__ lanes, int k,
                                      const uint8_t* __restrict__ valid, int is_min,
                                      i64 n_groups, i64* best, int phase) {
  const i64 stride = (i64)gridDim.x * blockDim.x;
  for (i64 i = (i64)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride) {
    if (!row_mask[i] || !valid[i]) continue;
    const i64 key = row_key(d, i);
    if (key < 0 || key >= n_groups) continue;
    const i64* x = lanes + (i64)k * i;
    i64* b = best + (i64)k * key;
    bool tie = true;
    for (int j = 0; j < phase && tie; ++j) tie = x[j] == b[j];
    if (tie) slot_combine((u64*)(b + phase), x[phase], is_min ? SLOT_MIN : SLOT_MAX);
  }
}

// out: (n_groups, k) int64, the least (is_min) or greatest lanes of
// each group's valid live rows; an empty group keeps the identity in
// every lane (I64_MAX for min, I64_MIN for max), as the reference's.
extern "C" int k2_lane_extremes(i64 n, const void* row_mask, int n_keys, const i64* key_data,
                                const i64* key_valid, const int* key_kind, const i64* key_lo,
                                const i64* key_card, const void* lanes, int k,
                                const void* valid, int is_min, i64 n_groups, void* out,
                                void* stream) {
  if (n_keys > K2_MAX_KEYS || n_groups < 1 || k < 1) return (int)cudaErrorInvalidValue;
  K2Desc d;
  d.n_keys = n_keys;
  for (int c = 0; c < n_keys; ++c) {
    d.key_data[c] = (const void*)key_data[c];
    d.key_valid[c] = (const uint8_t*)key_valid[c];
    d.key_kind[c] = key_kind[c];
    d.key_lo[c] = key_lo[c];
    d.key_card[c] = key_card[c];
  }
  d.n_aggs = 0;
  cudaStream_t s = (cudaStream_t)stream;
  const int threads = 256;
  k2_lanes_init<<<grid_for(n_groups * k, threads, 4), threads, 0, s>>>(
      (i64*)out, n_groups * k, is_min ? I64_MAX : I64_MIN);
  if (n > 0)
    for (int phase = 0; phase < k; ++phase)
      k2_lanes_phase<<<grid_for(n, threads, 4), threads, 0, s>>>(
          d, n, (const uint8_t*)row_mask, (const i64*)lanes, k, (const uint8_t*)valid, is_min,
          n_groups, (i64*)out, phase);
  return (int)cudaGetLastError();
}
