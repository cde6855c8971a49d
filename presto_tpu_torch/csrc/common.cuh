// Shared helpers of the presto_tpu_torch kernels.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

typedef long long i64;
typedef unsigned long long u64;

// Two's-complement wrapping arithmetic (signed overflow is undefined
// in C++, so it runs in unsigned and reinterprets).
__device__ __forceinline__ i64 wadd(i64 a, i64 b) { return (i64)((u64)a + (u64)b); }
__device__ __forceinline__ i64 wsub(i64 a, i64 b) { return (i64)((u64)a - (u64)b); }
__device__ __forceinline__ i64 wmul(i64 a, i64 b) { return (i64)((u64)a * (u64)b); }
__device__ __forceinline__ i64 wneg(i64 a) { return (i64)(0ull - (u64)a); }

// Floor division and the matching non-negative remainder (b > 0), as
// jnp.floor_divide / jnp.remainder compute them.
__device__ __forceinline__ i64 fdiv(i64 a, i64 b) {
  i64 q = a / b;
  if ((a % b != 0) && ((a < 0) != (b < 0))) --q;
  return q;
}
__device__ __forceinline__ i64 fmod_(i64 a, i64 b) { return a - fdiv(a, b) * b; }

#define I64_MAX 0x7fffffffffffffffLL
#define I64_MIN (-I64_MAX - 1)
#define B18 1000000000000000000LL
#define B9 1000000000LL

// How a raw accumulator slot combines values: summed (from 0), the
// least or greatest value (from the int64 extreme that no value
// passes), or the bitwise and / or (from all ones / zero), by 64-bit
// atomics in shared or device memory.
enum { SLOT_ADD = 0, SLOT_MIN = 1, SLOT_MAX = 2, SLOT_AND = 3, SLOT_OR = 4 };

__device__ __forceinline__ i64 slot_identity(int kind) {
  return kind == SLOT_MIN ? I64_MAX : kind == SLOT_MAX ? I64_MIN : kind == SLOT_AND ? -1 : 0;
}

__device__ __forceinline__ void slot_combine(u64* p, i64 v, int kind) {
  if (kind == SLOT_MIN) atomicMin((long long*)p, (long long)v);
  else if (kind == SLOT_MAX) atomicMax((long long*)p, (long long)v);
  else if (kind == SLOT_AND) atomicAnd((unsigned long long*)p, (unsigned long long)v);
  else if (kind == SLOT_OR) atomicOr((unsigned long long*)p, (unsigned long long)v);
  else if (v != 0) atomicAdd(p, (u64)v);  // adding zero changes nothing
}

// The same combine, local to a thread.
__device__ __forceinline__ i64 slot_fold(i64 acc, i64 v, int kind) {
  switch (kind) {
    case SLOT_MIN: return v < acc ? v : acc;
    case SLOT_MAX: return v > acc ? v : acc;
    case SLOT_AND: return acc & v;
    case SLOT_OR: return acc | v;
    default: return wadd(acc, v);
  }
}

// Double min/max as int64 min/max: an order key that ranks the
// doubles as the reference's segment_min/segment_max do (-0.0 below
// 0.0), NaN moved past every number on the side where it wins (both
// propagate NaN), and back.  The key is its own inverse.
#define CANONICAL_NAN 0x7ff8000000000000LL
__device__ __forceinline__ i64 double_order_key(i64 bits) {
  return bits ^ ((bits >> 63) & I64_MAX);
}
__device__ __forceinline__ i64 minmax_key(i64 bits, bool is_min) {
  const double x = __longlong_as_double(bits);
  if (isnan(x)) return double_order_key(is_min ? (CANONICAL_NAN | I64_MIN) : CANONICAL_NAN);
  return double_order_key(bits);
}
// a key back to a double's bits: an empty state (the slot identity)
// gives +inf (min) or -inf (max), as an empty segment does
__device__ __forceinline__ i64 minmax_value(i64 key, bool is_min) {
  if (key == (is_min ? I64_MAX : I64_MIN))
    return is_min ? 0x7ff0000000000000LL : (i64)0xfff0000000000000ULL;
  const i64 bits = double_order_key(key);
  return isnan(__longlong_as_double(bits)) ? CANONICAL_NAN : bits;
}

// HLL's per-row weight 2^-rho (rho in 1..64), exact: the double's bits
__device__ __forceinline__ double hll_weight(i64 rho) {
  return __longlong_as_double((1023 - rho) << 52);
}

// One partial's terms of a merged central-moment state (s, m2, m3, m4,
// c): its moments shifted by d = mu_i - mu, mu_i = s / max(c, 1) (d = 0
// for an empty partial), in the reference's association
// (kernels/packed_group_agg.py moment_terms).  K6's merge sums them per
// group; K3's fold adds the two sides'.
__device__ __forceinline__ void moment_terms(double s, double m2, double m3, double m4, i64 c,
                                             double mu, double* t) {
  const double cf = __ll2double_rn(c);
  const double dd = c > 0 ? __dsub_rn(__ddiv_rn(s, cf > 1.0 ? cf : 1.0), mu) : 0.0;
  const double d2 = __dmul_rn(dd, dd), cd2 = __dmul_rn(cf, d2);
  t[0] = __dadd_rn(m2, cd2);
  t[1] = __dadd_rn(__dadd_rn(m3, __dmul_rn(__dmul_rn(3.0, m2), dd)), __dmul_rn(cd2, dd));
  t[2] = __dadd_rn(__dadd_rn(__dadd_rn(m4, __dmul_rn(__dmul_rn(4.0, m3), dd)),
                             __dmul_rn(__dmul_rn(6.0, m2), d2)),
                   __dmul_rn(cd2, d2));
}

// An int64 extreme stored into an int32 state: the int32 identity.
__device__ __forceinline__ int narrow_extreme(i64 v) {
  return v == I64_MAX ? 0x7fffffff : v == I64_MIN ? (int)0x80000000 : (int)v;
}

// An int64 extreme stored into an int16 (bits 16) or int8 (bits 8)
// state: that type's identity for an empty one.
__device__ __forceinline__ i64 narrow_extreme_bits(i64 v, int bits) {
  const i64 hi = (1LL << (bits - 1)) - 1;
  return v == I64_MAX ? hi : v == I64_MIN ? -hi - 1 : v;
}

// A REAL (float32) read as the bits of its exact double, and a double's
// bits stored back as a float32 (exact for a value that came from one;
// an empty min/max state's infinities stay infinities)
__device__ __forceinline__ i64 f32_bits(const void* p, i64 i) {
  return __double_as_longlong((double)((const float*)p)[i]);
}
__device__ __forceinline__ float bits_f32(i64 bits) {
  return __double2float_rn(__longlong_as_double(bits));
}

// The wide decimal (ops/decimal128.py, decimal(37..38)): five base-10^9
// limbs w[0..4], most significant first; limbs 1-4 in [0, 10^9), limb 0
// signed.  Every step wraps as the twin's int64 tensors do.
#define D38_LIMBS 5

// decimal128._norm_wide: floor-division carries from limb 4 up
__device__ __forceinline__ void w_norm(i64* w) {
  i64 carry = 0;
  for (int i = D38_LIMBS - 1; i > 0; --i) {
    const i64 cur = wadd(w[i], carry);
    carry = fdiv(cur, B9);
    w[i] = wsub(cur, wmul(carry, B9));
  }
  w[0] = wadd(w[0], carry);
}

// decimal128.neg
__device__ __forceinline__ void w_neg(i64* w) {
  for (int i = 0; i < D38_LIMBS; ++i) w[i] = wneg(w[i]);
  w_norm(w);
}

// -1, 0 or 1: canonical limbs order as their values do
__device__ __forceinline__ int w_cmp(const i64* a, const i64* b) {
  for (int i = 0; i < D38_LIMBS; ++i)
    if (a[i] != b[i]) return a[i] < b[i] ? -1 : 1;
  return 0;
}

// Grid size for a grid-stride loop over n items: enough blocks to
// fill every SM several times, never more than the items need.
static inline int grid_for(i64 n, int threads, int per_sm) {
  int dev = 0, sms = 132;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  i64 need = (n + threads - 1) / threads;
  i64 cap = (i64)sms * per_sm;
  i64 g = need < cap ? need : cap;
  return g < 1 ? 1 : (int)g;
}
