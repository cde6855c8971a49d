// K3 packed_fold_finalize: slot-by-slot fold of two packed partial
// state tables, and the finalize of a folded table.
//
// Replaces: presto_tpu/ops/aggregate.py combine_packed_states,
// finalize_packed, and the parts of _finalize and _avg_decimal128
// that count/sum/avg/min/max take (ops/decimal128.py add/normalize for
// the limb states); the function surface's fold (combine_packed_states
// :896-:900 for the bitwise folds, min/max over doubles and booleans)
// and finalize (_finalize :1427 min/max, :1473 bool_and/bool_or/every,
// :1500 the bitwise folds, :1562 the HLL estimate).
//
// Bound on the H100: launch latency.  A packed table has one slot per
// group (TPC-H Q1: 12, Q6: 1); the bytes are a few hundred and the
// work a few integer operations per slot, so the kernel's time is the
// cost of one launch.  Its time is recorded, not tuned.
//
// Design: one thread per group slot walks the table's columns.  The
// fold adds counts and int64 sums with two's-complement wrap (as the
// reference's int64 lanes do) and limb sums with a carry
// normalisation; a min/max state takes the lesser or greater of the two
// slots (a long decimal limb by limb, high limb first; an empty slot
// holds the identity, so it never wins).  A min/max finalizes as its
// state value, NULL where its count is 0.  The finalize computes avg with HALF_UP rounding: a
// short decimal in int64 exactly as the reference's overflow-free
// form; a limb decimal through one exact __int128 division, which
// equals the reference's base-10^6 long division; an integer's avg as
// a double, float64(sum) / float64(count) by __ddiv_rn, so it rounds as
// the plain twin's division of two tensors.  Empty groups and
// zero counts come out NULL.  sum0 (the outer half of the
// mixed-DISTINCT rewrite) is never NULL; a long sum collapsed to a
// short decimal is hi * 10^18 + lo in wrapping int64.  Double sums fold
// by __dadd_rn; a variance state's m2 folds by Chan's pairwise update
// (its s and count are the columns either side of it), and finalizes
// as pop = max(m2 / n, 0), a sample's pop * n / max(n - 1, 1) valid
// where n > 1, and sqrt for stddev, each an _rn intrinsic in the
// reference's order.  Written in CUDA rather than Triton for
// __int128 and to keep one build.
//
// The function surface: a double min/max folds by its order key
// (common.cuh: -0.0 below 0.0, NaN winning), a boolean's by and / or,
// bitwise_and_agg / bitwise_or_agg by & / |, bool_and / bool_or and
// hll_merge's counts and sums add; finalize gives a boolean min/max as
// it is, bool_and as (trues == count) and bool_or as (trues > 0), NULL
// without a row, and hll_merge's estimate (never NULL).
//
// The coupled and statistical aggregates: the reference's
// combine_packed_states has no branch for them (they fall into its
// variance form, which cannot unpack their states), so the fold here is
// the port's own: the central moments by the merge's shift form
// (common.cuh moment_terms, as K6's S_MOM_MERGE), min_by / max_by
// by the extreme of the y that have rows and the greatest x (by its
// order key) among the sides whose y equals it with a valid x, checksum
// and the covariance sums by adding.  Finalize (_finalize :1447
// covariance, :1470 checksum, :1480 moments): skewness sqrt(n) M3 /
// M2^1.5 (pow, libdevice's) and the unbiased excess kurtosis, the
// covariance family from its five sums, each an _rn intrinsic in the
// reference's order, maxima that keep NaN as jnp.maximum does; their
// inputs come stacked, (G, 3) and (G, 5).
//
// The wide decimals (combine_packed_states' d128.add over five limbs;
// _finalize :1397 with _avg_decimal128 :1580's wide branch): a wide sum
// folds by limb sums and _norm_wide, a wide min/max by comparing limb 0
// first; a wide sum or min/max finalizes as it is, NULL where its count
// is 0, and a wide avg by long division of the magnitude over the
// base-10^9 limbs, HALF_UP, in int64 steps (the reference's algorithm,
// no __int128: a 38-digit sum does not fit the two-limb avg's path).
//
// The narrow types: a SMALLINT or TINYINT min/max folds as an int64
// min/max read and stored back in its storage, a REAL one by the double
// order key of its exact double, stored back as float32 (elem: the
// column's storage); FIN_VALUE finalizes such a state's value in its
// storage.  An interval sum or avg is an int64 sum (FIN_SUM,
// FIN_AVG_SHORT); a REAL sum or avg is a double one.

#include "common.cuh"

#define K3_MAX_ITEMS 64

enum { MODE_FOLD = 0, MODE_FINALIZE = 1 };
// fold column kinds: keep in step with kernels/packed_fold_finalize.py
enum { COL_I64 = 0, COL_D128 = 1, COL_MIN_I64 = 2, COL_MAX_I64 = 3, COL_MIN_I32 = 4,
       COL_MAX_I32 = 5, COL_MIN_D128 = 6, COL_MAX_D128 = 7, COL_F64 = 8, COL_VAR_M2 = 9,
       COL_MIN_F64 = 10, COL_MAX_F64 = 11, COL_MIN_BOOL = 12, COL_MAX_BOOL = 13,
       COL_BAND = 14, COL_BOR = 15, COL_MOM_M2 = 16, COL_MOM_M3 = 17, COL_MOM_M4 = 18,
       COL_BY_X = 19, COL_BY_XV = 20, COL_BY_Y_MIN = 21, COL_BY_Y_MAX = 22, COL_D38 = 23,
       COL_MIN_D38 = 24, COL_MAX_D38 = 25, COL_LAST = COL_MAX_D38 };
// a column's storage (kernels/packed_fold_finalize.py _ELEM)
enum { ELEM_I64 = 0, ELEM_I32 = 1, ELEM_F64 = 2, ELEM_BOOL = 3, ELEM_I16 = 4, ELEM_I8 = 5,
       ELEM_F32 = 6 };
// finalize kinds
enum { FIN_COUNT = 0, FIN_SUM = 1, FIN_SUM_D128 = 2, FIN_AVG_SHORT = 3,
       FIN_AVG_D128 = 4, FIN_AVG_D128_NARROW = 5, FIN_VALUE_I32 = 6, FIN_AVG_DOUBLE = 7,
       FIN_SUM0 = 8, FIN_SUM0_D128 = 9, FIN_SUM_COLLAPSE = 10, FIN_SUM0_COLLAPSE = 11,
       FIN_SUM_F64 = 12, FIN_AVG_F64 = 13, FIN_VAR_POP = 14, FIN_VAR_SAMP = 15,
       FIN_STDDEV_POP = 16, FIN_STDDEV_SAMP = 17, FIN_VALUE_BOOL = 18, FIN_BOOL_AND = 19,
       FIN_BOOL_OR = 20, FIN_HLL = 21, FIN_SKEWNESS = 22, FIN_KURTOSIS = 23,
       FIN_COVAR_POP = 24, FIN_COVAR_SAMP = 25, FIN_CORR = 26, FIN_REGR_SLOPE = 27,
       FIN_REGR_INTERCEPT = 28, FIN_VALUE = 29, FIN_SUM_D38 = 30, FIN_AVG_D38 = 31,
       FIN_LAST = FIN_AVG_D38 };

// a min/max state's value in its storage: an int64 lane (int64, int16,
// int8) or a double's bits (a REAL's widened exactly), and back
__device__ __forceinline__ i64 elem_load(const i64* p, int elem, i64 g) {
  if (elem == ELEM_I16) return ((const short*)p)[g];
  if (elem == ELEM_I8) return ((const signed char*)p)[g];
  if (elem == ELEM_F32) return f32_bits(p, g);
  return p[g];
}
__device__ __forceinline__ void elem_store(i64* p, int elem, i64 g, i64 v) {
  if (elem == ELEM_I16) ((short*)p)[g] = (short)v;
  else if (elem == ELEM_I8) ((signed char*)p)[g] = (signed char)v;
  else if (elem == ELEM_F32) ((float*)p)[g] = bits_f32(v);
  else p[g] = v;
}

// The HLL estimator of hll_merge (the reference's _finalize, m = 4096
// buckets): linear counting below 2.5 m while a bucket is empty, else
// the raw estimate; rounded half to even (jnp.round).
#define K3_HLL_M 4096.0
__device__ __forceinline__ i64 hll_estimate(double s, i64 present) {
  const double m = K3_HLL_M;
  const double alpha = 0.7213 / (1.0 + 1.079 / K3_HLL_M);
  const double zeros = __dsub_rn(m, __ll2double_rn(present));
  const double s_full = __dadd_rn(s, zeros);
  const double raw = __ddiv_rn(__dmul_rn(__dmul_rn(alpha, m), m), s_full > 1e-12 ? s_full : 1e-12);
  const double lc = __dmul_rn(m, log(__ddiv_rn(m, zeros > 1.0 ? zeros : 1.0)));
  return __double2ll_rn((raw <= __dmul_rn(2.5, m) && zeros > 0.0) ? lc : raw);
}

__device__ __forceinline__ double f64_at(const i64* p, i64 g) { return ((const double*)p)[g]; }

// Chan's pairwise update of two variance states' m2
__device__ __forceinline__ double chan_m2(double s_a, double m2a, i64 n_a, double s_b,
                                          double m2b, i64 n_b) {
  if (n_a == 0) return m2b;
  if (n_b == 0) return m2a;
  const double naf = __ll2double_rn(n_a), nbf = __ll2double_rn(n_b);
  const double sum_n = __dadd_rn(naf, nbf);
  const double nf = sum_n > 1.0 ? sum_n : 1.0;
  const double mean_a = __ddiv_rn(s_a, naf > 1.0 ? naf : 1.0);
  const double mean_b = __ddiv_rn(s_b, nbf > 1.0 ? nbf : 1.0);
  const double delta = __dsub_rn(mean_b, mean_a);
  const double t = __ddiv_rn(__dmul_rn(__dmul_rn(__dmul_rn(delta, delta), naf), nbf), nf);
  return __dadd_rn(__dadd_rn(m2a, m2b), t);
}

struct K3Desc {
  int n_items;
  int kind[K3_MAX_ITEMS];
  int elem[K3_MAX_ITEMS];
  const i64* in0[K3_MAX_ITEMS];
  const i64* in1[K3_MAX_ITEMS];
  const uint8_t* in2[K3_MAX_ITEMS];
  const uint8_t* in3[K3_MAX_ITEMS];
  i64* out0[K3_MAX_ITEMS];
  uint8_t* out1[K3_MAX_ITEMS];
};

// two central-moment states folded: moment_terms of each side about
// the folded mean, added (kernels/packed_fold_finalize.py moments_fold);
// f is the state's s column, k 0..2 picks m2, m3 or m4
__device__ __forceinline__ double moments_fold(const K3Desc& d, int f, int k, i64 g) {
  const i64 na = d.in0[f + 4][g], nb = d.in1[f + 4][g];
  const double sa = f64_at(d.in0[f], g), sb = f64_at(d.in1[f], g);
  const double n = __ll2double_rn(na + nb);
  const double mu = __ddiv_rn(__dadd_rn(sa, sb), n > 1.0 ? n : 1.0);
  double ta[3], tb[3];
  moment_terms(sa, f64_at(d.in0[f + 1], g), f64_at(d.in0[f + 2], g), f64_at(d.in0[f + 3], g),
               na, mu, ta);
  moment_terms(sb, f64_at(d.in1[f + 1], g), f64_at(d.in1[f + 2], g), f64_at(d.in1[f + 3], g),
               nb, mu, tb);
  return __dadd_rn(ta[k], tb[k]);
}

// min_by / max_by: a value of storage `elem` at g as its order key
// (is_min: a y of min_by; an x takes the max side) and back
__device__ __forceinline__ i64 by_load(const i64* p, int elem, i64 g) {
  if (elem == ELEM_I32) return ((const int*)p)[g];
  if (elem == ELEM_BOOL) return ((const uint8_t*)p)[g] != 0;
  return p[g];
}
__device__ __forceinline__ i64 by_key(const i64* p, int elem, i64 g, bool is_min) {
  const i64 v = by_load(p, elem, g);
  return elem == ELEM_F64 ? minmax_key(v, is_min) : v;
}
__device__ __forceinline__ void by_store(i64* p, int elem, i64 g, i64 key, bool is_min) {
  if (elem == ELEM_F64) p[g] = minmax_value(key, is_min);
  else if (elem == ELEM_I32) ((int*)p)[g] = narrow_extreme(key);
  else if (elem == ELEM_BOOL) ((uint8_t*)p)[g] = key == I64_MIN ? 0 : key != 0;
  else p[g] = key;
}
// equal as values (a double NaN equals nothing)
__device__ __forceinline__ bool by_equal(i64 a, i64 b, int elem) {
  return elem == ELEM_F64 ? __longlong_as_double(a) == __longlong_as_double(b) : a == b;
}

// The fold of one min_by / max_by state (x, flag, y, cnt at column c):
// out column `part` (0 x, 1 flag, 2 y)
__device__ __forceinline__ void by_fold(const K3Desc& d, int c, int part, i64 g) {
  const int ex = d.elem[c], ey = d.elem[c + 2];
  const bool y_min = d.kind[c + 2] == COL_BY_Y_MIN;
  const i64 ca = d.in0[c + 3][g], cb = d.in1[c + 3][g];
  const i64 ident = y_min ? I64_MAX : I64_MIN;
  const i64 ka = ca > 0 ? by_key(d.in0[c + 2], ey, g, y_min) : ident;
  const i64 kb = cb > 0 ? by_key(d.in1[c + 2], ey, g, y_min) : ident;
  const i64 k = y_min ? (ka < kb ? ka : kb) : (ka > kb ? ka : kb);
  if (part == 2) { by_store(d.out0[c + 2], ey, g, k, y_min); return; }
  const i64 y = ey == ELEM_F64 ? minmax_value(k, y_min) : k;
  const bool ta = ca > 0 && d.in0[c + 1][g] > 0 && by_equal(by_load(d.in0[c + 2], ey, g), y, ey);
  const bool tb = cb > 0 && d.in1[c + 1][g] > 0 && by_equal(by_load(d.in1[c + 2], ey, g), y, ey);
  if (part == 1) { d.out0[c + 1][g] = ta || tb; return; }
  const i64 xa = ta ? by_key(d.in0[c], ex, g, false) : I64_MIN;
  const i64 xb = tb ? by_key(d.in1[c], ex, g, false) : I64_MIN;
  by_store(d.out0[c], ex, g, xa > xb ? xa : xb, false);
}

// max(x, 0.0) that keeps a NaN (jnp.maximum)
__device__ __forceinline__ double nan_max0(double x) { return (x > 0.0 || x != x) ? x : 0.0; }

__device__ __forceinline__ void normalize(i64 hi, i64 lo, i64* out) {
  const i64 carry = fdiv(lo, B18);
  out[0] = wadd(hi, carry);
  out[1] = lo - carry * B18;
}

// HALF_UP mean of a two-limb sum over n > 0 rows, as a 128-bit value.
__device__ __forceinline__ __int128 avg128(const i64* s, i64 n) {
  const __int128 v = (__int128)s[0] * B18 + s[1];
  const bool neg = s[0] < 0;
  const __int128 a = neg ? -v : v;
  __int128 q = a / n;
  const __int128 r = a - q * n;
  if (2 * r >= n) q += 1;
  return neg ? -q : q;
}

__device__ __forceinline__ void split128(__int128 v, i64* out) {
  __int128 hi = v / B18;
  __int128 lo = v - hi * B18;
  if (lo < 0) { lo += B18; hi -= 1; }
  out[0] = (i64)hi;
  out[1] = (i64)lo;
}

__global__ void k3_kernel(const K3Desc d, int mode, i64 n_groups,
                          const uint8_t* __restrict__ mask_a,
                          const uint8_t* __restrict__ mask_b,
                          uint8_t* __restrict__ mask_out) {
  const i64 g = (i64)blockIdx.x * blockDim.x + threadIdx.x;
  if (g >= n_groups) return;
  if (mode == MODE_FOLD) {
    mask_out[g] = mask_a[g] | mask_b[g];
    for (int c = 0; c < d.n_items; ++c) {
      const int kind = d.kind[c];
      if (kind == COL_D128) {
        const i64* a = d.in0[c] + 2 * g;
        const i64* b = d.in1[c] + 2 * g;
        normalize(wadd(a[0], b[0]), a[1] + b[1], d.out0[c] + 2 * g);
      } else if (kind == COL_MIN_D128 || kind == COL_MAX_D128) {
        const i64* a = d.in0[c] + 2 * g;
        const i64* b = d.in1[c] + 2 * g;
        const bool a_less = a[0] < b[0] || (a[0] == b[0] && a[1] < b[1]);
        const i64* w = (kind == COL_MIN_D128) == a_less ? a : b;
        d.out0[c][2 * g] = w[0];
        d.out0[c][2 * g + 1] = w[1];
      } else if (kind == COL_D38 || kind == COL_MIN_D38 || kind == COL_MAX_D38) {
        i64 a[D38_LIMBS], b[D38_LIMBS];
        for (int j = 0; j < D38_LIMBS; ++j) {
          a[j] = d.in0[c][D38_LIMBS * g + j];
          b[j] = d.in1[c][D38_LIMBS * g + j];
        }
        if (kind == COL_D38) {  // decimal128.add: limb sums, then _norm_wide
          for (int j = 0; j < D38_LIMBS; ++j) a[j] = wadd(a[j], b[j]);
          w_norm(a);
        } else if ((w_cmp(a, b) < 0) != (kind == COL_MIN_D38)) {  // b wins
          for (int j = 0; j < D38_LIMBS; ++j) a[j] = b[j];
        }
        for (int j = 0; j < D38_LIMBS; ++j) d.out0[c][D38_LIMBS * g + j] = a[j];
      } else if (kind == COL_MIN_I32 || kind == COL_MAX_I32) {
        const int a = ((const int*)d.in0[c])[g], b = ((const int*)d.in1[c])[g];
        ((int*)d.out0[c])[g] = kind == COL_MIN_I32 ? min(a, b) : max(a, b);
      } else if (kind == COL_F64) {
        ((double*)d.out0[c])[g] = __dadd_rn(f64_at(d.in0[c], g), f64_at(d.in1[c], g));
      } else if (kind == COL_MOM_M2 || kind == COL_MOM_M3 || kind == COL_MOM_M4) {
        const int k = kind - COL_MOM_M2;
        ((double*)d.out0[c])[g] = moments_fold(d, c - 1 - k, k, g);  // s in column c - 1 - k
      } else if (kind == COL_BY_X) {
        by_fold(d, c, 0, g);
      } else if (kind == COL_BY_XV) {
        by_fold(d, c - 1, 1, g);
      } else if (kind == COL_BY_Y_MIN || kind == COL_BY_Y_MAX) {
        by_fold(d, c - 2, 2, g);
      } else if (kind == COL_VAR_M2) {  // s in column c - 1, the count in c + 1
        ((double*)d.out0[c])[g] = chan_m2(f64_at(d.in0[c - 1], g), f64_at(d.in0[c], g),
                                          d.in0[c + 1][g], f64_at(d.in1[c - 1], g),
                                          f64_at(d.in1[c], g), d.in1[c + 1][g]);
      } else if (kind == COL_MIN_I64 || kind == COL_MAX_I64) {  // int64, int16 or int8
        const int e = d.elem[c];
        const i64 a = elem_load(d.in0[c], e, g), b = elem_load(d.in1[c], e, g);
        elem_store(d.out0[c], e, g, kind == COL_MIN_I64 ? (a < b ? a : b) : (a > b ? a : b));
      } else if (kind == COL_MIN_F64 || kind == COL_MAX_F64) {  // by the order key
        const bool is_min = kind == COL_MIN_F64;
        const int e = d.elem[c];  // a double or a REAL
        const i64 ka = minmax_key(elem_load(d.in0[c], e, g), is_min);
        const i64 kb = minmax_key(elem_load(d.in1[c], e, g), is_min);
        elem_store(d.out0[c], e, g,
                   minmax_value(is_min ? (ka < kb ? ka : kb) : (ka > kb ? ka : kb), is_min));
      } else if (kind == COL_MIN_BOOL || kind == COL_MAX_BOOL) {
        const uint8_t a = ((const uint8_t*)d.in0[c])[g], b = ((const uint8_t*)d.in1[c])[g];
        ((uint8_t*)d.out0[c])[g] = kind == COL_MIN_BOOL ? (a && b) : (a || b);
      } else if (kind == COL_BAND || kind == COL_BOR) {
        const i64 a = d.in0[c][g], b = d.in1[c][g];
        d.out0[c][g] = kind == COL_BAND ? (a & b) : (a | b);
      } else {
        d.out0[c][g] = wadd(d.in0[c][g], d.in1[c][g]);
      }
      d.out1[c][g] = d.in2[c][g] | d.in3[c][g];
    }
    return;
  }
  const bool live = mask_a[g] != 0;
  for (int c = 0; c < d.n_items; ++c) {
    const int kind = d.kind[c];
    if (kind == FIN_COUNT) {
      d.out0[c][g] = d.in0[c][g];
      d.out1[c][g] = live;
      continue;
    }
    const i64 cnt = d.in1[c][g];
    const bool sum0 = kind == FIN_SUM0 || kind == FIN_SUM0_D128 || kind == FIN_SUM0_COLLAPSE;
    const bool sample = kind == FIN_VAR_SAMP || kind == FIN_STDDEV_SAMP;
    d.out1[c][g] = live && (sum0 || kind == FIN_HLL || cnt > (sample ? 1 : 0));
    const i64 n = cnt > 1 ? cnt : 1;
    switch (kind) {
      case FIN_SUM:  // also a min/max
      case FIN_SUM0:
      case FIN_SUM_F64:  // a double's bits
        d.out0[c][g] = d.in0[c][g];
        break;
      case FIN_SUM_COLLAPSE:
      case FIN_SUM0_COLLAPSE:
        d.out0[c][g] = wadd(wmul(d.in0[c][2 * g], B18), d.in0[c][2 * g + 1]);
        break;
      case FIN_AVG_F64:
        ((double*)d.out0[c])[g] = __ddiv_rn(f64_at(d.in0[c], g), __ll2double_rn(n));
        break;
      case FIN_VAR_POP:
      case FIN_VAR_SAMP:
      case FIN_STDDEV_POP:
      case FIN_STDDEV_SAMP: {  // in0: m2
        const double nf = __ll2double_rn(n);
        const double q = __ddiv_rn(f64_at(d.in0[c], g), nf);
        const double pop = (q > 0.0 || q != q) ? q : 0.0;  // max(q, 0), NaN stays
        double var = pop;
        if (sample) {
          const double nm1 = __dsub_rn(nf, 1.0);
          var = __ddiv_rn(__dmul_rn(pop, nf), nm1 > 1.0 ? nm1 : 1.0);
        }
        if (kind == FIN_STDDEV_POP || kind == FIN_STDDEV_SAMP) var = __dsqrt_rn(var);
        ((double*)d.out0[c])[g] = var;
        break;
      }
      case FIN_VALUE_I32: ((int*)d.out0[c])[g] = ((const int*)d.in0[c])[g]; break;
      case FIN_VALUE:  // a SMALLINT, TINYINT or REAL min/max in its storage
        elem_store(d.out0[c], d.elem[c], g, elem_load(d.in0[c], d.elem[c], g));
        break;
      case FIN_VALUE_BOOL:
        ((uint8_t*)d.out0[c])[g] = ((const uint8_t*)d.in0[c])[g];
        break;
      case FIN_BOOL_AND:  // (count of true, count)
      case FIN_BOOL_OR:
        ((uint8_t*)d.out0[c])[g] = kind == FIN_BOOL_OR ? d.in0[c][g] > 0 : d.in0[c][g] == cnt;
        break;
      case FIN_HLL:  // (sum of 2^-rho, present buckets)
        d.out0[c][g] = hll_estimate(f64_at(d.in0[c], g), cnt);
        break;
      case FIN_SKEWNESS:
      case FIN_KURTOSIS: {  // in0: (m2, m3, m4) per group
        const double* m = (const double*)d.in0[c] + 3 * g;
        const double nf = __ll2double_rn(n);
        const double safe = m[0] == 0.0 ? 1.0 : m[0];
        double v;
        if (kind == FIN_SKEWNESS) {
          v = __ddiv_rn(__dmul_rn(__dsqrt_rn(nf), m[1]), pow(safe, 1.5));
        } else {
          const double d1 = __dsub_rn(nf, 1.0);
          const double e2 = __dsub_rn(nf, 2.0), e3 = __dsub_rn(nf, 3.0);
          const double d2 = e2 > 1.0 ? e2 : 1.0, d3 = e3 > 1.0 ? e3 : 1.0;
          const double dd = __dmul_rn(d2, d3);
          const double a = __dmul_rn(__ddiv_rn(__dmul_rn(__dmul_rn(nf, __dadd_rn(nf, 1.0)), d1),
                                               dd),
                                     __ddiv_rn(m[2], __dmul_rn(safe, safe)));
          v = __dsub_rn(a, __ddiv_rn(__dmul_rn(__dmul_rn(3.0, d1), d1), dd));
        }
        ((double*)d.out0[c])[g] = v;
        d.out1[c][g] = live && cnt >= (kind == FIN_SKEWNESS ? 3 : 4) && m[0] > 0.0;
        break;
      }
      case FIN_COVAR_POP:
      case FIN_COVAR_SAMP:
      case FIN_CORR:
      case FIN_REGR_SLOPE:
      case FIN_REGR_INTERCEPT: {  // in0: (sx, sy, sxy, sxx, syy) per group
        const double* m = (const double*)d.in0[c] + 5 * g;
        const double nf = __ll2double_rn(n);
        const double mx = __ddiv_rn(m[0], nf), my = __ddiv_rn(m[1], nf);
        const double cov = __dsub_rn(__ddiv_rn(m[2], nf), __dmul_rn(mx, my));
        const double varx = nan_max0(__dsub_rn(__ddiv_rn(m[3], nf), __dmul_rn(mx, mx)));
        const double vary = nan_max0(__dsub_rn(__ddiv_rn(m[4], nf), __dmul_rn(my, my)));
        double v;
        bool ok = cnt > 1;
        if (kind == FIN_COVAR_POP) {
          v = cov;
          ok = cnt > 0;
        } else if (kind == FIN_COVAR_SAMP) {
          const double nm1 = __dsub_rn(nf, 1.0);
          v = __ddiv_rn(__dmul_rn(cov, nf), nm1 > 1.0 ? nm1 : 1.0);
        } else if (kind == FIN_CORR) {
          const double denom = __dsqrt_rn(__dmul_rn(varx, vary));
          v = __ddiv_rn(cov, denom == 0.0 ? 1.0 : denom);
          ok = ok && denom > 0.0;
        } else {
          const double slope = __ddiv_rn(cov, varx == 0.0 ? 1.0 : varx);
          v = kind == FIN_REGR_SLOPE ? slope : __dsub_rn(my, __dmul_rn(slope, mx));
          ok = ok && varx > 0.0;
        }
        ((double*)d.out0[c])[g] = v;
        d.out1[c][g] = live && ok;
        break;
      }
      case FIN_SUM_D128:
      case FIN_SUM0_D128:
        d.out0[c][2 * g] = d.in0[c][2 * g];
        d.out0[c][2 * g + 1] = d.in0[c][2 * g + 1];
        break;
      case FIN_AVG_SHORT: {
        const i64 s = d.in0[c][g];
        const i64 av = s < 0 ? wneg(s) : s;
        i64 q = fdiv(av, n);
        q += (wmul(2, wsub(av, wmul(q, n))) >= n) ? 1 : 0;
        d.out0[c][g] = wmul(s < 0 ? -1 : 1, q);
        break;
      }
      case FIN_AVG_D128: split128(avg128(d.in0[c] + 2 * g, n), d.out0[c] + 2 * g); break;
      case FIN_SUM_D38:  // also a wide min/max
        for (int j = 0; j < D38_LIMBS; ++j)
          d.out0[c][D38_LIMBS * g + j] = d.in0[c][D38_LIMBS * g + j];
        break;
      case FIN_AVG_D38: {  // _avg_decimal128's wide branch: long division over the limbs
        i64 a[D38_LIMBS], q[D38_LIMBS];
        for (int j = 0; j < D38_LIMBS; ++j) a[j] = d.in0[c][D38_LIMBS * g + j];
        const bool neg = a[0] < 0;
        if (neg) w_neg(a);
        i64 r = 0;
        for (int j = 0; j < D38_LIMBS; ++j) {
          const i64 cur = wadd(wmul(r, B9), a[j]);
          q[j] = fdiv(cur, n);
          r = wsub(cur, wmul(q[j], n));
        }
        q[D38_LIMBS - 1] = wadd(q[D38_LIMBS - 1], wmul(2, r) >= n ? 1 : 0);  // HALF_UP
        w_norm(q);
        if (neg) w_neg(q);
        for (int j = 0; j < D38_LIMBS; ++j) d.out0[c][D38_LIMBS * g + j] = q[j];
        break;
      }
      case FIN_AVG_DOUBLE:  // float64(sum) / float64(max(count, 1)), a true division
        ((double*)d.out0[c])[g] = __ddiv_rn(__ll2double_rn(d.in0[c][g]), __ll2double_rn(n));
        break;
      default: {  // FIN_AVG_D128_NARROW: the mean of a widened short sum
        i64 q[2];
        split128(avg128(d.in0[c] + 2 * g, n), q);
        d.out0[c][g] = wadd(wmul(q[0], B18), q[1]);
      }
    }
  }
}

// mode MODE_FOLD: item c is a state column (in0/in1 the two data
// columns, in2/in3 their validity; out0/out1 the result; elem its
// storage), mask_out = mask_a | mask_b; a moments or min_by state's
// columns come in their state's order.  mode MODE_FINALIZE: item c is an aggregate (in0
// the count or sum, in1 the count; out0/out1 data and validity) of the
// table whose row mask is mask_a.  Returns cudaGetLastError().
extern "C" int k3_packed_fold_finalize(int mode, i64 n_groups, int n_items, const int* kind,
                                       const i64* in0, const i64* in1, const i64* in2,
                                       const i64* in3, const i64* out0, const i64* out1,
                                       const int* elem, const void* mask_a, const void* mask_b,
                                       void* mask_out, void* stream) {
  if (n_items > K3_MAX_ITEMS || n_groups < 1) return (int)cudaErrorInvalidValue;
  K3Desc d;
  d.n_items = n_items;
  for (int c = 0; c < n_items; ++c) {
    if (kind[c] < 0 || kind[c] > (mode == MODE_FOLD ? COL_LAST : FIN_LAST))
      return (int)cudaErrorInvalidValue;
    // a moments or min_by state's columns stay within the table
    if (mode == MODE_FOLD && ((kind[c] >= COL_MOM_M2 && kind[c] <= COL_MOM_M4 &&
                               (c < 1 + kind[c] - COL_MOM_M2 ||
                                c + 3 - (kind[c] - COL_MOM_M2) >= n_items)) ||
                              (kind[c] >= COL_BY_X && kind[c] <= COL_BY_Y_MAX &&
                               (c < (kind[c] >= COL_BY_Y_MIN ? 2 : kind[c] - COL_BY_X) ||
                                c + 3 - (kind[c] >= COL_BY_Y_MIN ? 2 : kind[c] - COL_BY_X) >=
                                    n_items))))
      return (int)cudaErrorInvalidValue;
    d.kind[c] = kind[c];
    d.elem[c] = elem[c];
    d.in0[c] = (const i64*)in0[c];
    d.in1[c] = (const i64*)in1[c];
    d.in2[c] = (const uint8_t*)in2[c];
    d.in3[c] = (const uint8_t*)in3[c];
    d.out0[c] = (i64*)out0[c];
    d.out1[c] = (uint8_t*)out1[c];
  }
  const int threads = 128;
  k3_kernel<<<(int)((n_groups + threads - 1) / threads), threads, 0, (cudaStream_t)stream>>>(
      d, mode, n_groups, (const uint8_t*)mask_a, (const uint8_t*)mask_b, (uint8_t*)mask_out);
  return (int)cudaGetLastError();
}
