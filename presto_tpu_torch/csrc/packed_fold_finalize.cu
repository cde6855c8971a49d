// K3 packed_fold_finalize: slot-by-slot fold of two packed partial
// state tables, and the finalize of a folded table.
//
// Replaces: presto_tpu/ops/aggregate.py combine_packed_states,
// finalize_packed, and the parts of _finalize and _avg_decimal128
// that count/sum/avg/min/max take (ops/decimal128.py add/normalize for
// the limb states).
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

#include "common.cuh"

#define K3_MAX_ITEMS 64

enum { MODE_FOLD = 0, MODE_FINALIZE = 1 };
// fold column kinds: keep in step with kernels/packed_fold_finalize.py
enum { COL_I64 = 0, COL_D128 = 1, COL_MIN_I64 = 2, COL_MAX_I64 = 3, COL_MIN_I32 = 4,
       COL_MAX_I32 = 5, COL_MIN_D128 = 6, COL_MAX_D128 = 7, COL_F64 = 8, COL_VAR_M2 = 9 };
// finalize kinds
enum { FIN_COUNT = 0, FIN_SUM = 1, FIN_SUM_D128 = 2, FIN_AVG_SHORT = 3,
       FIN_AVG_D128 = 4, FIN_AVG_D128_NARROW = 5, FIN_VALUE_I32 = 6, FIN_AVG_DOUBLE = 7,
       FIN_SUM0 = 8, FIN_SUM0_D128 = 9, FIN_SUM_COLLAPSE = 10, FIN_SUM0_COLLAPSE = 11,
       FIN_SUM_F64 = 12, FIN_AVG_F64 = 13, FIN_VAR_POP = 14, FIN_VAR_SAMP = 15,
       FIN_STDDEV_POP = 16, FIN_STDDEV_SAMP = 17 };

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
  const i64* in0[K3_MAX_ITEMS];
  const i64* in1[K3_MAX_ITEMS];
  const uint8_t* in2[K3_MAX_ITEMS];
  const uint8_t* in3[K3_MAX_ITEMS];
  i64* out0[K3_MAX_ITEMS];
  uint8_t* out1[K3_MAX_ITEMS];
};

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
      } else if (kind == COL_MIN_I32 || kind == COL_MAX_I32) {
        const int a = ((const int*)d.in0[c])[g], b = ((const int*)d.in1[c])[g];
        ((int*)d.out0[c])[g] = kind == COL_MIN_I32 ? min(a, b) : max(a, b);
      } else if (kind == COL_F64) {
        ((double*)d.out0[c])[g] = __dadd_rn(f64_at(d.in0[c], g), f64_at(d.in1[c], g));
      } else if (kind == COL_VAR_M2) {  // s in column c - 1, the count in c + 1
        ((double*)d.out0[c])[g] = chan_m2(f64_at(d.in0[c - 1], g), f64_at(d.in0[c], g),
                                          d.in0[c + 1][g], f64_at(d.in1[c - 1], g),
                                          f64_at(d.in1[c], g), d.in1[c + 1][g]);
      } else if (kind == COL_MIN_I64 || kind == COL_MAX_I64) {
        const i64 a = d.in0[c][g], b = d.in1[c][g];
        d.out0[c][g] = kind == COL_MIN_I64 ? (a < b ? a : b) : (a > b ? a : b);
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
    d.out1[c][g] = live && (sum0 || cnt > (sample ? 1 : 0));
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
// columns, in2/in3 their validity; out0/out1 the result), mask_out =
// mask_a | mask_b.  mode MODE_FINALIZE: item c is an aggregate (in0
// the count or sum, in1 the count; out0/out1 data and validity) of the
// table whose row mask is mask_a.  Returns cudaGetLastError().
extern "C" int k3_packed_fold_finalize(int mode, i64 n_groups, int n_items, const int* kind,
                                       const i64* in0, const i64* in1, const i64* in2,
                                       const i64* in3, const i64* out0, const i64* out1,
                                       const void* mask_a, const void* mask_b,
                                       void* mask_out, void* stream) {
  if (n_items > K3_MAX_ITEMS || n_groups < 1) return (int)cudaErrorInvalidValue;
  K3Desc d;
  d.n_items = n_items;
  for (int c = 0; c < n_items; ++c) {
    d.kind[c] = kind[c];
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
