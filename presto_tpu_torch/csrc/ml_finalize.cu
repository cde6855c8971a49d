// K20 ml_finalize: the ML aggregates' models from their summed states.
//
// Replaces: presto_tpu/ops/aggregate.py _finalize's learn_regressor
// (:1506: jnp.linalg.solve of X'X + 1e-8 I against X'y, batched over
// groups) and learn_classifier (:1517: the Gaussian naive Bayes
// prior, means and clamped variances) branches; evaluate's (:1541)
// count matrix passes through to the host finalize.
//
// Bound on the H100: memory (a state row read once, a model row written
// once) for the classifier; for the regressor the solve's
// ~dim^3 / 3 multiply-adds a group (dim = k + 1, 4 for three features:
// ~40 operations), far under the float64 rate: a few groups take
// microseconds, dominated by the launch.
//
// Design: one thread per group, grid-stride.  The regressor's thread
// copies X'X + 1e-8 I (the reference adds 1e-8 * eye: 0.0 off the
// diagonal) and X'y into local arrays, eliminates with partial
// pivoting (the first row of greatest |a| in the column), then back
// substitutes; the twin (kernels/ml_finalize.py) runs the same steps in
// the same order with elementwise torch ops, and every double operation
// here is an _rn intrinsic, so the card and the CPU agree bit for bit
// (torch.linalg.solve would not).  The reference's LAPACK solve orders
// its steps otherwise: its weights agree to the conditioning of X'X.
// The classifier's thread writes [1 + C (1 + 2k), C, prior, mean, var]
// with the reference's clamps (max(counts, 1), var >= 1e-9; NaN passes
// a clamp, as jnp.maximum's).

#include "common.cuh"

#define K20_MAX_DIM 17
#define K20_C 8

__device__ __forceinline__ double k20_at_least(double x, double lo) {
  return x > lo ? x : (isnan(x) ? x : lo);
}

static __global__ void k20_regressor(i64 groups, int k, const double* state, double* out) {
  const int dim = k + 1;
  const int m = dim * dim + dim;
  const i64 stride = (i64)gridDim.x * blockDim.x;
  for (i64 g = (i64)blockIdx.x * blockDim.x + threadIdx.x; g < groups; g += stride) {
    double a[K20_MAX_DIM * K20_MAX_DIM], b[K20_MAX_DIM], w[K20_MAX_DIM];
    const double* s = state + g * (1 + m) + 1;
    for (int i = 0; i < dim; ++i) {
      for (int j = 0; j < dim; ++j)
        a[i * dim + j] = __dadd_rn(s[i * dim + j], i == j ? 1e-8 : 0.0);
      b[i] = s[dim * dim + i];
    }
    for (int col = 0; col < dim; ++col) {
      int piv = col;
      for (int r = col + 1; r < dim; ++r)
        if (fabs(a[r * dim + col]) > fabs(a[piv * dim + col])) piv = r;
      if (piv != col) {
        for (int j = 0; j < dim; ++j) {
          const double t = a[col * dim + j];
          a[col * dim + j] = a[piv * dim + j];
          a[piv * dim + j] = t;
        }
        const double t = b[col];
        b[col] = b[piv];
        b[piv] = t;
      }
      for (int r = col + 1; r < dim; ++r) {
        const double f = __ddiv_rn(a[r * dim + col], a[col * dim + col]);
        for (int j = col; j < dim; ++j)
          a[r * dim + j] = __dsub_rn(a[r * dim + j], __dmul_rn(f, a[col * dim + j]));
        b[r] = __dsub_rn(b[r], __dmul_rn(f, b[col]));
      }
    }
    for (int r = dim - 1; r >= 0; --r) {
      double acc = b[r];
      for (int j = r + 1; j < dim; ++j) acc = __dsub_rn(acc, __dmul_rn(a[r * dim + j], w[j]));
      w[r] = __ddiv_rn(acc, a[r * dim + r]);
    }
    double* o = out + g * (1 + dim);
    o[0] = (double)dim;
    for (int i = 0; i < dim; ++i) o[1 + i] = w[i];
  }
}

static __global__ void k20_classifier(i64 groups, int k, const double* state, double* out) {
  const int m = K20_C * (1 + 2 * k);
  const i64 stride = (i64)gridDim.x * blockDim.x;
  for (i64 g = (i64)blockIdx.x * blockDim.x + threadIdx.x; g < groups; g += stride) {
    const double* s = state + g * (1 + m) + 1;
    const double* counts = s;
    const double* sumx = s + K20_C;
    const double* sumx2 = s + K20_C + K20_C * k;
    double* o = out + g * (2 + m);
    o[0] = (double)(1 + m);
    o[1] = (double)K20_C;
    double total = 0.0;
    for (int c = 0; c < K20_C; ++c) total = __dadd_rn(total, counts[c]);
    total = k20_at_least(total, 1.0);
    for (int c = 0; c < K20_C; ++c) {
      o[2 + c] = __ddiv_rn(counts[c], total);
      const double cc = k20_at_least(counts[c], 1.0);
      for (int j = 0; j < k; ++j) {
        const double mean = __ddiv_rn(sumx[c * k + j], cc);
        const double var = __dsub_rn(__ddiv_rn(sumx2[c * k + j], cc), __dmul_rn(mean, mean));
        o[2 + K20_C + c * k + j] = mean;
        o[2 + K20_C + K20_C * k + c * k + j] = k20_at_least(var, 1e-9);
      }
    }
  }
}

// mode 0 the regressor, 1 the classifier
extern "C" int k20_ml_finalize(int mode, i64 groups, int k, const double* state, double* out,
                               void* stream) {
  if (mode < 0 || mode > 1 || k < 1 || k + 1 > K20_MAX_DIM) return (int)cudaErrorInvalidValue;
  if (groups <= 0) return (int)cudaGetLastError();
  cudaStream_t s = (cudaStream_t)stream;
  const int grid = grid_for(groups, 128, 8);
  if (mode == 0) k20_regressor<<<grid, 128, 0, s>>>(groups, k, state, out);
  else k20_classifier<<<grid, 128, 0, s>>>(groups, k, state, out);
  return (int)cudaGetLastError();
}
