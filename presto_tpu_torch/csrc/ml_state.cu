// K19 ml_state: the ML aggregates' sufficient statistics per group
// (learn_regressor, learn_classifier, evaluate_classifier_predictions)
// and the merge of their partial states.
//
// Replaces: presto_tpu/ops/aggregate.py _partial_states' ML branches
// (evaluate_classifier_predictions :574, learn_regressor /
// learn_classifier :600) and _merge_states' (:1176), which built a
// (rows, m) lane matrix per page (the regressor's (k+1)^2 outer products
// of [x, 1] and [x, 1] * y, the classifier's one-hot, one-hot x x and
// one-hot x x^2, evaluate's tp / fp / fn) and summed it per group with
// a segment sum.
//
// Bound on the H100: memory for the partials (each row's label, y and
// k feature slots read once, the (groups, 1 + m) state written once:
// 60M lineitem rows with three features move ~2.4 GB, ~0.7 ms at 3.35
// TB/s; the lanes are m multiply-adds a row, ~20 for the regressor
// over three features, well under the float64 rate).
//
// Design: no (rows, m) matrix is written; each row's lanes are built in
// registers where they are added.  K19a runs one block per chunk of
// K19_CHUNK rows (packed-direct: row chunks of the page; runs: chunks
// of K19_CHUNK sorted positions of one group's run, K6's order): the
// block stages its rows' indices, selection and slots in shared
// memory, then thread j owns lane j (j, j + 256, ...) of every slot's
// row of a shared table and adds the chunk's selected rows to it one by
// one in order from 0.0, and writes the chunk's partials to scratch.
// K19b runs one block per group: the group's chunk partials add
// pairwise, level by level (chunk 2i + chunk 2i + 1, an odd last
// passing up: the stride-doubling tree in place), the sum order K2 and
// K6 use for their double states, so the card's sums equal the twin's
// bit for bit whatever the schedule.  Every double operation is an _rn
// intrinsic (no fused multiply-add: the reference rounds each product).
// Integer lanes (evaluate's counts, their merge) and the counts of
// selected rows add by 64-bit atomics, shared within a chunk, then to
// the zeroed state.  The packed-direct table is groups x m doubles in
// shared memory (at most K19_DIRECT_LANES: the caller takes the sort
// path past it).

#include "common.cuh"

#define K19_CHUNK 256
#define K19_MAX_K 16
#define K19_DIRECT_LANES 4096
#define K19_C 8

enum { M_REGRESSOR = 0, M_CLASSIFIER = 1, M_EVALUATE = 2, M_MERGE = 3, M_MERGE_I64 = 4 };

struct K19 {
  int mode;
  i64 n, groups;
  int k, m;
  const uint8_t* sel;
  const i64* label;
  const double* y;
  const void* feats;
  const void* parts;
  const i64* counts;
  const i64* slot;
  const i64* order;
  const i64* starts;
  const i64* chunk_lo;
  void* state;
  i64* count;
  int f_w, f_kind;
  i64 chunks;
  double* scratch;
};

// slot 1 + j of row r of the features matrix as a double, NULL as 0.0
__device__ __forceinline__ double k19_feat(const K19& g, i64 r, int j) {
  const i64 at = r * g.f_w + 1 + j;
  if (g.f_kind == 1) {
    const int v = ((const int*)g.feats)[at];
    return v == (int)0x80000000 ? 0.0 : (double)v;
  }
  if (g.f_kind == 2) {
    const i64 v = ((const i64*)g.feats)[at];
    return v == I64_MIN ? 0.0 : __ll2double_rn(v);
  }
  const double v = ((const double*)g.feats)[at];
  return isnan(v) ? 0.0 : v;
}

// lane j of row r (the double modes)
__device__ __forceinline__ double k19_lane(const K19& g, i64 r, int j) {
  if (g.mode == M_MERGE) return ((const double*)g.parts)[r * g.m + j];
  const int k = g.k;
  if (g.mode == M_REGRESSOR) {
    const int dim = k + 1;
    if (j < dim * dim) {
      const int a = j / dim, b = j % dim;
      const double xa = a < k ? k19_feat(g, r, a) : 1.0;
      const double xb = b < k ? k19_feat(g, r, b) : 1.0;
      return __dmul_rn(xa, xb);
    }
    const int i = j - dim * dim;
    return __dmul_rn(i < k ? k19_feat(g, r, i) : 1.0, g.y[r]);
  }
  i64 cls = g.label[r];
  cls = cls < 0 ? 0 : (cls > K19_C - 1 ? K19_C - 1 : cls);
  if (j < K19_C) return j == cls ? 1.0 : 0.0;
  int jj = j - K19_C;
  const bool sq = jj >= K19_C * k;
  if (sq) jj -= K19_C * k;
  const int c = jj / k, f = jj % k;
  const double oh = c == cls ? 1.0 : 0.0;
  const double x = k19_feat(g, r, f);
  return __dmul_rn(oh, sq ? __dmul_rn(x, x) : x);
}

// whether row r counts: selected, and for evaluate truth and prediction in [0, C)
__device__ __forceinline__ bool k19_selected(const K19& g, i64 r) {
  if (!g.sel[r]) return false;
  if (g.mode != M_EVALUATE) return true;
  const i64 t = g.label[2 * r], p = g.label[2 * r + 1];
  return t >= 0 && t < K19_C && p >= 0 && p < K19_C;
}

// K19a: one block per chunk
static __global__ void k19_chunks(K19 g) {
  extern __shared__ double smem[];
  const bool runs = g.starts != nullptr;
  const i64 T = runs ? 1 : g.groups;  // the table's rows
  const bool ints = g.mode == M_EVALUATE || g.mode == M_MERGE_I64;
  double* tab = smem;                                   // T x m doubles (double modes)
  u64* itab = (u64*)smem;                               // T x m int64 (integer modes)
  u64* cnt = (u64*)(smem + T * g.m);                    // T counts
  i64* srow = (i64*)(cnt + T);                          // K19_CHUNK rows
  int* sslot = (int*)(srow + K19_CHUNK);                // their slots, -1 unselected
  const i64 c = blockIdx.x;
  i64 grp = 0, p0, p1;
  if (runs) {  // the chunk's group: the last with chunk_lo[g] <= c
    i64 lo = 0, hi = g.groups;
    while (hi - lo > 1) {
      const i64 mid = (lo + hi) / 2;
      if (g.chunk_lo[mid] <= c) lo = mid;
      else hi = mid;
    }
    grp = lo;
    p0 = g.starts[grp] + (c - g.chunk_lo[grp]) * K19_CHUNK;
    p1 = min(p0 + K19_CHUNK, g.starts[grp + 1]);
  } else {
    p0 = c * K19_CHUNK;
    p1 = min(p0 + K19_CHUNK, g.n);
  }
  const int len = (int)(p1 > p0 ? p1 - p0 : 0);
  for (i64 i = threadIdx.x; i < T * g.m; i += blockDim.x) {
    if (ints) itab[i] = 0;
    else tab[i] = 0.0;
  }
  for (i64 i = threadIdx.x; i < T; i += blockDim.x) cnt[i] = 0;
  if ((int)threadIdx.x < K19_CHUNK) {
    const int t = threadIdx.x;
    int s = -1;
    i64 r = 0;
    if (t < len) {
      const i64 p = p0 + t;
      r = runs && g.order != nullptr ? g.order[p] : p;
      if (k19_selected(g, r)) {
        const i64 sl = runs || g.slot == nullptr ? 0 : g.slot[r];
        if (sl >= 0 && sl < T) s = (int)sl;
      }
    }
    srow[t] = r;
    sslot[t] = s;
  }
  __syncthreads();
  if ((int)threadIdx.x < len && sslot[threadIdx.x] >= 0) {
    const int t = threadIdx.x;
    atomicAdd(cnt + sslot[t], (u64)(g.counts != nullptr ? g.counts[srow[t]] : 1));
    if (g.mode == M_EVALUATE) {  // tp at the truth, or fp at the prediction and fn at the truth
      const i64 tr = g.label[2 * srow[t]], pr = g.label[2 * srow[t] + 1];
      u64* row = itab + (i64)sslot[t] * g.m;
      if (tr == pr) {
        atomicAdd(row + tr, 1ull);
      } else {
        atomicAdd(row + K19_C + pr, 1ull);
        atomicAdd(row + 2 * K19_C + tr, 1ull);
      }
    }
  }
  if (g.mode == M_MERGE_I64) {
    for (int j = threadIdx.x; j < g.m; j += blockDim.x)
      for (int q = 0; q < len; ++q)
        if (sslot[q] >= 0)
          itab[(i64)sslot[q] * g.m + j] += (u64)((const i64*)g.parts)[srow[q] * g.m + j];
  } else if (!ints) {
    for (int j = threadIdx.x; j < g.m; j += blockDim.x)
      for (int q = 0; q < len; ++q)
        if (sslot[q] >= 0) {
          double* a = tab + (i64)sslot[q] * g.m + j;
          *a = __dadd_rn(*a, k19_lane(g, srow[q], j));
        }
  }
  __syncthreads();
  const i64 off = g.mode == M_MERGE || g.mode == M_MERGE_I64 ? 0 : 1;
  const i64 w = g.m + off;
  for (i64 s = threadIdx.x; s < T; s += blockDim.x)
    if (cnt[s] != 0) atomicAdd((u64*)(g.count + (runs ? grp : s)), cnt[s]);
  if (ints) {
    for (i64 i = threadIdx.x; i < T * g.m; i += blockDim.x)
      if (itab[i] != 0) {
        const i64 s = runs ? grp : i / g.m;
        atomicAdd((u64*)g.state + s * w + off + i % g.m, itab[i]);
      }
  } else {
    double* dst = g.scratch + c * T * g.m;
    for (i64 i = threadIdx.x; i < T * g.m; i += blockDim.x) dst[i] = tab[i];
  }
}

// K19b: one block per group, its chunk partials pairwise, then the state row
static __global__ void k19_tree(K19 g) {
  const i64 grp = blockIdx.x;
  const bool runs = g.starts != nullptr;
  const bool ints = g.mode == M_EVALUATE || g.mode == M_MERGE_I64;
  const i64 off = g.mode == M_MERGE || g.mode == M_MERGE_I64 ? 0 : 1;
  const i64 w = g.m + off;
  if (ints) {
    if (off && threadIdx.x == 0) ((i64*)g.state)[grp * w] = g.m;
    return;
  }
  const i64 base = runs ? g.chunk_lo[grp] : 0;
  const i64 nch = runs ? g.chunk_lo[grp + 1] - base : g.chunks;
  const i64 step = runs ? g.m : g.groups * g.m;  // from one chunk's row to the next
  double* P = g.scratch + (runs ? base * g.m : grp * g.m);
  for (i64 s = 1; s < nch; s <<= 1) {
    const i64 pairs = (nch + 2 * s - 1) / (2 * s);
    for (i64 idx = threadIdx.x; idx < pairs * g.m; idx += blockDim.x) {
      const i64 i = (idx / g.m) * 2 * s, j = idx % g.m;
      if (i + s < nch) P[i * step + j] = __dadd_rn(P[i * step + j], P[(i + s) * step + j]);
    }
    __syncthreads();
  }
  double* out = (double*)g.state + grp * w;
  for (i64 j = threadIdx.x; j < g.m; j += blockDim.x) out[off + j] = nch > 0 ? P[j] : 0.0;
  if (off && threadIdx.x == 0) out[0] = (double)g.m;
}

extern "C" int k19_ml_state(int mode, i64 n, i64 groups, int k, int m, const uint8_t* sel,
                            const i64* label, const double* y, const void* feats,
                            const void* parts, const i64* counts, const i64* slot,
                            const i64* order, const i64* starts, const i64* chunk_lo,
                            void* state, i64* count, int f_w, int f_kind, i64 chunks,
                            double* scratch, void* stream) {
  if (mode < M_REGRESSOR || mode > M_MERGE_I64 || groups < 1 || m < 1) {
    return (int)cudaErrorInvalidValue;
  }
  if ((mode == M_REGRESSOR || mode == M_CLASSIFIER) &&
      (k < 1 || k > K19_MAX_K || f_w < k + 1 || f_kind < 1 || f_kind > 3))
    return (int)cudaErrorInvalidValue;
  const bool runs = starts != nullptr;
  if (!runs && groups * m > K19_DIRECT_LANES) return (int)cudaErrorInvalidValue;
  K19 g;
  g.mode = mode;
  g.n = n;
  g.groups = groups;
  g.k = k;
  g.m = m;
  g.sel = sel;
  g.label = label;
  g.y = y;
  g.feats = feats;
  g.parts = parts;
  g.counts = counts;
  g.slot = slot;
  g.order = order;
  g.starts = starts;
  g.chunk_lo = chunk_lo;
  g.state = state;
  g.count = count;
  g.f_w = f_w;
  g.f_kind = f_kind;
  g.chunks = chunks;
  g.scratch = scratch;
  cudaStream_t s = (cudaStream_t)stream;
  const bool ints = mode == M_EVALUATE || mode == M_MERGE_I64;
  const i64 w = m + (mode == M_MERGE || mode == M_MERGE_I64 ? 0 : 1);
  cudaMemsetAsync(count, 0, groups * sizeof(i64), s);
  if (ints) cudaMemsetAsync(state, 0, groups * w * sizeof(i64), s);
  const i64 T = runs ? 1 : groups;
  const size_t smem = (size_t)T * m * 8 + (size_t)T * 8 + K19_CHUNK * (8 + 4);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        k19_chunks, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  if (chunks > 0) k19_chunks<<<(unsigned)chunks, K19_CHUNK, smem, s>>>(g);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  k19_tree<<<(unsigned)groups, 256, 0, s>>>(g);
  return (int)cudaGetLastError();
}
