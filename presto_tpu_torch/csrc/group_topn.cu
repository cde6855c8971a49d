// K15 group_topn: the per-group state of max(x, n), min(x, n),
// max_by(x, y, n) and min_by(x, y, n), and of their merge.
//
// Replaces: presto_tpu/ops/aggregate.py _topn_halves (:1020), which
// grouped_aggregate's top-n branch (:784) and _merge_states' top-n
// merge (:1254) call: a jnp.lexsort by (group, key), a rank within the
// group's run, the lane `size - 1 - rank` (max forms) or `rank` (min
// forms), and a scatter of the value (and, for the *_by_n forms, the
// key) to the lane when it is below n, which XLA ran as a sort, a
// cumulative max and two scatters.
//
// Bound on the H100: memory, and small.  The host's two stable sorts
// (torch.sort, as the reference's lexsort is XLA's sort) order the
// entries by (group, key); this kernel then writes each state slot
// once and reads at most n entries of each group (its permutation
// entry and its value, and its key): TPC-H SF10 max(l_extendedprice,
// 5) by l_suppkey writes a (100k, 6) float64 matrix (4.8 MB) and
// gathers 500k entries, ~3 us at 3.35 TB/s.  The sorts of the 60M
// entries, not this kernel, take the phase's time.
//
// Design: one thread per output slot (group, column), grid-stride,
// coalesced stores.  Slot 0 holds min(size, n); lane j of a half reads
// the entry at sorted position start + rank (rank = size - 1 - j for
// the max forms, j for the min forms) and writes its value or key, or
// the sentinel past the group's size.  Each slot has one writer, so
// there is no fill pass, no atomic and no race, and a group of 30M
// entries costs what a group of 5 does: the work is n per group
// however skewed the groups are (a thread per group walking its run,
// K14's design, measured slower than its twin on skewed groups).  The
// order among equal keys is the stable sort's (input order), reversed
// in the max forms, as the reference's.

#include "common.cuh"

enum { T_I32 = 1, T_I64 = 2, T_F64 = 3 };

template <typename T> __device__ __forceinline__ T topn_sent();
template <> __device__ __forceinline__ int topn_sent<int>() { return (int)0x80000000; }
template <> __device__ __forceinline__ i64 topn_sent<i64>() { return I64_MIN; }
template <> __device__ __forceinline__ double topn_sent<double>() {
  return __longlong_as_double(0x7ff8000000000000LL);
}

template <typename T>
static __global__ void k15_topn(i64 groups, const i64* __restrict__ perm,
                                const i64* __restrict__ starts, const T* __restrict__ vals,
                                const T* __restrict__ keys, int cap, int halves, int desc,
                                T* __restrict__ out) {
  const i64 w = 1 + (i64)halves * cap;
  const i64 total = groups * w;
  const i64 stride = (i64)gridDim.x * blockDim.x;
  for (i64 i = (i64)blockIdx.x * blockDim.x + threadIdx.x; i < total; i += stride) {
    const i64 g = i / w;
    const int c = (int)(i - g * w);
    const i64 s0 = starts[g];
    const i64 size = starts[g + 1] - s0;
    T v;
    if (c == 0) {
      v = (T)(size < cap ? size : (i64)cap);
    } else {
      const int h = (c - 1) / cap;
      const i64 lane = (c - 1) - (i64)h * cap;
      if (lane < size) {
        const i64 row = perm[s0 + (desc ? size - 1 - lane : lane)];
        v = h == 0 ? vals[row] : keys[row];
      } else {
        v = topn_sent<T>();
      }
    }
    out[i] = v;
  }
}

// out: (groups, 1 + halves * cap) of the storage kind; halves 2 reads
// keys beside vals (the *_by_n forms), 1 the values alone.
extern "C" int k15_group_topn(i64 groups, const void* perm, const void* starts,
                              const void* vals, const void* keys, int cap, int halves, int desc,
                              int storage, void* out, void* stream) {
  if (cap < 1 || halves < 1 || halves > 2 || (halves == 2 && keys == nullptr) ||
      storage < T_I32 || storage > T_F64)
    return (int)cudaErrorInvalidValue;
  if (groups <= 0) return (int)cudaGetLastError();
  cudaStream_t s = (cudaStream_t)stream;
  const i64 total = groups * (1 + (i64)halves * cap);
  const int grid = grid_for(total, 256, 8);
  const i64* pm = (const i64*)perm;
  const i64* st = (const i64*)starts;
  switch (storage) {
    case T_I32:
      k15_topn<int><<<grid, 256, 0, s>>>(groups, pm, st, (const int*)vals, (const int*)keys,
                                         cap, halves, desc, (int*)out);
      break;
    case T_I64:
      k15_topn<i64><<<grid, 256, 0, s>>>(groups, pm, st, (const i64*)vals, (const i64*)keys,
                                         cap, halves, desc, (i64*)out);
      break;
    default:
      k15_topn<double><<<grid, 256, 0, s>>>(groups, pm, st, (const double*)vals,
                                            (const double*)keys, cap, halves, desc,
                                            (double*)out);
  }
  return (int)cudaGetLastError();
}
