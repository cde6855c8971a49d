// K14 group_collect: the per-group element lists of array_agg, map_agg,
// hll_sketch (approx_set's outer level), multimap_agg and map_union, and
// the merge of their partial states.
//
// Replaces: presto_tpu/ops/aggregate.py grouped_aggregate's array_agg
// and map_agg branches (:640, :660: the value, or key and value, of each
// selected row scattered to the slot (group, rank), the rank from the
// stable argsort of _within_group_rank :1014), hll_sketch (:660, the
// map_agg geometry), multimap_agg (:684, a value half of 1 + 64 slots
// per entry: the entry's array), map_union (:709, each map row's
// entries at the group's running offset) and merge_aggregate's
// concatenation of partial containers at running offsets (:1185-:1240),
// which XLA ran as argsorts, cumsums and scatters.
//
// Bound on the H100: memory.  The collect reads each row's selection
// and lanes once (through the sort's permutation) and writes each
// state slot once: TPC-H SF10 array_agg(l_partkey) by l_orderkey reads
// 60M rows of one int64 lane (~0.5 GB with the permutation) and writes
// a (15M, 65) int64 matrix (7.8 GB), ~2.5 ms at 3.35 TB/s; the writes
// of the pads dominate.
//
// Design: one thread per group, grid-stride.  The group's rows are its
// run of sorted positions (K6's stable sort keeps input order inside a
// run; the global aggregate's one run is the page in order), so the
// thread walks the run in order and writes each selected row to the
// next slot, stopping at `cap` selected rows: the element order is the
// reference's stable rank by construction, and no atomic counter (whose
// order would vary from run to run) is needed.  The merge walks the
// group's run of partial rows the same way, copying each partial's
// elements at the running offset until the cap; map_union's partial is
// that merge over the input maps (their own slot count, `in_cap`, may
// differ from the state's).  The last half may be `vw` slots wide per
// element (multimap_agg: the entry's array row), stored element-major
// as the reference's (cap, vw) matrix; a NULL array fills its row with
// the sentinel.  Simple first: a
// thread writes its row of slots with strided stores; groups of very
// different sizes leave a warp waiting on its longest run.

#include <type_traits>

#include "common.cuh"

enum { G_BOOL = 0, G_I32 = 1, G_I64 = 2, G_F64 = 3 };

struct K14Lanes {
  int n;
  int vw;  // slots per element of the last half
  const uint8_t* data[2];
  const uint8_t* valid[2];
  int kind[2];
};

template <typename T> __device__ __forceinline__ T g_sent();
template <> __device__ __forceinline__ int g_sent<int>() { return (int)0x80000000; }
template <> __device__ __forceinline__ i64 g_sent<i64>() { return I64_MIN; }
template <> __device__ __forceinline__ double g_sent<double>() {
  return __longlong_as_double(0x7ff8000000000000LL);
}

__device__ __forceinline__ bool g_null(int v) { return v == (int)0x80000000; }
__device__ __forceinline__ bool g_null(i64 v) { return v == I64_MIN; }
__device__ __forceinline__ bool g_null(double v) { return isnan(v); }

// a lane's value in the storage type T (a NULL integer or NaN as T's
// sentinel, a double into an integer truncated)
template <typename T>
__device__ __forceinline__ T g_value(const K14Lanes& l, int h, i64 row) {  // row: element index
  switch (l.kind[h]) {
    case G_BOOL: return (T)(l.data[h][row] != 0);
    case G_I32: {
      const int x = ((const int*)l.data[h])[row];
      return g_null(x) ? g_sent<T>() : (T)x;
    }
    case G_I64: {
      const i64 x = ((const i64*)l.data[h])[row];
      return g_null(x) ? g_sent<T>() : (T)x;
    }
    default: {
      const double x = ((const double*)l.data[h])[row];
      if (isnan(x)) return g_sent<T>();
      if constexpr (std::is_floating_point<T>::value) return (T)x;
      else return (T)(i64)x;
    }
  }
}

// an element of a wide half (multimap_agg's arrays) in T by a plain
// conversion, as the reference's astype: a slot's sentinel converts as
// a value (the storages only widen: an int32 or int64 array into int64
// or float64 state, a float64 array into float64)
template <typename T>
__device__ __forceinline__ T g_raw(const K14Lanes& l, int h, i64 idx) {
  switch (l.kind[h]) {
    case G_BOOL: return (T)(l.data[h][idx] != 0);
    case G_I32: return (T)((const int*)l.data[h])[idx];
    case G_I64: return (T)((const i64*)l.data[h])[idx];
    default: {
      const double x = ((const double*)l.data[h])[idx];
      if constexpr (std::is_floating_point<T>::value) return (T)x;
      else return isnan(x) ? g_sent<T>() : (T)(i64)x;
    }
  }
}

template <typename T> __device__ __forceinline__ i64 g_len(T l0) {
  if (g_null(l0)) return 0;
  const i64 l = (i64)l0;
  return l < 0 ? 0 : l;
}

template <typename T>
static __global__ void k14_collect(i64 groups, const i64* __restrict__ order,
                                   const i64* __restrict__ starts,
                                   const uint8_t* __restrict__ sel, K14Lanes l, int cap,
                                   T* __restrict__ out) {
  const i64 stride = (i64)gridDim.x * blockDim.x;
  const int last = l.n - 1;
  const i64 w = 1 + (i64)last * cap + (i64)cap * l.vw;
  for (i64 g = (i64)blockIdx.x * blockDim.x + threadIdx.x; g < groups; g += stride) {
    T* o = out + g * w;
    T* vals = o + 1 + (i64)last * cap;  // the last half: cap x vw
    i64 k = 0;
    for (i64 p = starts[g]; p < starts[g + 1] && k < cap; ++p) {
      const i64 row = order != nullptr ? order[p] : p;
      if (!sel[row]) continue;
      for (int h = 0; h < last; ++h) o[1 + h * cap + k] = g_value<T>(l, h, row);
      const bool ok = l.valid[last][row] != 0;
      if (l.vw == 1)
        vals[k] = ok ? g_value<T>(l, last, row) : g_sent<T>();
      else
        for (int c = 0; c < l.vw; ++c)
          vals[k * l.vw + c] = ok ? g_raw<T>(l, last, row * l.vw + c) : g_sent<T>();
      ++k;
    }
    o[0] = (T)k;
    for (int h = 0; h < last; ++h)
      for (i64 j = k; j < cap; ++j) o[1 + h * cap + j] = g_sent<T>();
    for (i64 j = k * l.vw; j < (i64)cap * l.vw; ++j) vals[j] = g_sent<T>();
  }
}

// One partial row's or map's element list: `halves` halves, the last
// `vw` slots per element, `cap` elements per half.
struct K14Shape {
  int halves, vw, cap;
  __device__ __forceinline__ i64 width() const { return 1 + (i64)(halves - 1) * cap + (i64)cap * vw; }
  // first slot of element j's run in half h, and its slot count
  __device__ __forceinline__ i64 at(int h, i64 j) const {
    return 1 + (i64)h * cap + (h == halves - 1 ? j * vw : j);
  }
  __device__ __forceinline__ int w(int h) const { return h == halves - 1 ? vw : 1; }
};

template <typename T>
static __global__ void k14_merge(i64 groups, const i64* __restrict__ order,
                                 const i64* __restrict__ starts,
                                 const uint8_t* __restrict__ live, const T* __restrict__ parts,
                                 K14Shape in, K14Shape os, T* __restrict__ out) {
  const i64 stride = (i64)gridDim.x * blockDim.x;
  const i64 iw = in.width(), ow = os.width();
  const int cap = os.cap;
  for (i64 g = (i64)blockIdx.x * blockDim.x + threadIdx.x; g < groups; g += stride) {
    T* o = out + g * ow;
    i64 off = 0;
    for (i64 p = starts[g]; p < starts[g + 1]; ++p) {
      const i64 row = order != nullptr ? order[p] : p;
      if (!live[row]) continue;
      const T* src = parts + row * iw;
      i64 len = g_len<T>(src[0]);
      if (len > in.cap) len = in.cap;
      for (i64 j = 0; j < len && off + j < cap; ++j)
        for (int h = 0; h < os.halves; ++h)
          for (int c = 0; c < os.w(h); ++c) o[os.at(h, off + j) + c] = src[in.at(h, j) + c];
      off += len;
    }
    const i64 k = off < cap ? off : cap;
    o[0] = (T)k;
    for (int h = 0; h < os.halves; ++h)
      for (i64 j = os.at(h, k); j < os.at(h, cap); ++j) o[j] = g_sent<T>();
  }
}

// The state of `groups` groups: out is (groups, 1 + (n_halves - 1) *
// cap + cap * vw) of the storage kind, the last half's lane (rows, vw);
// order may be null (run positions are rows).
extern "C" int k14_group_collect(i64 groups, const void* order, const void* starts,
                                 const void* sel, int n_halves, const i64* data,
                                 const i64* valid, const int* kind, int cap, int vw,
                                 int storage, void* out, void* stream) {
  if (n_halves < 1 || n_halves > 2 || cap < 1 || vw < 1 || storage < G_I32 ||
      storage > G_F64)
    return (int)cudaErrorInvalidValue;
  K14Lanes l;
  l.n = n_halves;
  l.vw = vw;
  for (int h = 0; h < n_halves; ++h) {
    if (kind[h] < G_BOOL || kind[h] > G_F64) return (int)cudaErrorInvalidValue;
    l.data[h] = (const uint8_t*)data[h];
    l.valid[h] = (const uint8_t*)valid[h];
    l.kind[h] = kind[h];
  }
  if (groups <= 0) return (int)cudaGetLastError();
  cudaStream_t s = (cudaStream_t)stream;
  const int grid = grid_for(groups, 256, 8);
  const i64* ord = (const i64*)order;
  const i64* st = (const i64*)starts;
  const uint8_t* sl = (const uint8_t*)sel;
  switch (storage) {
    case G_I32: k14_collect<int><<<grid, 256, 0, s>>>(groups, ord, st, sl, l, cap, (int*)out); break;
    case G_I64: k14_collect<i64><<<grid, 256, 0, s>>>(groups, ord, st, sl, l, cap, (i64*)out); break;
    default: k14_collect<double><<<grid, 256, 0, s>>>(groups, ord, st, sl, l, cap, (double*)out);
  }
  return (int)cudaGetLastError();
}

// Partial states, or map_union's input maps, (n, in width) of `in_cap`
// elements merged into (groups, out width) of `cap`; `n_halves` halves,
// the last `vw` slots per element.
extern "C" int k14_group_collect_merge(i64 groups, const void* order, const void* starts,
                                       const void* live, const void* parts, int n_halves,
                                       int vw, int in_cap, int cap, int storage, void* out,
                                       void* stream) {
  if (cap < 1 || in_cap < 1 || n_halves < 1 || n_halves > 2 || vw < 1 || storage < G_I32 ||
      storage > G_F64)
    return (int)cudaErrorInvalidValue;
  const K14Shape in{n_halves, vw, in_cap}, os{n_halves, vw, cap};
  if (groups <= 0) return (int)cudaGetLastError();
  cudaStream_t s = (cudaStream_t)stream;
  const int grid = grid_for(groups, 256, 8);
  const i64* ord = (const i64*)order;
  const i64* st = (const i64*)starts;
  const uint8_t* lv = (const uint8_t*)live;
  switch (storage) {
    case G_I32:
      k14_merge<int><<<grid, 256, 0, s>>>(groups, ord, st, lv, (const int*)parts, in, os,
                                          (int*)out);
      break;
    case G_I64:
      k14_merge<i64><<<grid, 256, 0, s>>>(groups, ord, st, lv, (const i64*)parts, in, os,
                                          (i64*)out);
      break;
    default:
      k14_merge<double><<<grid, 256, 0, s>>>(groups, ord, st, lv, (const double*)parts, in,
                                             os, (double*)out);
  }
  return (int)cudaGetLastError();
}
