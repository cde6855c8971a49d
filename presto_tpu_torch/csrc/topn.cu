// K7 topn: the first n rows of a page under ORDER BY, without sorting
// the page.
//
// Replaces: presto_tpu/ops/sort.py topn_page (sort_perm's stable
// argsorts from the least significant key up, then the first n rows)
// and the fold of presto_tpu/exec/local.py _run_topn.
//
// Bound on the H100: memory.  The key columns, their valid bits and
// the row mask are read once; the output is n row ids.  TPC-H Q3 at
// SF10 ranks ~10^5 groups on a decimal(36,4) key (16 B) and a date
// (4 B): ~2.5 MB, under a microsecond at 3.35 TB/s, so a launch costs
// more than the bytes.
//
// Design: rows compare under one total order, the reference's: dead
// rows never qualify; then key by key, the null rank (NULLs first or
// last) and the value's lanes (a long decimal's two limbs, high limb
// first; descending keys reverse the comparison; a double compares
// by an int64 key that reproduces XLA's float order); then the row
// position, which is how the stable sorts break ties.  Each thread
// keeps its n best rows sorted in a list of row ids in shared memory
// (insertion); a block merges its threads' lists pairwise in shared
// memory (log2 steps) and writes its n best; a second launch of one
// block merges the blocks' lists the same way.  n is at most K7_MAX_N
// = 100 (TPC-H's LIMIT 100; kernels/topn.py raises above it): 64
// threads a block keep 64 lists of 100 int32 row ids, 25 KB,
// inside the 48 KB of static shared memory (128 threads would need
// 51 KB).  A merge step's output list lives in local memory.  A REAL
// key orders as its exact double; a SMALLINT or TINYINT key reads
// sign-extended.  A wide decimal key (decimal(37..38)) compares its
// five limbs, limb 0 first, as a long one its two, and a raw varchar
// key its k pack_lanes lanes (k = ceil(W / 8), up to K7_MAX_LANES),
// which compare as signed int64 in the bytes' order; ties on every
// lane are equal strings, left to the next key and the row position.
// Each comparison of two raw keys reads up to k lanes of both rows
// from device memory (the candidates' keys are not staged), so strings
// sharing long prefixes cost more reads a comparison.  Past K7_MAX_N rows
// the port sorts the page instead (ops/sort.py topn_page: torch.sort,
// then the first n live rows), as the reference's topn_page always
// does.

#include "common.cuh"

#define K7_MAX_N 100
#define K7_MAX_KEYS 16
#define K7_THREADS 64
#define K7_MAX_LANES 128

// TK_LANES: a key of width[c] int64 lanes compared as signed int64, lane 0
// first (a long decimal's two limbs, a wide one's five, a raw varchar's k)
enum { TK_BOOL = 0, TK_I32 = 1, TK_I64 = 2, TK_LANES = 3, TK_F64 = 4, TK_I16 = 5, TK_I8 = 6,
       TK_F32 = 7 };

struct K7Keys {
  int n_keys;
  const void* data[K7_MAX_KEYS];
  const uint8_t* valid[K7_MAX_KEYS];
  int kind[K7_MAX_KEYS];
  int width[K7_MAX_KEYS];  // TK_LANES: its lanes a row; else 1
  int asc[K7_MAX_KEYS];
  int nulls_first[K7_MAX_KEYS];
};

// a double key as an int64 in ascending order (kernels/topn.py
// double_sort_key): negated when descending, -0.0 as 0.0, every NaN
// last, the bits of a negative double flipped below zero
__device__ __forceinline__ i64 double_key(double x, bool asc) {
  if (!asc) x = -x;
  if (x != x) return I64_MAX;
  if (x == 0.0) return 0;
  const i64 b = __double_as_longlong(x);
  return b < 0 ? b ^ I64_MAX : b;
}

__device__ __forceinline__ i64 lane(const K7Keys& k, int c, int j, i64 row) {
  switch (k.kind[c]) {
    case TK_BOOL: return ((const uint8_t*)k.data[c])[row] != 0;
    case TK_I32: return ((const int*)k.data[c])[row];
    case TK_I64: return ((const i64*)k.data[c])[row];
    case TK_F64: return double_key(((const double*)k.data[c])[row], k.asc[c] != 0);
    case TK_F32:  // a REAL orders as its exact double
      return double_key((double)((const float*)k.data[c])[row], k.asc[c] != 0);
    case TK_I16: return ((const short*)k.data[c])[row];
    case TK_I8: return ((const signed char*)k.data[c])[row];
    default: return ((const i64*)k.data[c])[k.width[c] * row + j];  // TK_LANES
  }
}

// true when row a comes before row b
__device__ __forceinline__ bool before(const K7Keys& k, i64 a, i64 b) {
  for (int c = 0; c < k.n_keys; ++c) {
    const bool va = k.valid[c][a] != 0, vb = k.valid[c][b] != 0;
    const int ra = k.nulls_first[c] ? (va ? 1 : 0) : (va ? 0 : 1);
    const int rb = k.nulls_first[c] ? (vb ? 1 : 0) : (vb ? 0 : 1);
    if (ra != rb) return ra < rb;
    for (int j = 0; j < k.width[c]; ++j) {
      const i64 xa = lane(k, c, j, a), xb = lane(k, c, j, b);
      // a double's key is already in ascending order
      if (xa != xb)
        return k.asc[c] || k.kind[c] == TK_F64 || k.kind[c] == TK_F32 ? xa < xb : xa > xb;
    }
  }
  return a < b;
}

// merge two sorted lists (counts ca, cb) into out, keeping n
__device__ __forceinline__ int merge_lists(const K7Keys& k, const int* a, int ca,
                                           const int* b, int cb, int* out, int n) {
  int i = 0, j = 0, c = 0;
  while (c < n && (i < ca || j < cb)) {
    if (j >= cb || (i < ca && before(k, a[i], b[j]))) out[c++] = a[i++];
    else out[c++] = b[j++];
  }
  return c;
}

// Pairwise merge of the block's lists in shared memory: list t holds
// cnt[t] sorted rows at lists[t * n]; the block's best n end in list 0.
__device__ void block_merge(const K7Keys& k, int* lists, int* cnt, int n) {
  int tmp[K7_MAX_N];
  for (int stride = K7_THREADS / 2; stride > 0; stride >>= 1) {
    __syncthreads();
    const int t = threadIdx.x;
    int c = 0;
    if (t < stride)
      c = merge_lists(k, lists + t * n, cnt[t], lists + (t + stride) * n, cnt[t + stride],
                      tmp, n);
    __syncthreads();
    if (t < stride) {
      for (int i = 0; i < c; ++i) lists[t * n + i] = tmp[i];
      cnt[t] = c;
    }
  }
  __syncthreads();
}

static __global__ void k7_blocks(K7Keys k, i64 rows, const uint8_t* __restrict__ row_mask,
                                 int n, int* __restrict__ cand, int* __restrict__ cand_cnt) {
  __shared__ int lists[K7_THREADS * K7_MAX_N];
  __shared__ int cnt[K7_THREADS];
  int* mine = lists + threadIdx.x * n;
  int c = 0;
  const i64 stride = (i64)gridDim.x * blockDim.x;
  for (i64 r = (i64)blockIdx.x * blockDim.x + threadIdx.x; r < rows; r += stride) {
    if (!row_mask[r]) continue;
    if (c == n && !before(k, r, mine[n - 1])) continue;
    int p = c < n ? c++ : n - 1;  // insertion from the end
    while (p > 0 && before(k, r, mine[p - 1])) {
      mine[p] = mine[p - 1];
      --p;
    }
    mine[p] = (int)r;
  }
  cnt[threadIdx.x] = c;
  block_merge(k, lists, cnt, n);
  if (threadIdx.x == 0) {
    for (int i = 0; i < cnt[0]; ++i) cand[blockIdx.x * n + i] = lists[i];
    cand_cnt[blockIdx.x] = cnt[0];
  }
}

static __global__ void k7_final(K7Keys k, int blocks, int n, const int* __restrict__ cand,
                                const int* __restrict__ cand_cnt, int* __restrict__ out,
                                int* __restrict__ out_cnt) {
  __shared__ int lists[K7_THREADS * K7_MAX_N];
  __shared__ int cnt[K7_THREADS];
  int tmp[K7_MAX_N];
  int* mine = lists + threadIdx.x * n;
  int c = 0;
  for (int b = threadIdx.x; b < blocks; b += blockDim.x) {  // fold this thread's lists
    const int m = merge_lists(k, mine, c, cand + b * n, cand_cnt[b], tmp, n);
    for (int i = 0; i < m; ++i) mine[i] = tmp[i];
    c = m;
  }
  cnt[threadIdx.x] = c;
  block_merge(k, lists, cnt, n);
  if (threadIdx.x == 0) {
    for (int i = 0; i < n; ++i) out[i] = i < cnt[0] ? lists[i] : 0;
    *out_cnt = cnt[0];
  }
}

// The first n (<= K7_MAX_N) live rows of `rows` under the keys' order:
// out[0..*out_cnt) row ids.  cand: blocks * n ints, cand_cnt: blocks
// ints of scratch.
extern "C" int k7_topn(i64 rows, const void* row_mask, int n_keys, const i64* data,
                       const i64* valid, const int* kind, const int* width, const int* asc,
                       const int* nulls_first, int n, int blocks, void* cand, void* cand_cnt,
                       void* out, void* out_cnt, void* stream) {
  if (n_keys > K7_MAX_KEYS || n < 1 || n > K7_MAX_N || blocks < 1)
    return (int)cudaErrorInvalidValue;
  K7Keys k;
  k.n_keys = n_keys;
  for (int c = 0; c < n_keys; ++c) {
    k.data[c] = (const void*)data[c];
    k.valid[c] = (const uint8_t*)valid[c];
    k.kind[c] = kind[c];
    k.width[c] = width[c];
    if (width[c] < 1 || width[c] > K7_MAX_LANES) return (int)cudaErrorInvalidValue;
    k.asc[c] = asc[c];
    k.nulls_first[c] = nulls_first[c];
  }
  cudaStream_t s = (cudaStream_t)stream;
  k7_blocks<<<blocks, K7_THREADS, 0, s>>>(k, rows, (const uint8_t*)row_mask, n, (int*)cand,
                                          (int*)cand_cnt);
  k7_final<<<1, K7_THREADS, 0, s>>>(k, blocks, n, (const int*)cand, (const int*)cand_cnt,
                                    (int*)out, (int*)out_cnt);
  return (int)cudaGetLastError();
}
