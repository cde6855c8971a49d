// K8 join_expand: the expanding (many-to-many) probe of an inner,
// left or full join against a build with repeated keys.
//
// Replaces: presto_tpu/ops/join.py probe_expand (inner, left and the
// return_matched mask of a FULL join), _lookup_range and the matched
// mask that outer_build_tail reads, which XLA ran as searchsorted,
// cumsum and gathers into a fixed-capacity page.
//
// Bound on the H100: memory.  Pass 1 reads each probe row's key
// columns and row mask once, touches two 32-byte sectors of the
// `starts` table (or runs two binary searches over the sorted keys)
// per live row, and writes three int32 per row; the scan reads and
// writes them again.  Pass 2 writes every output column once per
// output row and reads, per output row, the probe row's columns and
// one sector of perm and of each build column.  TPC-H Q13 at SF10
// expands 1.5M customers into ~15.5M rows of four columns, ~0.3 GB:
// ~0.1 ms at 3.35 TB/s.
//
// Design: pass 1, one thread per probe row: pack the key (keys.cuh:
// exact or hashed; dead rows and, unless null_safe, NULL keys take a
// sentinel that never matches), find the match range [lo, hi) from
// starts or by a lower and an upper bound over the sorted keys, and
// write lo, m = hi - lo and the row's output count (m, or 1 for a
// live unmatched row of a left join); a warp sum and one 64-bit atomic
// per warp give the total, which the host reads once to size the
// output (count, allocate, write: no capacity retry).  The exclusive
// scan of scan.cuh turns the counts into offsets.  Pass 2 gives each
// thread one OUTPUT row (grid-stride), never one probe row, so a hot
// key that matches millions of build rows spreads over every SM: a
// binary search of the offsets finds the probe row (the reference's
// searchsorted), the rank within its range picks the build row
// (sorted position lo + rank through perm), and the row's probe and
// build columns are gathered; build columns are NULL past the match
// range (a left join's unmatched row).  The output keeps the
// reference's order: probe row first, then the build's sorted
// position.  For a FULL join, pass 2 stores 1 into a build-sized byte
// mask for every matched build row; repeated stores of 1 are benign,
// and the mask accumulates across probe pages.  Simple first: gathers
// are per element, not vectorised.

#include "gather.cuh"
#include "keys.cuh"
#include "scan.cuh"

static __global__ void k8_count(PackDesc k, i64 n, const uint8_t* __restrict__ row_mask,
                                bool null_safe, bool left, const int* __restrict__ starts,
                                i64 domain, const i64* __restrict__ sorted_keys, i64 build_cap,
                                int* __restrict__ lo_out, int* __restrict__ m_out,
                                int* __restrict__ counts,
                                unsigned long long* __restrict__ total) {
  const i64 stride = (i64)gridDim.x * blockDim.x;
  unsigned long long mine = 0;
  for (i64 i = (i64)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride) {
    const bool live = row_mask[i] != 0;
    bool ok;
    i64 key = pack_key(k, i, &ok);
    if (!(live && (ok || null_safe))) key = I64_MAX - 1;
    i64 lo, hi;
    if (starts != nullptr) {
      const bool in_dom = key >= 0 && key < domain;
      const i64 kk = key < 0 ? 0 : (key >= domain ? domain - 1 : key);
      lo = in_dom ? starts[kk] : 0;
      hi = in_dom ? starts[kk + 1] : 0;
    } else {
      lo = keys_lower_bound(sorted_keys, build_cap, key);
      hi = keys_upper_bound(sorted_keys, build_cap, key);
    }
    const int m = live ? (int)(hi - lo) : 0;
    const int c = (left && live && m == 0) ? 1 : m;
    lo_out[i] = (int)lo;
    m_out[i] = m;
    counts[i] = c;
    mine += (unsigned long long)c;
  }
  for (int o = 16; o > 0; o >>= 1) mine += __shfl_down_sync(0xffffffffu, mine, o);
  if ((threadIdx.x & 31) == 0 && mine != 0) atomicAdd(total, mine);
}

// the last probe row whose offset is <= j
__device__ __forceinline__ i64 probe_row_of(const int* __restrict__ offsets, i64 n, i64 j) {
  i64 lo = 0, hi = n;
  while (lo < hi) {
    const i64 mid = (lo + hi) >> 1;
    if ((i64)offsets[mid] <= j) lo = mid + 1;
    else hi = mid;
  }
  return lo - 1;
}

static __global__ void k8_expand(i64 n, const int* __restrict__ offsets,
                                 const int* __restrict__ lo, const int* __restrict__ m,
                                 i64 total, const int* __restrict__ perm, i64 build_cap,
                                 GatherCols cols, int n_probe,
                                 uint8_t* __restrict__ matched_mask) {
  const i64 stride = (i64)gridDim.x * blockDim.x;
  for (i64 j = (i64)blockIdx.x * blockDim.x + threadIdx.x; j < total; j += stride) {
    const i64 p = probe_row_of(offsets, n, j);
    const i64 rank = j - offsets[p];
    const bool matched = rank < m[p];
    i64 pos = lo[p] + rank;
    pos = pos < 0 ? 0 : (pos >= build_cap ? build_cap - 1 : pos);
    const i64 b_row = matched ? perm[pos] : 0;
    gather_row(cols, 0, n_probe, p, j, true);
    gather_row(cols, n_probe, cols.n, b_row, j, matched);
    if (matched && matched_mask != nullptr) matched_mask[b_row] = 1;
  }
}

// Pass 1 and the scan over n probe rows.  starts (domain + 1 ints) may
// be null: then the sorted keys are searched.  lo, m: n ints; offsets:
// n + 1 ints (the exclusive scan of the counts, int32 total at [n]);
// partials: scan_tiles(n) + 1 ints; total: one 64-bit count.
extern "C" int k8_join_count(i64 n, const void* row_mask, int n_keys, const i64* key_data,
                             const i64* key_valid, const int* key_kind, const i64* key_lo,
                             const i64* key_card, int null_safe, int left,
                             const void* starts, i64 domain, const void* sorted_keys,
                             i64 build_cap, void* lo, void* m, void* offsets, void* partials,
                             void* total, void* stream) {
  PackDesc k;
  if (fill_pack_desc(&k, n_keys, key_data, key_valid, key_kind, key_lo, key_card) ||
      build_cap < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  cudaMemsetAsync(total, 0, sizeof(unsigned long long), s);
  if (n > 0)
    k8_count<<<grid_for(n, 256, 8), 256, 0, s>>>(
        k, n, (const uint8_t*)row_mask, null_safe != 0, left != 0, (const int*)starts,
        domain, (const i64*)sorted_keys, build_cap, (int*)lo, (int*)m, (int*)offsets,
        (unsigned long long*)total);
  scan_exclusive_inplace((int*)offsets, n, (int*)partials, s);
  return (int)cudaGetLastError();
}

// Pass 2: `total` output rows of n_cols columns, the first n_probe of
// them gathered from the probe row, the rest from the build row;
// matched (build_cap bytes) may be null.
extern "C" int k8_join_expand(i64 n, const void* offsets, const void* lo, const void* m,
                              i64 total, const void* perm, i64 build_cap, int n_cols,
                              int n_probe, const i64* src, const i64* src_valid,
                              const i64* dst, const i64* dst_valid, const int* width,
                              void* matched, void* stream) {
  GatherCols cols;
  if (fill_gather_cols(&cols, n_cols, src, src_valid, dst, dst_valid, width) ||
      n_probe < 0 || n_probe > n_cols || build_cap < 1)
    return (int)cudaErrorInvalidValue;
  if (total > 0)
    k8_expand<<<grid_for(total, 256, 8), 256, 0, (cudaStream_t)stream>>>(
        n, (const int*)offsets, (const int*)lo, (const int*)m, total, (const int*)perm,
        build_cap, cols, n_probe, (uint8_t*)matched);
  return (int)cudaGetLastError();
}
