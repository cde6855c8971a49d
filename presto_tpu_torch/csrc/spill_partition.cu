// K11 spill_partition: the spill write's partition of one page into K
// host buckets by its key.
//
// Replaces: presto_tpu/exec/spill.py make_bucket_fn (the bucket of each
// row: pack_or_hash_keys, a remix, mod K) and partition_to_host (the
// stable split of the page by bucket, np.nonzero per bucket, and the
// gathers of every column into per-bucket host arrays).
//
// Bound on the H100: memory.  Pass 1 reads each row's key columns and
// row mask once and writes a 4-byte bucket id; pass 3 reads the ids
// again and writes one 4-byte row index per live row.  The histogram
// and scan touch K x blocks int32s (K <= 256, one block per 4096 rows):
// ~0.5 MB at 2^23 rows and K = 64.  A 2^23-row lineitem split keyed by
// l_orderkey moves ~8 B of key, 1 B of mask and 4 B of row index per
// row: ~0.03 ms at 3.35 TB/s.  The gather then reads each live row's
// columns through the permutation and writes them contiguously, and
// the device-to-host copy of that buffer is bounded by PCIe, not by
// this kernel.
//
// Design: pass 1 (k11_bucket), one block per tile of 4096 rows: each
// live row's key is packed exactly or hashed (keys.cuh, as K4, K6 and
// K9 pack it), remixed as the reference does (h ^= h >> 33;
// h *= 0xFF51AFD7ED558CCD; h ^= h >> 33, unsigned 64-bit) and reduced
// mod K; a dead row takes bucket -1.  The block counts its rows per
// bucket in shared memory and writes the counts bucket-major
// (counts[b * blocks + block]).  Pass 2: the exclusive scan of scan.cuh
// over those counts gives every (bucket, block) pair its first output
// position, so bucket b's rows are contiguous and in block order.
// Pass 3 (k11_scatter) walks the block's tile again in rounds of 256
// rows, row order = round, then thread: within a warp a row's rank
// among earlier lanes of its bucket comes from __match_any_sync and a
// popcount; each warp's count per bucket goes to shared memory, and a
// row adds the counts of the warps before it and the block's running
// count of its bucket.  Each bucket's rows therefore keep page order,
// which is the reference's np.nonzero order.  A fourth launch writes
// the int64 count of each bucket.  k11_gather copies each column's
// live rows through the permutation (gather.cuh) into one contiguous
// device buffer, which the wrapper copies to pinned host memory in one
// transfer.  Simple first: the scatter's per-round shared-memory
// tables are cleared every round.

#include "gather.cuh"
#include "keys.cuh"
#include "scan.cuh"

#define K11_THREADS 256
#define K11_ROUNDS 16
#define K11_TILE (K11_THREADS * K11_ROUNDS)
#define K11_WARPS (K11_THREADS / 32)
#define K11_MAX_BUCKETS 256

__device__ __forceinline__ int k11_bucket_of(u64 h, u64 num_buckets) {
  h ^= h >> 33;
  h *= 0xFF51AFD7ED558CCDull;
  h ^= h >> 33;
  return (int)(h % num_buckets);
}

static __global__ void __launch_bounds__(K11_THREADS)
    k11_bucket(PackDesc k, int has_keys, i64 n, const uint8_t* __restrict__ row_mask,
               int num_buckets, int* __restrict__ bids, int* __restrict__ block_counts) {
  __shared__ int hist[K11_MAX_BUCKETS];
  for (int b = threadIdx.x; b < num_buckets; b += blockDim.x) hist[b] = 0;
  __syncthreads();
  const i64 base = (i64)blockIdx.x * K11_TILE;
  for (int r = 0; r < K11_ROUNDS; ++r) {
    const i64 i = base + (i64)r * K11_THREADS + threadIdx.x;
    if (i >= n) break;
    int b = -1;
    if (row_mask[i] != 0) {
      u64 h = 0;
      if (has_keys) {
        bool ok;  // a NULL key buckets by its NULL code or NULL lane
        h = (u64)pack_key(k, i, &ok);
      }
      b = k11_bucket_of(h, (u64)num_buckets);
      atomicAdd(&hist[b], 1);
    }
    bids[i] = b;
  }
  __syncthreads();
  for (int b = threadIdx.x; b < num_buckets; b += blockDim.x)
    block_counts[(i64)b * gridDim.x + blockIdx.x] = hist[b];
}

static __global__ void __launch_bounds__(K11_THREADS)
    k11_scatter(i64 n, const int* __restrict__ bids, int num_buckets,
                const int* __restrict__ offsets, int* __restrict__ perm) {
  __shared__ int running[K11_MAX_BUCKETS];
  __shared__ int warp_counts[K11_WARPS][K11_MAX_BUCKETS];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int b = threadIdx.x; b < num_buckets; b += blockDim.x)
    running[b] = offsets[(i64)b * gridDim.x + blockIdx.x];
  const i64 base = (i64)blockIdx.x * K11_TILE;
  for (int r = 0; r < K11_ROUNDS; ++r) {
    const i64 round_base = base + (i64)r * K11_THREADS;
    if (round_base >= n) break;  // the same for every thread of the block
    for (int j = threadIdx.x; j < K11_WARPS * num_buckets; j += blockDim.x)
      warp_counts[j / num_buckets][j % num_buckets] = 0;
    __syncthreads();
    const i64 i = round_base + threadIdx.x;
    const int b = i < n ? bids[i] : -1;
    const unsigned peers = __match_any_sync(0xffffffffu, b);
    const int rank = __popc(peers & ((1u << lane) - 1u));
    if (b >= 0 && rank == 0) warp_counts[warp][b] = __popc(peers);
    __syncthreads();
    if (b >= 0) {
      int pos = running[b] + rank;
      for (int w = 0; w < warp; ++w) pos += warp_counts[w][b];
      perm[pos] = (int)i;
    }
    __syncthreads();
    for (int bb = threadIdx.x; bb < num_buckets; bb += blockDim.x) {
      int s = 0;
      for (int w = 0; w < K11_WARPS; ++w) s += warp_counts[w][bb];
      running[bb] += s;
    }
    __syncthreads();
  }
}

static __global__ void k11_counts(const int* __restrict__ offsets, int num_buckets,
                                  i64 blocks, i64* __restrict__ counts) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b < num_buckets)
    counts[b] = (i64)offsets[(i64)(b + 1) * blocks] - (i64)offsets[(i64)b * blocks];
}

static __global__ void k11_gather(GatherCols cols, i64 total, const int* __restrict__ perm) {
  const i64 stride = (i64)gridDim.x * blockDim.x;
  for (i64 i = (i64)blockIdx.x * blockDim.x + threadIdx.x; i < total; i += stride)
    gather_row(cols, 0, cols.n, perm[i], i, true);
}

// Scratch sizes for n rows and K buckets: block_counts holds
// K * blocks + 1 ints, partials scan_tiles(K * blocks) + 1 ints.
extern "C" i64 k11_blocks(i64 n) { return n < 1 ? 1 : (n + K11_TILE - 1) / K11_TILE; }

extern "C" i64 k11_scan_partials(i64 m) { return scan_tiles(m) + 1; }

// The bucket of each of n rows into bids (n ints, -1 for a dead row),
// the live rows' indices grouped by bucket, each bucket in row order,
// into perm (n ints; the first sum(counts) are set), and each
// bucket's row count into counts (K int64).  n_keys = 0 puts every
// live row in bucket 0.
extern "C" int k11_spill_partition(i64 n, const void* row_mask, int n_keys,
                                   const i64* key_data, const i64* key_valid,
                                   const int* key_kind, const i64* key_lo,
                                   const i64* key_card, int num_buckets, void* bids,
                                   void* block_counts, void* partials, void* perm,
                                   void* counts, void* stream) {
  PackDesc k;
  k.n = 0;
  k.hashed = 0;
  if (n_keys > 0 &&
      fill_pack_desc(&k, n_keys, key_data, key_valid, key_kind, key_lo, key_card))
    return (int)cudaErrorInvalidValue;
  if (num_buckets < 1 || num_buckets > K11_MAX_BUCKETS || n < 1 || n >= (1ll << 31))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const i64 blocks = k11_blocks(n);
  const i64 m = (i64)num_buckets * blocks;
  k11_bucket<<<(unsigned)blocks, K11_THREADS, 0, s>>>(k, n_keys > 0, n,
                                                      (const uint8_t*)row_mask, num_buckets,
                                                      (int*)bids, (int*)block_counts);
  scan_exclusive_inplace((int*)block_counts, m, (int*)partials, s);
  k11_scatter<<<(unsigned)blocks, K11_THREADS, 0, s>>>(n, (const int*)bids, num_buckets,
                                                       (const int*)block_counts, (int*)perm);
  k11_counts<<<(num_buckets + 255) / 256, 256, 0, s>>>((const int*)block_counts, num_buckets,
                                                       blocks, (i64*)counts);
  return (int)cudaGetLastError();
}

// Row perm[i] of each of n_cols columns into row i of its destination,
// for i < total.
extern "C" int k11_gather_columns(i64 total, const void* perm, int n_cols, const i64* src,
                                  const i64* src_valid, const i64* dst, const i64* dst_valid,
                                  const int* width, void* stream) {
  GatherCols cols;
  if (fill_gather_cols(&cols, n_cols, src, src_valid, dst, dst_valid, width))
    return (int)cudaErrorInvalidValue;
  if (total > 0)
    k11_gather<<<grid_for(total, 256, 8), 256, 0, (cudaStream_t)stream>>>(cols, total,
                                                                       (const int*)perm);
  return (int)cudaGetLastError();
}
