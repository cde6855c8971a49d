// K21 exchange_partition: a page's rows scattered into n_parts
// contiguous buckets of bucket_cap rows, by the partition of their key.
//
// Replaces: presto_tpu/parallel/exchange.py partition_targets :36 (after
// the packed key: the target _mix64(key) % n as unsigned 64-bit, a dead
// row sent to n) and partition_for_exchange :59 (a stable argsort of the
// targets, each row's slot in its run, the drop past bucket_cap, the
// scatter of every column, the valid bits and the row mask into the
// n_parts x bucket_cap page, and fill, the largest bucket's count).
//
// Bound on the H100: memory.  The first pass reads each row's 8-byte
// key and its mask byte and writes a 4-byte target; the scatter reads
// the target again and moves every column once (data and valid) into
// the zeroed output.  A 2^23-row lineitem split of ~60 bytes a row at 8
// parts moves ~0.5 GB: ~0.15 ms at 3.35 TB/s.  The histogram and the
// scan touch n_parts x blocks int32s (one block per 4096 rows), a few
// KB.
//
// Design: the reference's argsort is stable, so inside a bucket the
// rows keep page order and the rows dropped past bucket_cap are the
// later ones; the double sums of the merge after the exchange depend
// on that order, so this layout is bit for bit the reference's.  Pass 1
// (k21_target), one block per tile of 4096 rows, computes each row's
// target and counts the block's rows per target in shared memory,
// written target-major (counts[t * blocks + block]).  Pass 2 is the
// exclusive scan of scan.cuh over those counts (deterministic, integer
// adds), which gives every (target, block) pair its first slot in the
// target's run once the run's start is subtracted.  Pass 3
// (k21_scatter) walks the tile again in rounds of 256 rows, row order
// = round, then thread: within a warp a row's rank among the earlier
// lanes of its target comes from __match_any_sync and a popcount, the
// warps' counts per target go to shared memory, and a row adds the
// counts of the warps before it and the block's running count of its
// target (K11's stable rank).  A row whose slot is below bucket_cap is
// copied to target * bucket_cap + slot through the column table of
// gather.cuh; the wrapper zeroes the output first, so a slot no row
// fills is 0 with valid and mask false, as the reference's zeros are.
// A last one-block launch reads each target's count off the scan and
// writes their maximum, fill.  Simple first: the per-round tables are
// cleared every round, and the scatter's writes are scattered 1-, 4- or
// 8-byte stores.

#include "gather.cuh"
#include "scan.cuh"

#define K21_THREADS 256
#define K21_ROUNDS 16
#define K21_TILE (K21_THREADS * K21_ROUNDS)
#define K21_WARPS (K21_THREADS / 32)
#define K21_MAX_PARTS 256

// splitmix64's finalizer, the reference's _mix64, in unsigned 64-bit
__device__ __forceinline__ u64 k21_mix64(u64 x) {
  x = (x ^ (x >> 30)) * 0xBF58476D1CE4E5B9ull;
  x = (x ^ (x >> 27)) * 0x94D049BB133111EBull;
  return x ^ (x >> 31);
}

static __global__ void __launch_bounds__(K21_THREADS)
    k21_target(i64 n, const i64* __restrict__ key, const uint8_t* __restrict__ row_mask,
               int n_parts, int* __restrict__ targets, int* __restrict__ block_counts) {
  // key null: the targets are given (partition_for_exchange's input)
  __shared__ int hist[K21_MAX_PARTS];
  for (int t = threadIdx.x; t < n_parts; t += blockDim.x) hist[t] = 0;
  __syncthreads();
  const i64 base = (i64)blockIdx.x * K21_TILE;
  for (int r = 0; r < K21_ROUNDS; ++r) {
    const i64 i = base + (i64)r * K21_THREADS + threadIdx.x;
    if (i >= n) break;
    int t = n_parts;  // a dead row goes nowhere
    if (key == nullptr) {
      t = targets[i];
      if (t < 0 || t > n_parts) t = n_parts;
    } else if (row_mask[i] != 0) {
      t = (int)(k21_mix64((u64)key[i]) % (u64)n_parts);
    }
    if (t < n_parts) atomicAdd(&hist[t], 1);
    targets[i] = t;
  }
  __syncthreads();
  for (int t = threadIdx.x; t < n_parts; t += blockDim.x)
    block_counts[(i64)t * gridDim.x + blockIdx.x] = hist[t];
}

static __global__ void __launch_bounds__(K21_THREADS)
    k21_scatter(i64 n, const int* __restrict__ targets, int n_parts,
                const int* __restrict__ offsets, i64 bucket_cap, GatherCols cols,
                const uint8_t* __restrict__ row_mask, uint8_t* __restrict__ out_mask) {
  __shared__ int running[K21_MAX_PARTS];
  __shared__ int warp_counts[K21_WARPS][K21_MAX_PARTS];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  // the block's first slot in each target's run
  for (int t = threadIdx.x; t < n_parts; t += blockDim.x)
    running[t] = offsets[(i64)t * gridDim.x + blockIdx.x] - offsets[(i64)t * gridDim.x];
  const i64 base = (i64)blockIdx.x * K21_TILE;
  for (int r = 0; r < K21_ROUNDS; ++r) {
    const i64 round_base = base + (i64)r * K21_THREADS;
    if (round_base >= n) break;  // the same for every thread of the block
    for (int j = threadIdx.x; j < K21_WARPS * n_parts; j += blockDim.x)
      warp_counts[j / n_parts][j % n_parts] = 0;
    __syncthreads();
    const i64 i = round_base + threadIdx.x;
    const int t = i < n ? targets[i] : n_parts;
    const bool live = t < n_parts;
    const unsigned peers = __match_any_sync(0xffffffffu, live ? t : -1);
    const int rank = __popc(peers & ((1u << lane) - 1u));
    if (live && rank == 0) warp_counts[warp][t] = __popc(peers);
    __syncthreads();
    if (live) {
      i64 slot = (i64)running[t] + rank;
      for (int w = 0; w < warp; ++w) slot += warp_counts[w][t];
      if (slot < bucket_cap) {
        const i64 dest = (i64)t * bucket_cap + slot;
        gather_row(cols, 0, cols.n, i, dest, true);
        if (out_mask != nullptr) out_mask[dest] = row_mask[i];
      }
    }
    __syncthreads();
    for (int tt = threadIdx.x; tt < n_parts; tt += blockDim.x) {
      int s = 0;
      for (int w = 0; w < K21_WARPS; ++w) s += warp_counts[w][tt];
      running[tt] += s;
    }
    __syncthreads();
  }
}

// one block: each target's count off the scan, and their maximum
static __global__ void k21_fill(const int* __restrict__ offsets, int n_parts, i64 blocks,
                                int* __restrict__ fill) {
  __shared__ int best;
  if (threadIdx.x == 0) best = 0;
  __syncthreads();
  for (int t = threadIdx.x; t < n_parts; t += blockDim.x)
    atomicMax(&best, offsets[(i64)(t + 1) * blocks] - offsets[(i64)t * blocks]);
  __syncthreads();
  if (threadIdx.x == 0) *fill = best;
}

// Scratch sizes for n rows and n_parts targets: block_counts holds
// n_parts * blocks + 1 ints, partials scan_tiles(n_parts * blocks) + 1.
extern "C" i64 k21_blocks(i64 n) { return n < 1 ? 1 : (n + K21_TILE - 1) / K21_TILE; }

extern "C" i64 k21_scan_partials(i64 m) { return scan_tiles(m) + 1; }

// The target of each of n rows into targets (n ints; n_parts for a dead
// row), from its key, or read from targets where key is null (a target
// outside [0, n_parts) goes nowhere); the per-(target, block) slots
// into block_counts (scanned in place) and the largest target count
// into fill (one int).
extern "C" int k21_exchange_targets(i64 n, const void* key, const void* row_mask, int n_parts,
                                    void* targets, void* block_counts, void* partials,
                                    void* fill, void* stream) {
  if (n_parts < 1 || n_parts > K21_MAX_PARTS || n < 1 || n >= (1ll << 31))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const i64 blocks = k21_blocks(n);
  const i64 m = (i64)n_parts * blocks;
  k21_target<<<(unsigned)blocks, K21_THREADS, 0, s>>>(n, (const i64*)key,
                                                      (const uint8_t*)row_mask, n_parts,
                                                      (int*)targets, (int*)block_counts);
  scan_exclusive_inplace((int*)block_counts, m, (int*)partials, s);
  k21_fill<<<1, 256, 0, s>>>((const int*)block_counts, n_parts, blocks, (int*)fill);
  return (int)cudaGetLastError();
}

// Each row with a target of n_cols columns into slot target *
// bucket_cap + its rank in its target's run, when the rank is below
// bucket_cap; its row_mask byte too where out_mask is not null.  The
// destinations must be zeroed.
extern "C" int k21_exchange_scatter(i64 n, const void* targets, int n_parts,
                                    const void* block_counts, i64 bucket_cap, int n_cols,
                                    const i64* src, const i64* src_valid, const i64* dst,
                                    const i64* dst_valid, const int* width,
                                    const void* row_mask, void* out_mask, void* stream) {
  GatherCols cols;
  if (fill_gather_cols(&cols, n_cols, src, src_valid, dst, dst_valid, width))
    return (int)cudaErrorInvalidValue;
  if (n_parts < 1 || n_parts > K21_MAX_PARTS || n < 1 || n >= (1ll << 31) || bucket_cap < 0)
    return (int)cudaErrorInvalidValue;
  if (bucket_cap == 0) return (int)cudaGetLastError();
  k21_scatter<<<(unsigned)k21_blocks(n), K21_THREADS, 0, (cudaStream_t)stream>>>(
      n, (const int*)targets, n_parts, (const int*)block_counts, bucket_cap, cols,
      (const uint8_t*)row_mask, (uint8_t*)out_mask);
  return (int)cudaGetLastError();
}
