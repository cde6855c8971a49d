// Device-wide exclusive prefix scan, shared by the join build (K4), the
// sorted-group aggregation (K6) and the window functions (K10): int32
// counts, and unsigned 64-bit sums (int64 that wrap, as the
// reference's int64 cumsum does).
//
// Reduce-then-scan in three launches: each tile of SCAN_TILE values
// sums to one partial; one block scans the partials (carrying a
// running total across chunks); each tile then scans itself and adds
// its partial's prefix.  Block-level sums and scans are CUB's
// BlockReduce/BlockScan inside these kernels.  Integer adds, so the
// result does not depend on the order of the partial sums.
#pragma once

#include <cub/block/block_reduce.cuh>
#include <cub/block/block_scan.cuh>

#include "common.cuh"

#define SCAN_THREADS 256
#define SCAN_ITEMS 8
#define SCAN_TILE (SCAN_THREADS * SCAN_ITEMS)

static inline i64 scan_tiles(i64 m) { return (m + SCAN_TILE - 1) / SCAN_TILE; }

template <typename T>
static __global__ void scan_tile_sums(const T* __restrict__ data, i64 m,
                                      T* __restrict__ tile_sums) {
  typedef cub::BlockReduce<T, SCAN_THREADS> Reduce;
  __shared__ typename Reduce::TempStorage tmp;
  const i64 base = (i64)blockIdx.x * SCAN_TILE + (i64)threadIdx.x * SCAN_ITEMS;
  T s = 0;
  for (int j = 0; j < SCAN_ITEMS; ++j)
    if (base + j < m) s += data[base + j];
  const T total = Reduce(tmp).Sum(s);
  if (threadIdx.x == 0) tile_sums[blockIdx.x] = total;
}

// one block: exclusive scan of the tile sums in place, total at [n]
template <typename T>
static __global__ void scan_partials(T* __restrict__ sums, i64 n) {
  typedef cub::BlockScan<T, SCAN_THREADS> Scan;
  __shared__ typename Scan::TempStorage tmp;
  __shared__ T carry;
  if (threadIdx.x == 0) carry = 0;
  __syncthreads();
  for (i64 base = 0; base < n; base += SCAN_THREADS) {
    const i64 i = base + threadIdx.x;
    const T x = i < n ? sums[i] : 0;
    T excl, chunk;
    Scan(tmp).ExclusiveSum(x, excl, chunk);
    if (i < n) sums[i] = carry + excl;
    __syncthreads();
    if (threadIdx.x == 0) carry += chunk;
    __syncthreads();
  }
  if (threadIdx.x == 0) sums[n] = carry;
}

template <typename T>
static __global__ void scan_tiles_apply(T* __restrict__ data, i64 m,
                                        const T* __restrict__ prefix) {
  typedef cub::BlockScan<T, SCAN_THREADS> Scan;
  __shared__ typename Scan::TempStorage tmp;
  const i64 base = (i64)blockIdx.x * SCAN_TILE + (i64)threadIdx.x * SCAN_ITEMS;
  T x[SCAN_ITEMS];
  T s = 0;
  for (int j = 0; j < SCAN_ITEMS; ++j) {
    x[j] = base + j < m ? data[base + j] : 0;
    s += x[j];
  }
  T excl;
  Scan(tmp).ExclusiveSum(s, excl);
  T run = prefix[blockIdx.x] + excl;
  for (int j = 0; j < SCAN_ITEMS; ++j) {
    if (base + j < m) data[base + j] = run;
    run += x[j];
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) data[m] = prefix[gridDim.x];
}

// data[0..m) becomes its exclusive prefix sum and data[m] the total;
// partials holds scan_tiles(m) + 1 values of T.
template <typename T>
static inline void scan_exclusive_inplace(T* data, i64 m, T* partials, cudaStream_t stream) {
  const i64 tiles = scan_tiles(m);
  if (tiles == 0) {
    cudaMemsetAsync(data, 0, sizeof(T), stream);
    return;
  }
  scan_tile_sums<T><<<(unsigned)tiles, SCAN_THREADS, 0, stream>>>(data, m, partials);
  scan_partials<T><<<1, SCAN_THREADS, 0, stream>>>(partials, tiles);
  scan_tiles_apply<T><<<(unsigned)tiles, SCAN_THREADS, 0, stream>>>(data, m, partials);
}
