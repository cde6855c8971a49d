// Column gathers shared by the join probes (K5, K8): each column is a
// data array of 1-, 4-, 8- or 16-byte elements (16: two int64 limbs)
// and a byte validity array.
#pragma once

#include "common.cuh"

#define GATHER_MAX_COLS 64

struct GatherCols {
  int n;
  const uint8_t* src[GATHER_MAX_COLS];
  const uint8_t* src_valid[GATHER_MAX_COLS];
  uint8_t* dst[GATHER_MAX_COLS];
  uint8_t* dst_valid[GATHER_MAX_COLS];
  int width[GATHER_MAX_COLS];  // bytes per element: 1, 4, 8 or 16
};

__device__ __forceinline__ void copy_elem(const uint8_t* src, uint8_t* dst, int width,
                                          i64 from, i64 to, bool keep) {
  switch (width) {
    case 1: dst[to] = keep ? src[from] : 0; break;
    case 4: ((int*)dst)[to] = keep ? ((const int*)src)[from] : 0; break;
    case 8: ((i64*)dst)[to] = keep ? ((const i64*)src)[from] : 0; break;
    default:
      ((i64*)dst)[2 * to] = keep ? ((const i64*)src)[2 * from] : 0;
      ((i64*)dst)[2 * to + 1] = keep ? ((const i64*)src)[2 * from + 1] : 0;
  }
}

// Row `from` of columns [c0, c1) into row `to`; a column's data is 0
// and its valid bit false unless `keep`.
__device__ __forceinline__ void gather_row(const GatherCols& cols, int c0, int c1, i64 from,
                                           i64 to, bool keep) {
  for (int c = c0; c < c1; ++c) {
    copy_elem(cols.src[c], cols.dst[c], cols.width[c], from, to, keep);
    cols.dst_valid[c][to] = keep && cols.src_valid[c][from] != 0;
  }
}

static inline int fill_gather_cols(GatherCols* cols, int n, const i64* src,
                                   const i64* src_valid, const i64* dst, const i64* dst_valid,
                                   const int* width) {
  if (n < 0 || n > GATHER_MAX_COLS) return 1;
  cols->n = n;
  for (int c = 0; c < n; ++c) {
    cols->src[c] = (const uint8_t*)src[c];
    cols->src_valid[c] = (const uint8_t*)src_valid[c];
    cols->dst[c] = (uint8_t*)dst[c];
    cols->dst_valid[c] = (uint8_t*)dst_valid[c];
    cols->width[c] = width[c];
  }
  return 0;
}

// Binary searches over sorted int64 keys: the first position whose key
// is >= q (lower bound) or > q (upper bound).
__device__ __forceinline__ i64 keys_lower_bound(const i64* __restrict__ a, i64 n, i64 q) {
  i64 lo = 0, hi = n;
  while (lo < hi) {
    const i64 mid = (lo + hi) >> 1;
    if (a[mid] < q) lo = mid + 1;
    else hi = mid;
  }
  return lo;
}

__device__ __forceinline__ i64 keys_upper_bound(const i64* __restrict__ a, i64 n, i64 q) {
  i64 lo = 0, hi = n;
  while (lo < hi) {
    const i64 mid = (lo + hi) >> 1;
    if (a[mid] <= q) lo = mid + 1;
    else hi = mid;
  }
  return lo;
}
