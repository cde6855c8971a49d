// K22 merge_sorted: two pages sorted by one int64 key each, merged into
// one sorted page.
//
// Replaces: presto_tpu/ops/merge.py merge_two_sorted :123 (two
// searchsorted rank computations, then one scatter of every column, the
// valid bits, the row mask and the key), the step that
// merge_sorted_pages :145 folds pairwise over k runs.
//
// Bound on the H100: memory.  Each row of both runs is read once and
// written once, every column's data and valid bit, the mask byte and
// the 8-byte key: two runs of 2^17 rows of ~30 bytes move ~16 MB, ~5 us
// at 3.35 TB/s.  The searches add log2(other run) dependent 8-byte
// probes a row; the upper levels of each search are shared by
// neighbouring threads and stay in L1/L2, so the probes that reach
// device memory are the last few of each search.
//
// Design: one thread per input row.  A row of a goes to i +
// lower_bound(key_b, key_a[i]) and a row of b to j +
// upper_bound(key_a, key_b[j]) (gather.cuh's searches), so equal keys
// keep a's rows before b's and each run's own order: the reference's
// positions, a bijection onto [0, na + nb) when both runs are sorted
// (dead rows carry INT64_MAX keys at each run's tail).  The row then
// copies every column through the column table of gather.cuh, with its
// key and mask.  One launch covers a run's rows for every column (a
// second covers the other run's); a merge-path partition with
// shared-memory tiles, which would read both runs once in order, is
// later work.

#include "gather.cuh"

#define K22_THREADS 256

static __global__ void __launch_bounds__(K22_THREADS)
    k22_merge_side(i64 n_self, const i64* __restrict__ key_self, const uint8_t* __restrict__ mask_self,
                   i64 n_other, const i64* __restrict__ key_other, int upper, GatherCols cols,
                   i64* __restrict__ out_key, uint8_t* __restrict__ out_mask) {
  const i64 stride = (i64)gridDim.x * blockDim.x;
  for (i64 i = (i64)blockIdx.x * blockDim.x + threadIdx.x; i < n_self; i += stride) {
    const i64 k = key_self[i];
    const i64 r = upper ? keys_upper_bound(key_other, n_other, k)
                        : keys_lower_bound(key_other, n_other, k);
    const i64 pos = i + r;
    gather_row(cols, 0, cols.n, i, pos, true);
    if (out_key != nullptr) {
      out_key[pos] = k;
      out_mask[pos] = mask_self[i];
    }
  }
}

// The rows of one run (self) at their merged positions: i +
// lower_bound(other, key_self[i]) for run a (upper = 0), j +
// upper_bound(other, key_self[j]) for run b (upper = 1).  out_key and
// out_mask may be null (a later chunk of columns).
extern "C" int k22_merge_sorted(i64 n_self, const void* key_self, const void* mask_self,
                                i64 n_other, const void* key_other, int upper, int n_cols,
                                const i64* src, const i64* src_valid, const i64* dst,
                                const i64* dst_valid, const int* width, void* out_key,
                                void* out_mask, void* stream) {
  GatherCols cols;
  if (fill_gather_cols(&cols, n_cols, src, src_valid, dst, dst_valid, width))
    return (int)cudaErrorInvalidValue;
  if (n_self < 0 || n_other < 0 || (out_key == nullptr) != (out_mask == nullptr))
    return (int)cudaErrorInvalidValue;
  if (n_self > 0)
    k22_merge_side<<<grid_for(n_self, K22_THREADS, 8), K22_THREADS, 0, (cudaStream_t)stream>>>(
        n_self, (const i64*)key_self, (const uint8_t*)mask_self, n_other,
        (const i64*)key_other, upper, cols, (i64*)out_key, (uint8_t*)out_mask);
  return (int)cudaGetLastError();
}
