// Masked keys of a page's rows: the exact pack (shared by K4 and K6)
// and K9 hash_keys, the hash branch.
//
// Replaces: presto_tpu/ops/aggregate.py pack_or_hash_keys (its exact
// branch, and the hash branch :1723-1735 with _mix64 :1668), and the
// build-side flags of presto_tpu/ops/join.py build_join (has_null_key,
// nonempty), which XLA fused into the build and the sort path.
//
// Bound on the H100: memory.  Each row reads its key columns' data and
// validity and the row mask once and writes one 8-byte key.  The hash
// costs 2 * 2 multiplies and 6 shifts/xors per key column, ~40 integer
// operations per row for TPC-H Q10's seven keys against ~60 bytes read
// and written: far below the card's operations-per-byte balance.
// TPC-H Q10 at SF10 hashes each 2^23-row probe-output split, ~0.2 ms
// of bytes at 3.35 TB/s.
//
// Design: one thread per row, grid-stride.  A dead row takes I64_MAX
// without reading its key columns (a probe's output page is mostly
// dead), which sorts past every live key, and so does a row with a NULL key
// when null_as_sentinel is set (a join key matches nothing; a grouping
// key keeps NULL as code 0, or as a hashed NULL lane).  The hash runs
// in unsigned 64-bit arithmetic, so it wraps as the reference's uint64
// lanes do.  With `flags` set (the join build), flags[0] becomes 1 when
// a live row has a NULL key and flags[1] when any row is live: a warp
// vote, then one atomicOr per warp that saw one.

#include "keys.cuh"

__device__ __forceinline__ void pk_store(i64 i, i64 key, bool ok, bool live,
                                         bool null_as_sentinel, i64* keys) {
  keys[i] = (live && (ok || !null_as_sentinel)) ? key : I64_MAX;
}

__device__ __forceinline__ void pk_flags(bool saw_null, bool saw_live, int* flags) {
  if (flags == nullptr) return;
  const bool lane0 = (threadIdx.x & 31) == 0;
  if (__any_sync(0xffffffffu, saw_null) && lane0) atomicOr(&flags[0], 1);
  if (__any_sync(0xffffffffu, saw_live) && lane0) atomicOr(&flags[1], 1);
}

static __global__ void pk_pack_masked(PackDesc k, i64 n, const uint8_t* __restrict__ row_mask,
                                      bool null_as_sentinel, i64* __restrict__ keys,
                                      int* flags) {
  const i64 stride = (i64)gridDim.x * blockDim.x;
  bool saw_null = false, saw_live = false;
  for (i64 i = (i64)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride) {
    const bool live = row_mask[i] != 0;
    bool ok = true;
    const i64 key = live ? exact_key(k, i, &ok) : I64_MAX;  // a dead row reads no key column
    pk_store(i, key, ok, live, null_as_sentinel, keys);
    saw_null |= live && !ok;
    saw_live |= live;
  }
  pk_flags(saw_null, saw_live, flags);
}

// K9: the hash branch, with the same masking rules.
static __global__ void k9_hash_masked(PackDesc k, i64 n, const uint8_t* __restrict__ row_mask,
                                      bool null_as_sentinel, i64* __restrict__ keys,
                                      int* flags) {
  const i64 stride = (i64)gridDim.x * blockDim.x;
  bool saw_null = false, saw_live = false;
  for (i64 i = (i64)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride) {
    const bool live = row_mask[i] != 0;
    bool ok = true;
    const i64 key = live ? hash_key(k, i, &ok) : I64_MAX;  // a dead row reads no key column
    pk_store(i, key, ok, live, null_as_sentinel, keys);
    saw_null |= live && !ok;
    saw_live |= live;
  }
  pk_flags(saw_null, saw_live, flags);
}

static int pk_launch(bool hashed, i64 n, const void* row_mask, int null_as_sentinel,
                     int n_keys, const i64* key_data, const i64* key_valid,
                     const int* key_kind, const i64* key_lo, const i64* key_card, void* keys,
                     void* flags, void* stream) {
  PackDesc k;
  if (fill_pack_desc(&k, n_keys, key_data, key_valid, key_kind, key_lo, key_card) ||
      (k.hashed != 0) != hashed)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (flags != nullptr) cudaMemsetAsync(flags, 0, 2 * sizeof(int), s);
  if (n > 0) {
    const int grid = grid_for(n, 256, 8);
    if (hashed)
      k9_hash_masked<<<grid, 256, 0, s>>>(k, n, (const uint8_t*)row_mask,
                                          null_as_sentinel != 0, (i64*)keys, (int*)flags);
    else
      pk_pack_masked<<<grid, 256, 0, s>>>(k, n, (const uint8_t*)row_mask,
                                          null_as_sentinel != 0, (i64*)keys, (int*)flags);
  }
  return (int)cudaGetLastError();
}

// The masked exact key of each of n rows into `keys` (n int64); flags
// (2 ints) may be null.
extern "C" int pk_pack_keys(i64 n, const void* row_mask, int null_as_sentinel, int n_keys,
                            const i64* key_data, const i64* key_valid, const int* key_kind,
                            const i64* key_lo, const i64* key_card, void* keys, void* flags,
                            void* stream) {
  return pk_launch(false, n, row_mask, null_as_sentinel, n_keys, key_data, key_valid,
                   key_kind, key_lo, key_card, keys, flags, stream);
}

// K9: the masked hashed key of each of n rows (every card 0).
extern "C" int k9_hash_keys(i64 n, const void* row_mask, int null_as_sentinel, int n_keys,
                            const i64* key_data, const i64* key_valid, const int* key_kind,
                            const i64* key_lo, const i64* key_card, void* keys, void* flags,
                            void* stream) {
  return pk_launch(true, n, row_mask, null_as_sentinel, n_keys, key_data, key_valid,
                   key_kind, key_lo, key_card, keys, flags, stream);
}
