// Exact packed keys (presto_tpu/ops/aggregate.py pack_or_hash_keys,
// exact branch), shared by the join build and probe (K4, K5) and the
// sorted-group aggregation (K6): each key column's code is
// value - lo + 1, NULL is code 0, and the key is the mixed-radix
// number of the codes, in wrapping int64 arithmetic as the reference
// computes it.
#pragma once

#include "common.cuh"

#define PK_MAX_KEYS 8
enum { PK_BOOL = 0, PK_I32 = 1, PK_I64 = 2 };

struct PackDesc {
  int n;
  const void* data[PK_MAX_KEYS];
  const uint8_t* valid[PK_MAX_KEYS];
  int kind[PK_MAX_KEYS];
  i64 lo[PK_MAX_KEYS];
  i64 card[PK_MAX_KEYS];
};

__device__ __forceinline__ i64 pk_load(const void* p, int kind, i64 i) {
  if (kind == PK_I64) return ((const i64*)p)[i];
  if (kind == PK_I32) return ((const int*)p)[i];
  return ((const uint8_t*)p)[i] != 0;
}

// The packed key of row i; *all_valid says whether no key is NULL.
__device__ __forceinline__ i64 pack_key(const PackDesc& k, i64 i, bool* all_valid) {
  i64 key = 0;
  bool ok = true;
  for (int c = 0; c < k.n; ++c) {
    const bool v = k.valid[c][i] != 0;
    const i64 code = v ? wadd(wsub(pk_load(k.data[c], k.kind[c], i), k.lo[c]), 1) : 0;
    key = wadd(wmul(key, k.card[c]), code);
    ok = ok && v;
  }
  *all_valid = ok;
  return key;
}

// The masked packed key of each of n rows: I64_MAX where the row is
// dead, and where a key is NULL if null_as_sentinel (a join key that
// matches nothing; a grouping key keeps NULL as code 0).
static __global__ void pk_pack_masked(PackDesc k, i64 n, const uint8_t* __restrict__ row_mask,
                                      bool null_as_sentinel, i64* __restrict__ keys) {
  const i64 stride = (i64)gridDim.x * blockDim.x;
  for (i64 i = (i64)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride) {
    bool ok;
    const i64 key = pack_key(k, i, &ok);
    keys[i] = (row_mask[i] && (ok || !null_as_sentinel)) ? key : I64_MAX;
  }
}

static inline int fill_pack_desc(PackDesc* d, int n, const i64* data, const i64* valid,
                                 const int* kind, const i64* lo, const i64* card) {
  if (n > PK_MAX_KEYS) return 1;
  d->n = n;
  for (int c = 0; c < n; ++c) {
    d->data[c] = (const void*)data[c];
    d->valid[c] = (const uint8_t*)valid[c];
    d->kind[c] = kind[c];
    d->lo[c] = lo[c];
    d->card[c] = card[c];
  }
  return 0;
}

// Launch pk_pack_masked on `stream`; a C entry point's whole body.
static inline int pk_launch_pack(i64 n, const void* row_mask, bool null_as_sentinel,
                                 int n_keys, const i64* key_data, const i64* key_valid,
                                 const int* key_kind, const i64* key_lo, const i64* key_card,
                                 void* keys, void* stream) {
  PackDesc k;
  if (fill_pack_desc(&k, n_keys, key_data, key_valid, key_kind, key_lo, key_card))
    return (int)cudaErrorInvalidValue;
  if (n > 0)
    pk_pack_masked<<<grid_for(n, 256, 8), 256, 0, (cudaStream_t)stream>>>(
        k, n, (const uint8_t*)row_mask, null_as_sentinel, (i64*)keys);
  return (int)cudaGetLastError();
}
