// Group and join keys (presto_tpu/ops/aggregate.py pack_or_hash_keys
// and _mix64), shared by the join build and probes (K4, K5, K8) and
// the sorted-group aggregation (K6).
//
// Exact branch: each key column's code is value - lo + 1, NULL is code
// 0, and the key is the mixed-radix number of the codes, in wrapping
// int64 arithmetic as the reference computes it.
//
// Hash branch (no exact domain; every column's card is 0): from h = 0,
// per column lane = valid ? value : 0 and
// h = mix(h ^ mix(lane + 0x9E37 * valid)), splitmix64's finalizer in
// unsigned 64-bit arithmetic; the key is h's low 63 bits, bit for bit
// the reference's.  A dictionary column hashes its int32 codes.
#pragma once

#include "common.cuh"

#define PK_MAX_KEYS 16
enum { PK_BOOL = 0, PK_I32 = 1, PK_I64 = 2, PK_F64 = 3 };

struct PackDesc {
  int n;
  int hashed;  // 1: the hash branch
  const void* data[PK_MAX_KEYS];
  const uint8_t* valid[PK_MAX_KEYS];
  int kind[PK_MAX_KEYS];
  i64 lo[PK_MAX_KEYS];
  i64 card[PK_MAX_KEYS];
};

__device__ __forceinline__ i64 pk_load(const void* p, int kind, i64 i) {
  if (kind == PK_I64) return ((const i64*)p)[i];
  if (kind == PK_I32) return ((const int*)p)[i];
  if (kind == PK_F64) return __double2ll_rz(((const double*)p)[i]);  // a hashed double key
  return ((const uint8_t*)p)[i] != 0;
}

// The exact packed key of row i; *all_valid says whether no key is NULL.
__device__ __forceinline__ i64 exact_key(const PackDesc& k, i64 i, bool* all_valid) {
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

__device__ __forceinline__ u64 mix64(u64 x) {
  x = (x ^ (x >> 30)) * 0xBF58476D1CE4E5B9ull;
  x = (x ^ (x >> 27)) * 0x94D049BB133111EBull;
  return x ^ (x >> 31);
}

// The hashed key of row i (63 bits, never negative).
__device__ __forceinline__ i64 hash_key(const PackDesc& k, i64 i, bool* all_valid) {
  u64 h = 0;
  bool ok = true;
  for (int c = 0; c < k.n; ++c) {
    const bool v = k.valid[c][i] != 0;
    const u64 lane = v ? (u64)pk_load(k.data[c], k.kind[c], i) : 0ull;
    h = mix64(h ^ mix64(lane + 0x9E37ull * (u64)v));
    ok = ok && v;
  }
  *all_valid = ok;
  return (i64)(h & 0x7FFFFFFFFFFFFFFFull);
}

__device__ __forceinline__ i64 pack_key(const PackDesc& k, i64 i, bool* all_valid) {
  return k.hashed ? hash_key(k, i, all_valid) : exact_key(k, i, all_valid);
}

// card[c] == 0 for every column selects the hash branch.
static inline int fill_pack_desc(PackDesc* d, int n, const i64* data, const i64* valid,
                                 const int* kind, const i64* lo, const i64* card) {
  if (n < 1 || n > PK_MAX_KEYS) return 1;
  d->n = n;
  d->hashed = card[0] == 0;
  for (int c = 0; c < n; ++c) {
    if ((card[c] == 0) != (d->hashed != 0)) return 1;
    d->data[c] = (const void*)data[c];
    d->valid[c] = (const uint8_t*)valid[c];
    d->kind[c] = kind[c];
    d->lo[c] = lo[c];
    d->card[c] = card[c];
  }
  return 0;
}
