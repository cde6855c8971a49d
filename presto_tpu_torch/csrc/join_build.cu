// K4 join_build: the build side of a hash join, sort-free when the
// planner promises unique keys.
//
// Replaces: presto_tpu/ops/join.py build_join (its unique-direct
// branch, and the CSR `starts` table of its sorted branch, which the
// reference computes with jnp.searchsorted over the key domain), and
// build_null_flags, the three-valued IN flags of a spilled build
// partition (k4_null_flags, one pass over the key valids and row mask:
// bound by those bytes).
//
// Bound on the H100: memory.  The unique branch reads each build row's
// key columns and row mask once, and writes, scans and reads a
// domain-sized int32 table; the ranked keys and row ids are written
// once.  TPC-H Q3 at SF10 builds over orders x customer (~1.5M live
// rows of ~16.8M) into a ~60M-slot table: the table's ~240 MB,
// touched four times, dominate (~0.3 ms at 3.35 TB/s).
//
// Design: (1) keys.cu packs each row's key into scratch (and sets the
// build's has-NULL-key and nonempty flags, read by K5's null-aware
// kinds); one thread per row counts it into its slot with an int32
// atomicAdd;
// (2) one thread per slot turns the count into present = min(count, 1)
// and flags a count > 1 (the broken uniqueness promise, reported as
// unique_ok = false so the caller rebuilds down the sorted branch);
// (3) the exclusive scan of scan.cuh turns presence into ranks, which
// is the CSR starts table itself; (4) one thread per live row scatters
// its key and row id to its rank.  The sorted branch sorts the
// sentinel-masked keys with torch.sort outside this file, and
// k4_join_starts writes its starts table: one thread per domain slot,
// a binary search (lower bound) over the sorted keys.  Hashed keys
// (K9) have no domain and take the sorted branch without a starts
// table.  TPC-H Q4's sorted build at SF10 sorts 2^26 keys (~38M live)
// and writes a 60M-slot starts table.  Simple first:
// the count pass serialises on a hot slot only when keys repeat,
// which the unique branch by definition does not expect.

#include "keys.cuh"
#include "scan.cuh"

static __global__ void k4_count(i64 n, const i64* __restrict__ keys, i64 prod,
                                int* __restrict__ counts) {
  const i64 stride = (i64)gridDim.x * blockDim.x;
  for (i64 i = (i64)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride) {
    const i64 key = keys[i];
    if (key == I64_MAX) continue;
    const i64 kc = key < 0 ? 0 : (key >= prod ? prod - 1 : key);
    atomicAdd(&counts[kc], 1);
  }
}

static __global__ void k4_presence(i64 prod, const int* __restrict__ counts,
                                   int* __restrict__ starts, int* __restrict__ collision) {
  const i64 stride = (i64)gridDim.x * blockDim.x;
  for (i64 i = (i64)blockIdx.x * blockDim.x + threadIdx.x; i < prod; i += stride) {
    const int c = counts[i];
    starts[i] = c > 0 ? 1 : 0;
    if (c > 1) *collision = 1;
  }
}

static __global__ void k4_scatter(i64 n, const i64* __restrict__ keys, i64 prod,
                                  const int* __restrict__ starts, i64* __restrict__ sorted_keys,
                                  int* __restrict__ perm) {
  const i64 stride = (i64)gridDim.x * blockDim.x;
  for (i64 i = (i64)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride) {
    const i64 key = keys[i];
    if (key == I64_MAX) continue;
    const i64 kc = key < 0 ? 0 : (key >= prod ? prod - 1 : key);
    const int r = starts[kc];
    sorted_keys[r] = key;
    perm[r] = (int)i;
  }
}

static __global__ void k4_fill(i64 n, i64* __restrict__ sorted_keys, int* __restrict__ perm) {
  const i64 stride = (i64)gridDim.x * blockDim.x;
  for (i64 i = (i64)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride) {
    sorted_keys[i] = I64_MAX;
    perm[i] = 0;
  }
}

static __global__ void k4_starts(const i64* __restrict__ sorted_keys, i64 n, i64 prod,
                                 int* __restrict__ starts) {
  const i64 stride = (i64)gridDim.x * blockDim.x;
  for (i64 q = (i64)blockIdx.x * blockDim.x + threadIdx.x; q <= prod; q += stride) {
    i64 lo = 0, hi = n;  // first position whose key is >= q
    while (lo < hi) {
      const i64 mid = (lo + hi) >> 1;
      if (sorted_keys[mid] < q) lo = mid + 1;
      else hi = mid;
    }
    starts[q] = (int)lo;
  }
}

// build_null_flags: flags[0] |= a live row has a NULL key, flags[1] |=
// a row is live, over the key columns' valids (K1's outputs for
// expression keys).  One thread per row; __syncthreads_or reduces the
// block and one thread ORs the result into the flags.
struct NullFlagValids {
  int n;
  const uint8_t* valid[PK_MAX_KEYS];
};

static __global__ void k4_null_flags_pass(NullFlagValids v, i64 n,
                                     const uint8_t* __restrict__ row_mask,
                                     int* __restrict__ flags) {
  const i64 stride = (i64)gridDim.x * blockDim.x;
  int saw_null = 0, saw_live = 0;
  for (i64 i = (i64)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride) {
    if (row_mask[i] == 0) continue;
    saw_live = 1;
    for (int c = 0; c < v.n; ++c) saw_null |= v.valid[c][i] == 0;
  }
  saw_null = __syncthreads_or(saw_null);
  saw_live = __syncthreads_or(saw_live);
  if (threadIdx.x == 0) {
    if (saw_null) atomicOr(&flags[0], 1);
    if (saw_live) atomicOr(&flags[1], 1);
  }
}

// (has a NULL key, nonempty) of n rows into flags (2 ints), from
// n_keys (1..PK_MAX_KEYS) key validity arrays.
extern "C" int k4_null_flags(i64 n, const void* row_mask, int n_keys, const i64* valid,
                             void* flags, void* stream) {
  if (n_keys < 1 || n_keys > PK_MAX_KEYS) return (int)cudaErrorInvalidValue;
  NullFlagValids v;
  v.n = n_keys;
  for (int c = 0; c < n_keys; ++c) v.valid[c] = (const uint8_t*)valid[c];
  cudaStream_t s = (cudaStream_t)stream;
  cudaMemsetAsync(flags, 0, 2 * sizeof(int), s);
  if (n > 0)
    k4_null_flags_pass<<<grid_for(n, 256, 8), 256, 0, s>>>(v, n, (const uint8_t*)row_mask,
                                                           (int*)flags);
  return (int)cudaGetLastError();
}

// Unique-direct build over packed keys `keys` (keys.cu's output)
// into a domain of prod slots.  counts: prod ints of scratch;
// starts: prod + 1 ints; partials: scan_tiles(prod) + 1 ints;
// sorted_keys/perm: n each; collision: one int, 1 when a slot holds
// more than one live row.
extern "C" int k4_join_build_unique(i64 n, const void* keys, i64 prod, void* counts,
                                    void* starts, void* partials, void* sorted_keys,
                                    void* perm, void* collision, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  cudaMemsetAsync(counts, 0, sizeof(int) * prod, s);
  cudaMemsetAsync(collision, 0, sizeof(int), s);
  if (n > 0) {
    k4_fill<<<grid_for(n, 256, 8), 256, 0, s>>>(n, (i64*)sorted_keys, (int*)perm);
    k4_count<<<grid_for(n, 256, 8), 256, 0, s>>>(n, (const i64*)keys, prod, (int*)counts);
  }
  k4_presence<<<grid_for(prod, 256, 8), 256, 0, s>>>(prod, (const int*)counts,
                                                     (int*)starts, (int*)collision);
  scan_exclusive_inplace((int*)starts, prod, (int*)partials, s);
  if (n > 0)
    k4_scatter<<<grid_for(n, 256, 8), 256, 0, s>>>(n, (const i64*)keys, prod,
                                                   (const int*)starts, (i64*)sorted_keys,
                                                   (int*)perm);
  return (int)cudaGetLastError();
}

// starts[q] = number of sorted keys < q, for q in [0, prod].
extern "C" int k4_join_starts(const void* sorted_keys, i64 n, i64 prod, void* starts,
                              void* stream) {
  k4_starts<<<grid_for(prod + 1, 256, 8), 256, 0, (cudaStream_t)stream>>>(
      (const i64*)sorted_keys, n, prod, (int*)starts);
  return (int)cudaGetLastError();
}
