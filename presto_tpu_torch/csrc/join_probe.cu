// K5 join_probe: the row-aligned probe of a join: inner and left
// against a unique (or first-match) build, and the presence tests
// semi, anti and mark against any build.
//
// Replaces: presto_tpu/ops/join.py _probe_keys, _lookup_first and
// probe_join (every kind, with null_safe and null_aware), which XLA
// fused into the probe chain.
//
// Bound on the H100: memory.  Each probe row reads its key columns and
// row mask once and writes the new row mask; a live row then touches
// two 32-byte sectors for the lookup (starts[k], starts[k+1]), and for
// inner and left one sector of perm and one per gathered build column,
// writing each gathered value once.  For TPC-H Q14 and Q3 at SF10 that
// is ~10-20 B per probe row plus ~100 B per matched row, per 2^23-row
// lineitem split; Q4's semi probe of orders reads ~20 B per row and
// its lookups in a 240 MB starts table.
//
// Design: one fused kernel, one thread per probe row (grid-stride):
// pack the key (keys.cuh: exact, or hashed when the key has no domain);
// dead rows and, unless null_safe, NULL keys take a sentinel that never
// matches; read starts[k] and starts[k+1] of the direct table (or,
// without one, binary-search the sorted keys).  Inner writes the match
// into the row mask and gathers each build output column's data and
// valid bit through perm (an unmatched row's data is 0); left keeps the
// row mask and gathers the same way; semi and anti only filter the row
// mask, and mark writes the match as a BOOLEAN column, so none of the
// three reads perm or a build column.  null_aware (IN / NOT IN) reads
// the build's two flags (a NULL key, nonempty) from device memory, so
// no host read is needed: an unmatched live row is UNKNOWN when its
// key is NULL against a nonempty build or the build holds a NULL key;
// UNKNOWN filters as FALSE and shows as a NULL mark.  Simple first:
// gathers are per element, not vectorised, and the build table is not
// staged in shared memory.

#include "gather.cuh"
#include "keys.cuh"

// join kinds: keep in step with kernels/join_probe.py
enum { K5_INNER = 0, K5_LEFT = 1, K5_SEMI = 2, K5_ANTI = 3, K5_MARK = 4 };

static __global__ void k5_probe(PackDesc k, i64 n, const uint8_t* __restrict__ row_mask,
                                const int* __restrict__ starts, i64 domain,
                                const i64* __restrict__ sorted_keys, i64 build_cap,
                                const int* __restrict__ perm, GatherCols cols, int kind,
                                bool null_safe, bool null_aware, const int* __restrict__ flags,
                                uint8_t* __restrict__ out_mask, uint8_t* __restrict__ mark_data,
                                uint8_t* __restrict__ mark_valid) {
  const i64 stride = (i64)gridDim.x * blockDim.x;
  for (i64 i = (i64)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride) {
    const bool live = row_mask[i] != 0;
    bool ok;
    i64 key = pack_key(k, i, &ok);
    const bool key_ok = live && (ok || null_safe);
    if (!key_ok) key = I64_MAX - 1;  // distinct from the build's sentinel
    i64 pos;
    bool found;
    if (starts != nullptr) {
      const i64 kk = key < 0 ? 0 : (key >= domain ? domain - 1 : key);
      const i64 lo = starts[kk], hi = starts[kk + 1];
      found = hi > lo && key >= 0 && key < domain;
      pos = lo;
    } else {
      const i64 lo = keys_lower_bound(sorted_keys, build_cap, key);
      pos = lo < build_cap ? lo : build_cap - 1;
      found = sorted_keys[pos] == key;
    }
    const bool match = found && live;
    if (kind == K5_INNER || kind == K5_LEFT) {
      pos = pos < 0 ? 0 : (pos >= build_cap ? build_cap - 1 : pos);
      out_mask[i] = kind == K5_INNER ? match : live;
      gather_row(cols, 0, cols.n, match ? perm[pos] : 0, i, match);
      continue;
    }
    const bool unknown = null_aware && !match && flags[1] != 0 && (!key_ok || flags[0] != 0);
    if (kind == K5_SEMI) {
      out_mask[i] = match;
    } else if (kind == K5_ANTI) {
      out_mask[i] = live && !match && !unknown;
    } else {  // K5_MARK
      out_mask[i] = live;
      mark_data[i] = match;
      mark_valid[i] = !unknown;
    }
  }
}

// Probes n rows.  starts (domain + 1 ints) may be null: then the
// sorted keys are binary-searched.  Inner and left gather each of the
// n_cols build output columns into dst/dst_valid (n elements of width
// bytes); mark writes mark_data/mark_valid (n bytes each).  flags (two
// ints: the build has a NULL key, the build is nonempty) is read only
// when null_aware.
extern "C" int k5_join_probe(i64 n, const void* row_mask, int n_keys, const i64* key_data,
                             const i64* key_valid, const int* key_kind, const i64* key_lo,
                             const i64* key_card, const void* starts, i64 domain,
                             const void* sorted_keys, i64 build_cap, const void* perm,
                             int n_cols, const i64* src, const i64* src_valid,
                             const i64* dst, const i64* dst_valid, const int* width,
                             int kind, int null_safe, int null_aware, const void* flags,
                             void* out_mask, void* mark_data, void* mark_valid,
                             void* stream) {
  PackDesc k;
  GatherCols cols;
  if (fill_pack_desc(&k, n_keys, key_data, key_valid, key_kind, key_lo, key_card) ||
      fill_gather_cols(&cols, n_cols, src, src_valid, dst, dst_valid, width) ||
      build_cap < 1 || kind < K5_INNER || kind > K5_MARK ||
      (kind > K5_LEFT && n_cols != 0) || (kind == K5_MARK && mark_data == nullptr) ||
      (null_aware && flags == nullptr))
    return (int)cudaErrorInvalidValue;
  if (n > 0)
    k5_probe<<<grid_for(n, 256, 8), 256, 0, (cudaStream_t)stream>>>(
        k, n, (const uint8_t*)row_mask, (const int*)starts, domain,
        (const i64*)sorted_keys, build_cap, (const int*)perm, cols, kind, null_safe != 0,
        null_aware != 0, (const int*)flags, (uint8_t*)out_mask, (uint8_t*)mark_data,
        (uint8_t*)mark_valid);
  return (int)cudaGetLastError();
}
