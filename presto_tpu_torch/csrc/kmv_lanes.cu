// K16 kmv_lanes: the KMV set digest of each group (make_set_digest,
// merge_set_digest and the merge of their partial states).
//
// Replaces: presto_tpu/ops/aggregate.py _kmv_lanes (:944), which
// make_set_digest (:753), merge_set_digest (:770) and the digest merge
// (:1235) call over the entries _digest_entries (:982) flattens: a
// jnp.lexsort by (group, hash), a flag at each run of equal (group,
// hash), a cumulative sum of the flags (the run id), a scatter-add of
// the counts per run, a cumulative max (each group's first run id),
// and two scatters of each run head whose distinct rank is below 64,
// which XLA ran as a sort, two scans and three scatters.
//
// Bound on the H100: memory.  The host's two stable sorts (torch.sort,
// the reference's lexsort) order the entries by (group, hash); the
// kernels then read each sorted entry's permutation index, group, hash
// and count (make_set_digest has none: each row counts 1) once and its neighbour's group and hash (cached), write two
// scan lanes and read them back: TPC-H SF10 make_set_digest(l_partkey)
// by l_shipmode moves ~60M x 56 B = 3.4 GB, ~1 ms at 3.35 TB/s.  The
// sorts of the 60M entries take most of the phase's time.
//
// Design: per sorted position, no per-group walk (a group may hold 30M
// entries).  K16a flags run heads and copies the counts; scan.cuh turns
// both into exclusive prefix sums (integer adds: order-free); K16b has
// each head whose distinct rank (heads before it in its group, a
// difference of two prefix sums) is below 64 write its hash and its
// run's starting count prefix, and each run's last entry write the
// ending prefix; K16c writes every state slot once: slot 0 min(distinct,
// 64), the count lanes as end minus start, the sentinel past distinct,
// and each group's distinct total.  No atomics: every slot has one
// writer, so the state does not depend on the schedule.

#include "scan.cuh"

__device__ __forceinline__ bool k16_head(const i64* perm, const i64* egid, const i64* hash,
                                         i64 p) {
  if (p == 0) return true;
  const i64 e = perm[p], q = perm[p - 1];
  return egid[e] != egid[q] || hash[e] != hash[q];
}

static __global__ void k16_flags(i64 live, const i64* __restrict__ perm,
                                 const i64* __restrict__ egid, const i64* __restrict__ hash,
                                 const i64* __restrict__ count, u64* __restrict__ heads,
                                 u64* __restrict__ csum) {
  const i64 stride = (i64)gridDim.x * blockDim.x;
  for (i64 p = (i64)blockIdx.x * blockDim.x + threadIdx.x; p < live; p += stride) {
    heads[p] = k16_head(perm, egid, hash, p) ? 1 : 0;
    if (count) csum[p] = (u64)count[perm[p]];
  }
}

static __global__ void k16_write(i64 live, const i64* __restrict__ perm,
                                 const i64* __restrict__ egid, const i64* __restrict__ hash,
                                 const i64* __restrict__ count, const i64* __restrict__ starts,
                                 const u64* __restrict__ hx, const u64* __restrict__ cx,
                                 int cap, i64* __restrict__ out, i64* __restrict__ c_start,
                                 i64* __restrict__ c_end) {
  const i64 stride = (i64)gridDim.x * blockDim.x;
  const i64 w = 1 + 2 * (i64)cap;
  for (i64 p = (i64)blockIdx.x * blockDim.x + threadIdx.x; p < live; p += stride) {
    const i64 e = perm[p];
    const i64 g = egid[e];
    const i64 gs = starts[g];
    const bool head = k16_head(perm, egid, hash, p);
    // the run's distinct rank in its group: heads up to p, less one,
    // less the heads before the group
    const i64 rank = (i64)(hx[p] - hx[gs]) + (head ? 0 : -1);
    if (rank >= cap) continue;
    // the count prefix at p: the scan of the counts, or p itself where
    // every count is 1 (no count lane)
    const i64 c0 = count ? (i64)cx[p] : p;
    if (head) {
      out[g * w + 1 + rank] = hash[e];
      c_start[g * cap + rank] = c0;
    }
    const bool last = p + 1 == starts[g + 1] || k16_head(perm, egid, hash, p + 1);
    if (last) c_end[g * cap + rank] = c0 + (count ? count[e] : 1);
  }
}

static __global__ void k16_finish(i64 groups, const i64* __restrict__ starts,
                                  const u64* __restrict__ hx, int cap,
                                  const i64* __restrict__ c_start,
                                  const i64* __restrict__ c_end, i64* __restrict__ out,
                                  i64* __restrict__ distinct) {
  const i64 w = 1 + 2 * (i64)cap;
  const i64 total = groups * w;
  const i64 stride = (i64)gridDim.x * blockDim.x;
  for (i64 i = (i64)blockIdx.x * blockDim.x + threadIdx.x; i < total; i += stride) {
    const i64 g = i / w;
    const i64 c = i - g * w;
    const i64 d = (i64)(hx[starts[g + 1]] - hx[starts[g]]);
    if (c == 0) {
      out[i] = d < cap ? d : (i64)cap;
      distinct[g] = d;
    } else if (c <= cap) {
      if (c - 1 >= d) out[i] = I64_MIN;  // lanes below d hold K16b's hashes
    } else {
      const i64 lane = c - 1 - cap;
      out[i] = lane < d ? c_end[g * cap + lane] - c_start[g * cap + lane] : I64_MIN;
    }
  }
}

// perm: the entries sorted by (group, hash), the selected ones first;
// egid, hash, count: per entry (count null: each entry counts 1, and
// csum is not read); starts: (groups + 1) first positions
// (starts[groups] the selected entries' count).  Scratch: heads and csum
// (live + 1) u64 each, partials (scan tiles + 1) u64, c_start and c_end
// (groups * cap) i64.  out: (groups, 1 + 2 * cap) int64; distinct:
// (groups,) int64.
extern "C" int k16_kmv_lanes(i64 groups, i64 live, const void* perm, const void* egid,
                             const void* hash, const void* count, const void* starts, int cap,
                             void* heads, void* csum, void* partials, void* c_start,
                             void* c_end, void* out, void* distinct, void* stream) {
  if (cap < 1 || live < 0) return (int)cudaErrorInvalidValue;
  if (groups <= 0) return (int)cudaGetLastError();
  cudaStream_t s = (cudaStream_t)stream;
  const i64* pm = (const i64*)perm;
  const i64* eg = (const i64*)egid;
  const i64* hs = (const i64*)hash;
  const i64* ct = (const i64*)count;
  const i64* st = (const i64*)starts;
  u64* hx = (u64*)heads;
  u64* cx = (u64*)csum;
  if (live > 0)
    k16_flags<<<grid_for(live, 256, 8), 256, 0, s>>>(live, pm, eg, hs, ct, hx, cx);
  scan_exclusive_inplace<u64>(hx, live, (u64*)partials, s);
  if (ct) scan_exclusive_inplace<u64>(cx, live, (u64*)partials, s);
  if (live > 0)
    k16_write<<<grid_for(live, 256, 8), 256, 0, s>>>(live, pm, eg, hs, ct, st, hx, cx, cap,
                                                     (i64*)out, (i64*)c_start, (i64*)c_end);
  const i64 total = groups * (1 + 2 * (i64)cap);
  k16_finish<<<grid_for(total, 256, 8), 256, 0, s>>>(groups, st, hx, cap,
                                                     (const i64*)c_start, (const i64*)c_end,
                                                     (i64*)out, (i64*)distinct);
  return (int)cudaGetLastError();
}
