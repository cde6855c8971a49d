// K10 window_eval: window functions over a page ordered for them.
//
// Replaces: presto_tpu/ops/window.py window_page after its sort (the
// boundaries seg_first/peer_first, the position scans seg_start,
// last_peer and _segment_last, every kind of _compute_sorted with
// _nonnull_rank_index, _segmented_scan and the frame prefix sums, and
// the scatter back to the original row order), which XLA fused into
// one program of associative scans.
//
// Bound on the H100: memory.  Each row reads its permutation entry,
// row mask, partition key and order keys at two sorted neighbours,
// each function's argument, and writes each output once; the work a
// row is a few integer operations.  A 2^23-row split with one int64
// order key and four functions moves ~0.4 GB: ~0.12 ms at 3.35 TB/s.
//
// Design: several simple passes over sorted positions.  (1) One thread
// a position flags a new partition (the packed key or the liveness
// changes) and a new peer group (any order key's lanes or valid bit
// change).  (2) The flags' exclusive prefix counts (scan.cuh) number
// each position's segment and peer group; a scatter records where
// each segment and peer group starts, so seg_start, seg_last, the
// peer group's first row (rank) and last row (last_peer) and the
// dense rank are lookups: no max/min scans.  (3) Each function is one
// more pass (two or three with a scan) that computes a position's value
// in sorted space and writes it straight to its original row
// (perm[i]).  Frame counts and integer sums are exclusive prefix sums
// (int32 counts; wrapping unsigned 64-bit sums, whose frame
// differences equal the reference's p[e] - p[s] + v[s] modulo 2^64);
// a double sum adds in the order of the reference's jnp.cumsum on
// XLA:CPU (a scan of scans of 16: each run of 16 sums in order, the
// runs' totals scan the same way, level by level, and each run adds
// the total before it), so it rounds as the reference does, bit for
// bit;
// running min/max is a segmented scan of (value, segment-start flag)
// pairs in three passes (tiles with CUB's BlockScan, the tiles'
// carries in order, the carry applied up to each tile's first segment
// start).  avg divides float64(sum) by 10^scale and then by the count
// with __ddiv_rn (never a reciprocal multiply), as the twin divides by
// tensors.  IGNORE NULLS ranks the non-null rows by a prefix count and
// scatters rank -> position.  Simple first: no pass is fused with
// another, and the lookups are uncoalesced gathers.
//
// The narrow types: a SMALLINT or TINYINT argument or order key reads
// sign-extended and stores back narrowed; a REAL one widens exactly to
// its double, so sum and avg add it in the double prefix order (the
// reference sums a REAL as float64) and min/max scan it as a double,
// storing float32; an empty running min/max over a REAL starts at 2^63
// (the reference's int64 extreme cast to float32).

#include "common.cuh"
#include "scan.cuh"

#define K10_MAX_ORDER 8
#define K10_THREADS 256
#define K10_UNBOUNDED (-(1LL << 62))
#define K10_FSCAN_BLOCK 16

// function kinds: keep in step with kernels/window_eval.py
enum {
  W_ROW_NUMBER, W_RANK, W_DENSE_RANK, W_NTILE, W_PERCENT_RANK, W_CUME_DIST, W_LEAD, W_LAG,
  W_FIRST_VALUE, W_LAST_VALUE, W_NTH_VALUE, W_COUNT, W_COUNT_STAR, W_SUM, W_AVG, W_MIN, W_MAX
};
enum { FR_PEERS = 0, FR_WHOLE = 1, FR_ROWS = 2 };
enum { WK_BOOL = 0, WK_I32 = 1, WK_I64 = 2, WK_F64 = 3, WK_I16 = 5, WK_I8 = 6, WK_F32 = 7 };
// a value of k int64 lanes (a long decimal's two limbs, a raw varchar's
// pack_lanes): kind WK_LANES + k; an order key compares them for
// equality only, an argument is copied lane by lane
#define WK_LANES 64

// a double's or a REAL's (widened exactly) lane: summed and scanned as a
// double
__host__ __device__ __forceinline__ bool is_float_kind(int kind) {
  return kind == WK_F64 || kind == WK_F32;
}

struct K10Order {
  int n;
  const void* data[K10_MAX_ORDER];
  const uint8_t* valid[K10_MAX_ORDER];
  int kind[K10_MAX_ORDER];
};

struct K10Func {
  int kind, frame;
  i64 start, end;  // FR_ROWS offsets, K10_UNBOUNDED for none
  int offset, ignore_nulls, scale, arg_kind;
  const void* arg;
  const uint8_t* arg_valid;
  void* out;
  uint8_t* out_valid;
};

// The boundary counts and the starts they index.
struct K10Bounds {
  i64 n;
  const i64* perm;
  const uint8_t* live;
  const int* seg;   // exclusive count of segment starts, total at [n]
  const int* peer;  // the same for peer groups
  const int* seg_start_of;
  const int* peer_start_of;
};

__device__ __forceinline__ i64 d2bits(double x) { return __double_as_longlong(x); }
__device__ __forceinline__ double bits2d(i64 x) { return __longlong_as_double(x); }

__device__ __forceinline__ bool lanes_differ(int kind, const void* d, i64 a, i64 b) {
  switch (kind) {
    case WK_BOOL: return (((const uint8_t*)d)[a] != 0) != (((const uint8_t*)d)[b] != 0);
    case WK_I32: return ((const int*)d)[a] != ((const int*)d)[b];
    case WK_I64: return ((const i64*)d)[a] != ((const i64*)d)[b];
    case WK_F64: return ((const double*)d)[a] != ((const double*)d)[b];  // NaN differs
    case WK_F32: return ((const float*)d)[a] != ((const float*)d)[b];
    case WK_I16: return ((const short*)d)[a] != ((const short*)d)[b];
    case WK_I8: return ((const signed char*)d)[a] != ((const signed char*)d)[b];
    default: {  // WK_LANES + k
      const int k = kind - WK_LANES;
      for (int j = 0; j < k; ++j)
        if (((const i64*)d)[(i64)k * a + j] != ((const i64*)d)[(i64)k * b + j]) return true;
      return false;
    }
  }
}

// the argument's value at row r as an int64 lane (doubles as bits, a
// REAL as its exact double's)
__device__ __forceinline__ i64 load_lane(int kind, const void* d, i64 r) {
  switch (kind) {
    case WK_BOOL: return ((const uint8_t*)d)[r] != 0;
    case WK_I32: return ((const int*)d)[r];
    case WK_I16: return ((const short*)d)[r];
    case WK_I8: return ((const signed char*)d)[r];
    case WK_F32: return f32_bits(d, r);
    default: return ((const i64*)d)[r];
  }
}

__device__ __forceinline__ void store_lane(int kind, void* d, i64 r, i64 v) {
  switch (kind) {
    case WK_BOOL: ((uint8_t*)d)[r] = v != 0; break;
    case WK_I32: ((int*)d)[r] = (int)v; break;
    case WK_I16: ((short*)d)[r] = (short)v; break;
    case WK_I8: ((signed char*)d)[r] = (signed char)v; break;
    case WK_F32: ((float*)d)[r] = bits_f32(v); break;
    default: ((i64*)d)[r] = v;
  }
}

// out[o] = arg[r] (ok) or zero (!ok), in the argument's storage
__device__ __forceinline__ void copy_value(const K10Func& f, i64 r, i64 o, bool ok) {
  if (f.arg_kind >= WK_LANES) {
    const int k = f.arg_kind - WK_LANES;
    for (int j = 0; j < k; ++j)
      ((i64*)f.out)[(i64)k * o + j] = ok ? ((const i64*)f.arg)[(i64)k * r + j] : 0;
  } else {
    store_lane(f.arg_kind, f.out, o, ok ? load_lane(f.arg_kind, f.arg, r) : 0);
  }
}

__device__ __forceinline__ i64 clamp64(i64 x, i64 lo, i64 hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}

__device__ __forceinline__ i64 seg_start_at(const K10Bounds& b, i64 i) {
  return b.seg_start_of[b.seg[i + 1] - 1];
}

struct K10Pos {
  i64 seg_start, seg_last, first_peer, last_peer;
};

__device__ __forceinline__ K10Pos positions(const K10Bounds& b, i64 i) {
  const int sid = b.seg[i + 1] - 1, pid = b.peer[i + 1] - 1;
  K10Pos p;
  p.seg_start = b.seg_start_of[sid];
  p.seg_last = (i64)b.seg_start_of[sid + 1] - 1;
  p.first_peer = b.peer_start_of[pid];
  p.last_peer = (i64)b.peer_start_of[pid + 1] - 1;
  return p;
}

// the frame [f_start, f_end] of position i, clamped into s_c, e_c
__device__ __forceinline__ void frame_of(const K10Func& f, const K10Bounds& b, i64 i,
                                         const K10Pos& p, i64* f_start, i64* f_end, i64* s_c,
                                         i64* e_c, bool* empty) {
  i64 fs, fe;
  if (f.frame == FR_ROWS) {
    fs = f.start == K10_UNBOUNDED ? p.seg_start
                                  : (p.seg_start > i + f.start ? p.seg_start : i + f.start);
    fe = f.end == K10_UNBOUNDED ? p.seg_last
                                : (p.seg_last < i + f.end ? p.seg_last : i + f.end);
  } else {
    fs = p.seg_start;
    fe = f.frame == FR_WHOLE ? p.seg_last : p.last_peer;
  }
  *f_start = fs;
  *f_end = fe;
  *empty = fe < fs;
  *s_c = clamp64(fs, 0, b.n - 1);
  *e_c = clamp64(fe, 0, b.n - 1);
}

#define GRID_LOOP(i, n) \
  for (i64 i = (i64)blockIdx.x * blockDim.x + threadIdx.x; i < (n); \
       i += (i64)gridDim.x * blockDim.x)

// (1) partition and peer boundaries over sorted positions
static __global__ void k10_flags(i64 n, const i64* __restrict__ perm,
                                 const uint8_t* __restrict__ live, const i64* __restrict__ pkey,
                                 const K10Order o, int* __restrict__ seg,
                                 int* __restrict__ peer) {
  GRID_LOOP(i, n) {
    bool sf = true, pf = true;
    if (i > 0) {
      const i64 r = perm[i], q = perm[i - 1];
      sf = pkey[r] != pkey[q] || (live[r] != 0) != (live[q] != 0);
      pf = sf;
      for (int c = 0; c < o.n && !pf; ++c)
        pf = lanes_differ(o.kind[c], o.data[c], r, q) ||
             (o.valid[c][r] != 0) != (o.valid[c][q] != 0);
    }
    seg[i] = sf;
    peer[i] = pf;
  }
}

// (2) where each segment and peer group starts, by ordinal; [count] = n
static __global__ void k10_starts(i64 n, const int* __restrict__ seg,
                                  const int* __restrict__ peer, int* __restrict__ seg_start_of,
                                  int* __restrict__ peer_start_of) {
  GRID_LOOP(i, n) {
    if (seg[i + 1] != seg[i]) seg_start_of[seg[i]] = (int)i;
    if (peer[i + 1] != peer[i]) peer_start_of[peer[i]] = (int)i;
    if (i == 0) {
      seg_start_of[seg[n]] = (int)n;
      peer_start_of[peer[n]] = (int)n;
    }
  }
}

// row_number, rank, dense_rank, ntile, percent_rank, cume_dist
static __global__ void k10_ranks(const K10Bounds b, const K10Func f) {
  GRID_LOOP(i, b.n) {
    const K10Pos p = positions(b, i);
    const i64 r = b.perm[i];
    f.out_valid[r] = b.live[r];
    i64 v = 0;
    double x = 0.0;
    switch (f.kind) {
      case W_ROW_NUMBER: v = i - p.seg_start + 1; break;
      case W_RANK: v = p.first_peer - p.seg_start + 1; break;
      case W_DENSE_RANK: v = (i64)b.peer[i + 1] - b.peer[p.seg_start + 1] + 1; break;
      case W_NTILE: {  // the first (count % n) buckets take one more row
        const i64 nb = f.offset, rn0 = i - p.seg_start, count = p.seg_last - p.seg_start + 1;
        const i64 q = fdiv(count, nb), rem = count - q * nb, big = (q + 1) * rem;
        v = (rn0 < big ? fdiv(rn0, q + 1 > 1 ? q + 1 : 1)
                       : rem + fdiv(rn0 - big, q > 1 ? q : 1)) + 1;
        break;
      }
      case W_PERCENT_RANK: {
        const double rank = (double)(p.first_peer - p.seg_start);
        const double count = (double)(p.seg_last - p.seg_start);
        x = count > 0.0 ? __ddiv_rn(rank, count > 1.0 ? count : 1.0) : 0.0;
        break;
      }
      default: {  // W_CUME_DIST
        const double covered = (double)(p.last_peer - p.seg_start + 1);
        const double count = (double)(p.seg_last - p.seg_start + 1);
        x = __ddiv_rn(covered, count > 1.0 ? count : 1.0);
      }
    }
    if (f.kind == W_PERCENT_RANK || f.kind == W_CUME_DIST) ((double*)f.out)[r] = x;
    else ((i64*)f.out)[r] = v;
  }
}

// lead/lag by row offset
static __global__ void k10_shift(const K10Bounds b, const K10Func f) {
  GRID_LOOP(i, b.n) {
    const i64 src = i + (f.kind == W_LAG ? -(i64)f.offset : (i64)f.offset);
    const i64 src_c = clamp64(src, 0, b.n - 1);
    const bool ok = src >= 0 && src < b.n && seg_start_at(b, src_c) == seg_start_at(b, i);
    const i64 r = b.perm[i], q = b.perm[src_c];
    copy_value(f, q, r, ok);
    f.out_valid[r] = ok && f.arg_valid[q] && b.live[r];
  }
}

// the flags to count: live (count_star) or non-null live argument
static __global__ void k10_count_flags(const K10Bounds b, const K10Func f,
                                       int* __restrict__ flags) {
  GRID_LOOP(i, b.n) {
    const i64 r = b.perm[i];
    flags[i] = b.live[r] && (f.kind == W_COUNT_STAR || f.arg_valid[r]);
  }
}

// IGNORE NULLS: pos_of[rank] = position of the rank-th non-null row
static __global__ void k10_rank_positions(i64 n, const int* __restrict__ nn,
                                          int* __restrict__ pos_of) {
  GRID_LOOP(i, n) {
    if (nn[i + 1] != nn[i]) pos_of[nn[i + 1]] = (int)i;
  }
}

// lead/lag IGNORE NULLS
static __global__ void k10_shift_nonnull(const K10Bounds b, const K10Func f,
                                         const int* __restrict__ nn,
                                         const int* __restrict__ pos_of) {
  GRID_LOOP(i, b.n) {
    const i64 grank = nn[i + 1], nonnull = grank - nn[i], total = nn[b.n];
    const i64 tgt = f.kind == W_LAG ? grank - nonnull - (f.offset - 1) : grank + f.offset;
    const i64 src_c = pos_of[clamp64(tgt, 0, b.n)];
    const bool ok = tgt >= 1 && tgt <= total && seg_start_at(b, src_c) == seg_start_at(b, i);
    const i64 r = b.perm[i];
    copy_value(f, b.perm[src_c], r, ok);
    f.out_valid[r] = ok && b.live[r];
  }
}

// first_value, last_value, nth_value over the frame
static __global__ void k10_values(const K10Bounds b, const K10Func f,
                                  const int* __restrict__ nn, const int* __restrict__ pos_of) {
  GRID_LOOP(i, b.n) {
    const K10Pos p = positions(b, i);
    i64 fs, fe, s_c, e_c;
    bool empty;
    frame_of(f, b, i, p, &fs, &fe, &s_c, &e_c, &empty);
    const i64 r = b.perm[i];
    if (f.ignore_nulls) {  // pick by non-null rank within the frame
      const i64 g_e = nn[e_c + 1];
      const i64 before = nn[s_c];  // non-null rows before the frame
      const i64 in_frame = g_e - before;
      const i64 want = f.kind == W_FIRST_VALUE ? before + 1
                       : f.kind == W_LAST_VALUE ? g_e : before + f.offset;
      const bool have = !empty && want > before && want <= g_e && in_frame > 0;
      copy_value(f, b.perm[pos_of[clamp64(want, 0, b.n)]], r, have);
      f.out_valid[r] = have && b.live[r];
    } else {
      i64 pos = f.kind == W_FIRST_VALUE ? s_c : e_c;
      if (f.kind == W_NTH_VALUE) {
        pos = clamp64(fs + (f.offset - 1), 0, b.n - 1);
        empty = empty || fs + (f.offset - 1) > fe;
      }
      const i64 q = b.perm[pos];
      copy_value(f, q, r, true);
      f.out_valid[r] = f.arg_valid[q] && !empty && b.live[r];
    }
  }
}

// the values to sum or scan, in sorted order: the argument where it is
// valid on a live row, else 0 (sum) or the scan's identity (min/max)
static __global__ void k10_prep_values(const K10Bounds b, const K10Func f,
                                       i64* __restrict__ vals) {
  GRID_LOOP(i, b.n) {
    const i64 r = b.perm[i];
    const bool v = b.live[r] && f.arg_valid[r];
    i64 x;
    if (v) {
      x = load_lane(f.arg_kind, f.arg, r);
    } else if (f.kind == W_MIN || f.kind == W_MAX) {
      const bool mn = f.kind == W_MIN;
      if (f.arg_kind == WK_F64)  // the largest finite double, as the twin's
        x = mn ? 0x7fefffffffffffffLL : (i64)0xffefffffffffffffULL;
      else if (f.arg_kind == WK_F32)  // 2^63 as a REAL (the reference's int64 extreme)
        x = mn ? 0x43e0000000000000LL : (i64)0xc3e0000000000000ULL;
      else if (f.arg_kind == WK_I32) x = mn ? 0x7fffffffLL : -0x80000000LL;
      else if (f.arg_kind == WK_I16) x = mn ? 0x7fffLL : -0x8000LL;
      else if (f.arg_kind == WK_I8) x = mn ? 0x7fLL : -0x80LL;
      else if (f.arg_kind == WK_BOOL) x = mn ? 1 : 0;
      else x = mn ? I64_MAX : I64_MIN;
    } else {
      x = 0;  // 0.0 has the bits of 0
    }
    vals[i] = x;
  }
}

// -- a double prefix sum in XLA:CPU's order -----------------------------------

// each run of K10_FSCAN_BLOCK: its sums in order from 0.0 (the last run
// padded with 0.0), and the run's total; in may equal local
static __global__ void k10_fscan_runs(i64 n, const i64* in, i64* local,
                                      i64* __restrict__ totals) {
  GRID_LOOP(r, (n + K10_FSCAN_BLOCK - 1) / K10_FSCAN_BLOCK) {
    double acc = 0.0;
    for (int j = 0; j < K10_FSCAN_BLOCK; ++j) {
      const i64 i = r * K10_FSCAN_BLOCK + j;
      acc = __dadd_rn(acc, i < n ? bits2d(in[i]) : 0.0);
      if (i < n) local[i] = d2bits(acc);
    }
    totals[r] = d2bits(acc);
  }
}

// a short level (at most one run): its sums in order, by one thread
static __global__ void k10_fscan_top(i64 n, i64* a) {
  if (blockIdx.x != 0 || threadIdx.x != 0) return;
  double acc = 0.0;
  for (i64 i = 0; i < n; ++i) {
    acc = __dadd_rn(acc, bits2d(a[i]));
    a[i] = d2bits(acc);
  }
}

// each run adds the inclusive total of the runs before it (0.0 first)
static __global__ void k10_fscan_carry(i64 n, i64* __restrict__ local,
                                       const i64* __restrict__ up) {
  GRID_LOOP(i, n) {
    const i64 r = i / K10_FSCAN_BLOCK;
    local[i] = d2bits(__dadd_rn(bits2d(local[i]), r == 0 ? 0.0 : bits2d(up[r - 1])));
  }
}

// prefix = the inclusive sum of vals; levels: the runs' totals, level by
// level (n / 15 + 64 int64 are enough)
static void fscan(i64 n, const i64* vals, i64* prefix, i64* levels, int grid,
                  cudaStream_t s) {
  if (n <= K10_FSCAN_BLOCK) {
    cudaMemcpyAsync(prefix, vals, n * sizeof(i64), cudaMemcpyDeviceToDevice, s);
    k10_fscan_top<<<1, 1, 0, s>>>(n, prefix);
    return;
  }
  i64 size[16];
  i64* arr[16];
  int depth = 0;
  size[0] = n;
  arr[0] = prefix;
  const i64* in = vals;
  i64* next = levels;
  while (size[depth] > K10_FSCAN_BLOCK) {  // up: each level's runs and their totals
    const i64 m = (size[depth] + K10_FSCAN_BLOCK - 1) / K10_FSCAN_BLOCK;
    k10_fscan_runs<<<grid, K10_THREADS, 0, s>>>(size[depth], in, arr[depth], next);
    ++depth;
    size[depth] = m;
    arr[depth] = next;
    in = next;
    next += m;
  }
  k10_fscan_top<<<1, 1, 0, s>>>(size[depth], arr[depth]);
  for (int l = depth - 1; l >= 0; --l)  // down: each run adds the totals before it
    k10_fscan_carry<<<grid, K10_THREADS, 0, s>>>(size[l], arr[l], arr[l + 1]);
}

// -- running min/max: a segmented inclusive scan ----------------------------

struct SegV {
  i64 v;
  int f;
};

struct SegMinMax {
  int minimum, dbl;
  __device__ __forceinline__ i64 pick(i64 a, i64 b) const {
    if (dbl) {  // as jnp.minimum/maximum: a NaN wins, -0.0 is below 0.0
      const double x = bits2d(a), y = bits2d(b);
      if (x != x) return a;
      if (y != y) return b;
      const bool zeros = x == y && (a < 0) != (b < 0);  // +0.0 and -0.0
      return (minimum ? y < x || (zeros && b < 0) : y > x || (zeros && a < 0)) ? b : a;
    }
    return (minimum ? b < a : b > a) ? b : a;
  }
  __device__ __forceinline__ SegV operator()(const SegV& a, const SegV& b) const {
    SegV r;
    r.v = b.f ? b.v : pick(a.v, b.v);
    r.f = a.f | b.f;
    return r;
  }
};

// tiles: local segmented scan in place; each tile's aggregate; each
// position's "a segment starts in my tile at or before me"
static __global__ void k10_segscan_tiles(i64 n, const int* __restrict__ seg, SegMinMax op,
                                         i64* __restrict__ vals, uint8_t* __restrict__ lflag,
                                         i64* __restrict__ agg_v, int* __restrict__ agg_f) {
  typedef cub::BlockScan<SegV, SCAN_THREADS> Scan;
  __shared__ typename Scan::TempStorage tmp;
  const i64 base = (i64)blockIdx.x * SCAN_TILE + (i64)threadIdx.x * SCAN_ITEMS;
  SegV x[SCAN_ITEMS];
  for (int j = 0; j < SCAN_ITEMS; ++j) {
    const i64 i = base + j;
    x[j].v = i < n ? vals[i] : 0;
    x[j].f = i < n ? (seg[i + 1] != seg[i]) : 0;
  }
  SegV agg;
  Scan(tmp).InclusiveScan(x, x, op, agg);
  for (int j = 0; j < SCAN_ITEMS; ++j) {
    const i64 i = base + j;
    if (i < n) {
      vals[i] = x[j].v;
      lflag[i] = x[j].f != 0;
    }
  }
  if (threadIdx.x == 0) {
    agg_v[blockIdx.x] = agg.v;
    agg_f[blockIdx.x] = agg.f;
  }
}

// one thread: each tile's carry, the combination of the tiles before it
static __global__ void k10_segscan_carries(i64 tiles, SegMinMax op, i64* __restrict__ agg_v,
                                           const int* __restrict__ agg_f) {
  if (blockIdx.x != 0 || threadIdx.x != 0) return;
  SegV run;
  run.v = agg_v[0];
  run.f = agg_f[0];
  for (i64 t = 1; t < tiles; ++t) {
    SegV cur;
    cur.v = agg_v[t];
    cur.f = agg_f[t];
    agg_v[t] = run.v;  // the carry into tile t
    run = op(run, cur);
  }
}

static __global__ void k10_segscan_apply(i64 n, SegMinMax op, i64* __restrict__ vals,
                                         const uint8_t* __restrict__ lflag,
                                         const i64* __restrict__ carry) {
  GRID_LOOP(i, n) {
    const i64 t = i / SCAN_TILE;
    if (t > 0 && !lflag[i]) vals[i] = op.pick(carry[t], vals[i]);
  }
}

// count, count_star, sum, avg, min, max over the frame
static __global__ void k10_aggregate(const K10Bounds b, const K10Func f,
                                     const int* __restrict__ cnt_x,
                                     const i64* __restrict__ vals,
                                     const i64* __restrict__ scan) {
  GRID_LOOP(i, b.n) {
    const K10Pos p = positions(b, i);
    i64 fs, fe, s_c, e_c;
    bool empty;
    frame_of(f, b, i, p, &fs, &fe, &s_c, &e_c, &empty);
    const i64 r = b.perm[i];
    const i64 cnt = empty ? 0 : (i64)cnt_x[e_c + 1] - cnt_x[s_c];
    if (f.kind == W_COUNT || f.kind == W_COUNT_STAR) {
      ((i64*)f.out)[r] = cnt;
      f.out_valid[r] = b.live[r];
      continue;
    }
    f.out_valid[r] = cnt > 0 && b.live[r];
    if (f.kind == W_MIN || f.kind == W_MAX) {
      store_lane(f.arg_kind, f.out, r, vals[e_c]);
      continue;
    }
    i64 s_int = 0;
    double s_dbl = 0.0;
    const bool dbl = is_float_kind(f.arg_kind);
    if (dbl) {  // p[e] - p[s] + v[s], rounded in that order
      if (!empty)
        s_dbl = __dadd_rn(__dsub_rn(bits2d(scan[e_c]), bits2d(scan[s_c])), bits2d(vals[s_c]));
    } else if (!empty) {  // the exclusive prefix sums' difference, modulo 2^64
      s_int = (i64)((u64)scan[e_c + 1] - (u64)scan[s_c]);
    }
    if (f.kind == W_SUM) {  // a REAL sums in double
      if (dbl) ((double*)f.out)[r] = s_dbl;
      else ((i64*)f.out)[r] = s_int;
      continue;
    }
    double num = dbl ? s_dbl : __ll2double_rn(s_int);
    if (f.scale >= 0) {
      double p10 = 1.0;
      for (int k = 0; k < f.scale; ++k) p10 = __dmul_rn(p10, 10.0);  // exact to 10^22
      num = __ddiv_rn(num, p10);
    }
    ((double*)f.out)[r] = __ddiv_rn(num, __ll2double_rn(cnt > 1 ? cnt : 1));
  }
}

// Window functions over n rows in perm's order (see the wrapper,
// kernels/window_eval.py).  desc: 8 int64 per function (kind, frame,
// start, end, offset, ignore_nulls, scale, argument kind).  Scratch:
// seg, peer, seg_start_of, peer_start_of, cnt_x and pos_of n + 1 ints
// each; vals and scan n + 1 int64 each; levels n / 15 + 64 int64;
// partials 2 * (scan_tiles(n) + 1) int64.  Returns cudaGetLastError() after the launches.
extern "C" int k10_window_eval(i64 n, const void* perm, const void* live, const void* pkey,
                               int n_order, const i64* order_data, const i64* order_valid,
                               const int* order_kind, int n_funcs, const i64* desc,
                               const i64* arg_data, const i64* arg_valid, const i64* out_data,
                               const i64* out_valid, void* seg, void* peer, void* seg_start_of,
                               void* peer_start_of, void* cnt_x, void* pos_of, void* vals,
                               void* scan, void* levels, void* partials, void* stream) {
  if (n_order > K10_MAX_ORDER || n < 1 || n >= 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  K10Order o;
  o.n = n_order;
  for (int c = 0; c < n_order; ++c) {
    o.data[c] = (const void*)order_data[c];
    o.valid[c] = (const uint8_t*)order_valid[c];
    o.kind[c] = order_kind[c];
  }
  const int grid = grid_for(n, K10_THREADS, 8);
  int* segi = (int*)seg;
  int* peeri = (int*)peer;
  k10_flags<<<grid, K10_THREADS, 0, s>>>(n, (const i64*)perm, (const uint8_t*)live,
                                         (const i64*)pkey, o, segi, peeri);
  scan_exclusive_inplace(segi, n, (int*)partials, s);
  scan_exclusive_inplace(peeri, n, (int*)partials, s);
  k10_starts<<<grid, K10_THREADS, 0, s>>>(n, segi, peeri, (int*)seg_start_of,
                                          (int*)peer_start_of);
  K10Bounds b;
  b.n = n;
  b.perm = (const i64*)perm;
  b.live = (const uint8_t*)live;
  b.seg = segi;
  b.peer = peeri;
  b.seg_start_of = (const int*)seg_start_of;
  b.peer_start_of = (const int*)peer_start_of;
  const i64 tiles = scan_tiles(n);
  for (int k = 0; k < n_funcs; ++k) {
    const i64* d = desc + 8 * k;
    K10Func f;
    f.kind = (int)d[0];
    f.frame = (int)d[1];
    f.start = d[2];
    f.end = d[3];
    f.offset = (int)d[4];
    f.ignore_nulls = (int)d[5];
    f.scale = (int)d[6];
    f.arg_kind = (int)d[7];
    f.arg = (const void*)arg_data[k];
    f.arg_valid = (const uint8_t*)arg_valid[k];
    f.out = (void*)out_data[k];
    f.out_valid = (uint8_t*)out_valid[k];
    if (f.kind <= W_CUME_DIST) {
      k10_ranks<<<grid, K10_THREADS, 0, s>>>(b, f);
    } else if ((f.kind == W_LEAD || f.kind == W_LAG) && !(f.ignore_nulls && f.offset > 0)) {
      k10_shift<<<grid, K10_THREADS, 0, s>>>(b, f);
    } else if (f.kind <= W_NTH_VALUE) {  // IGNORE NULLS lead/lag, or a value function
      int* nn = (int*)cnt_x;
      if (f.ignore_nulls) {
        k10_count_flags<<<grid, K10_THREADS, 0, s>>>(b, f, nn);
        scan_exclusive_inplace(nn, n, (int*)partials, s);
        cudaMemsetAsync(pos_of, 0, (n + 1) * sizeof(int), s);
        k10_rank_positions<<<grid, K10_THREADS, 0, s>>>(n, nn, (int*)pos_of);
      }
      if (f.kind == W_LEAD || f.kind == W_LAG)
        k10_shift_nonnull<<<grid, K10_THREADS, 0, s>>>(b, f, nn, (const int*)pos_of);
      else
        k10_values<<<grid, K10_THREADS, 0, s>>>(b, f, nn, (const int*)pos_of);
    } else {  // aggregates over the frame
      int* cx = (int*)cnt_x;
      k10_count_flags<<<grid, K10_THREADS, 0, s>>>(b, f, cx);
      scan_exclusive_inplace(cx, n, (int*)partials, s);
      i64* v = (i64*)vals;
      i64* sc = (i64*)scan;
      if (f.kind != W_COUNT && f.kind != W_COUNT_STAR) {
        k10_prep_values<<<grid, K10_THREADS, 0, s>>>(b, f, v);
        if (f.kind == W_MIN || f.kind == W_MAX) {
          SegMinMax op;
          op.minimum = f.kind == W_MIN;
          op.dbl = is_float_kind(f.arg_kind);
          i64* agg_v = (i64*)partials;
          int* agg_f = (int*)(agg_v + tiles + 1);
          k10_segscan_tiles<<<(unsigned)tiles, SCAN_THREADS, 0, s>>>(
              n, segi, op, v, (uint8_t*)pos_of, agg_v, agg_f);
          k10_segscan_carries<<<1, 1, 0, s>>>(tiles, op, agg_v, agg_f);
          k10_segscan_apply<<<grid, K10_THREADS, 0, s>>>(n, op, v, (const uint8_t*)pos_of,
                                                         agg_v);
        } else if (is_float_kind(f.arg_kind)) {
          fscan(n, v, sc, (i64*)levels, grid, s);
        } else {
          cudaMemcpyAsync(sc, v, n * sizeof(i64), cudaMemcpyDeviceToDevice, s);
          scan_exclusive_inplace((u64*)sc, n, (u64*)partials, s);
        }
      }
      k10_aggregate<<<grid, K10_THREADS, 0, s>>>(b, f, cx, v, sc);
    }
  }
  return (int)cudaGetLastError();
}
