// K7 topn: the first n rows of a page under ORDER BY, without sorting
// the page.
//
// Replaces: presto_tpu/ops/sort.py topn_page (sort_perm's stable
// argsorts from the least significant key up, then the first n rows)
// and the fold of presto_tpu/exec/local.py _run_topn.
//
// Bound on the H100: memory.  The key columns, their valid bits and
// the row mask are read once; the output is n row ids.  TPC-H Q3 at
// SF10 ranks ~10^5 groups on a decimal(36,4) key (16 B) and a date
// (4 B): ~2.5 MB, under a microsecond at 3.35 TB/s, so the launches
// cost more than the bytes there; a REAL top 100 over orders' 8.4M-row
// split reads ~50 MB a pass.
//
// The order: rows compare under one total order, the reference's: dead
// rows never qualify; then key by key, the null rank (NULLs first or
// last) and the value's lanes (a long decimal's two limbs, high limb
// first; descending keys reverse the comparison; a double compares by
// an int64 key that reproduces XLA's float order); then the row
// position, which is how the stable sorts break ties.  A REAL key
// orders as its exact double; a SMALLINT or TINYINT key reads
// sign-extended.  A wide decimal key (decimal(37..38)) compares its
// five limbs, limb 0 first, and a raw varchar key its k pack_lanes
// lanes (k = ceil(W / 8), up to K7_MAX_LANES), which compare as signed
// int64 in the bytes' order.
//
// Design: each part of that tuple (a key's null rank, each lane, the
// row position) is a field, an unsigned 64-bit word whose order is the
// part's order (a lane's bits with the sign flipped, inverted when
// descending).  k7_range reads the live rows once and takes each of the
// first K7_FIELDS fields' least and greatest value; its last block lays
// out a 64-bit prefix from them: field after field, each the bits of
// (value - least) that its span needs, until 64 bits are full (the last
// field cut to its high bits).  A field that is constant over the live
// rows takes no bits, so a flag key, a decimal's zero high limb or a
// shared string prefix costs nothing, and most real keys fit with the
// row position: the prefix is then unique.  Two rows compare by their
// prefixes, computed in registers; only rows whose prefixes tie read
// the fields past the prefix (kernels/topn.py order_words_plain and
// prefix_plain are the plain version of the encoding).
//
// Selection: a radix select over the prefix, K7_RADIX bits a round.
// Each k7_hist launch reads the live rows, computes their prefixes and
// counts, in a shared-memory histogram per block summed into the
// grid's, the next digit of the rows whose resolved digits equal the
// n-th row's; its last block picks the digit that holds the n-th row.
// Once the rows below the resolved digits and the rows on them fit
// K7_BUDGET, the later rounds return at once and k7_collect writes
// them as (prefix, row) candidates: a row that cannot qualify is
// rejected by one register comparison with the shared bound.  Rows
// tied with the n-th on the whole prefix are never dropped: when more
// than the budget tie, k7_collect lists them and k7_final refines them
// field by field past the prefix (a block-wide radix select, 8 bits a
// round) until they fit.  k7_final then sorts the candidates in shared
// memory with a bitonic network, by prefix (a tie reads the fields
// past it), and writes the first n row ids and the count.  No launch
// synchronises with the host.  n is at most K7_MAX_N = 100 (TPC-H's
// LIMIT 100; kernels/topn.py raises above it); past it the port sorts
// the page instead (ops/sort.py topn_page: torch.sort, then the first
// n live rows), as the reference's topn_page always does.

#include <cub/block/block_scan.cuh>

#include "common.cuh"

#define K7_MAX_N 100
#define K7_MAX_KEYS 16
#define K7_MAX_LANES 128
#define K7_FIELDS 16  // fields a prefix may take bits from
#define K7_RADIX 12   // prefix bits a select round resolves
#define K7_BINS (1 << K7_RADIX)
#define K7_ROUNDS 6  // ceil(64 / K7_RADIX)
#define K7_BUDGET 2048  // candidates the final sort holds
#define K7_THREADS 256
#define K7_FINAL_THREADS 1024
#define K7_TIE_BINS 256  // the tie refinement's digit: 8 bits
#define FULL_MASK 0xffffffffu
#define SIGN_BIT 0x8000000000000000ull

// TK_LANES: a key of width[c] int64 lanes compared as signed int64, lane 0
// first (a long decimal's two limbs, a wide one's five, a raw varchar's k)
enum { TK_BOOL = 0, TK_I32 = 1, TK_I64 = 2, TK_LANES = 3, TK_F64 = 4, TK_I16 = 5, TK_I8 = 6,
       TK_F32 = 7 };

// A field: key fkey (FK_ROW: the row position; FK_END: past the last
// field) and its part (0: the null rank, j >= 1: lane j - 1).
#define FK_ROW (-1)
#define FK_END (-2)

struct K7Keys {
  int n_keys;
  const void* data[K7_MAX_KEYS];
  const uint8_t* valid[K7_MAX_KEYS];
  int kind[K7_MAX_KEYS];
  int width[K7_MAX_KEYS];  // TK_LANES: its lanes a row; else 1
  int asc[K7_MAX_KEYS];
  int nulls_first[K7_MAX_KEYS];
  int n_fields;  // fields whose range is taken: min(all fields, K7_FIELDS)
  int fkey[K7_FIELDS + 1];
  int fpart[K7_FIELDS + 1];
};

// The prefix's layout: field pf[i] contributes (value - lo[i]) << shl[i],
// or >> shr[i] when cut; q is the first field not wholly in the prefix.
struct K7Layout {
  int n_pf;
  int q;
  int pf[K7_FIELDS];
  int shl[K7_FIELDS];
  int shr[K7_FIELDS];
  u64 lo[K7_FIELDS];
};

// Device scratch, zeroed at each launch.
struct K7State {
  u64 lo_inv[K7_FIELDS];  // the greatest ~value of each field (~least value)
  u64 hi[K7_FIELDS];
  unsigned long long live;
  K7Layout lay;
  long long need;   // min(n, live)
  long long below;  // live rows whose resolved digits are below K
  long long cnt;    // live rows whose resolved digits equal K
  u64 K;
  int kb;    // prefix bits resolved
  int done;  // the candidates fit, or the whole prefix is resolved
  int n_final;
  int n_ties;
  u64 tie_prefix;
  unsigned arrive[K7_ROUNDS + 1];
  unsigned hist[K7_ROUNDS][K7_BINS];
};

// a double key as an int64 in ascending order (kernels/topn.py
// double_sort_key): negated when descending, -0.0 as 0.0, every NaN
// last, the bits of a negative double flipped below zero
__device__ __forceinline__ i64 double_key(double x, bool asc) {
  if (!asc) x = -x;
  if (x != x) return I64_MAX;
  if (x == 0.0) return 0;
  const i64 b = __double_as_longlong(x);
  return b < 0 ? b ^ I64_MAX : b;
}

__device__ __forceinline__ i64 lane(const K7Keys& k, int c, int j, i64 row) {
  switch (k.kind[c]) {
    case TK_BOOL: return ((const uint8_t*)k.data[c])[row] != 0;
    case TK_I32: return ((const int*)k.data[c])[row];
    case TK_I64: return ((const i64*)k.data[c])[row];
    case TK_F64: return double_key(((const double*)k.data[c])[row], k.asc[c] != 0);
    case TK_F32:  // a REAL orders as its exact double
      return double_key((double)((const float*)k.data[c])[row], k.asc[c] != 0);
    case TK_I16: return ((const short*)k.data[c])[row];
    case TK_I8: return ((const signed char*)k.data[c])[row];
    default: return ((const i64*)k.data[c])[(i64)k.width[c] * row + j];  // TK_LANES
  }
}

// A field of row `row` as an unsigned word in the field's order.
__device__ __forceinline__ u64 field(const K7Keys& k, int c, int part, i64 row) {
  if (c == FK_ROW) return (u64)row;
  if (part == 0) {
    const bool v = k.valid[c][row] != 0;
    return k.nulls_first[c] ? v : !v;
  }
  const u64 x = (u64)lane(k, c, part - 1, row) ^ SIGN_BIT;
  // a double's key is already in ascending order
  return k.asc[c] || k.kind[c] == TK_F64 || k.kind[c] == TK_F32 ? x : ~x;
}

__device__ __forceinline__ void next_field(const K7Keys& k, int& c, int& part) {
  if (c == FK_ROW) {
    c = FK_END;
  } else if (part < k.width[c]) {
    ++part;
  } else {
    part = 0;
    if (++c == k.n_keys) c = FK_ROW;
  }
}

// Whether row a comes before row b, on the fields from (c, part) on
// (the row position last, so two rows never tie).
__device__ __forceinline__ bool fields_before(const K7Keys& k, int c, int part, i64 a, i64 b) {
  for (; c != FK_END; next_field(k, c, part)) {
    const u64 x = field(k, c, part, a), y = field(k, c, part, b);
    if (x != y) return x < y;
  }
  return false;
}

__device__ __forceinline__ u64 prefix_of(const K7Keys& k, const K7Layout& lay, i64 row) {
  u64 p = 0;
  for (int i = 0; i < lay.n_pf; ++i) {
    const int f = lay.pf[i];
    const u64 d = field(k, k.fkey[f], k.fpart[f], row) - lay.lo[i];
    p |= lay.shr[i] ? d >> lay.shr[i] : d << lay.shl[i];
  }
  return p;
}

// The block's copy of the layout, word by word; then a barrier.
__device__ __forceinline__ void load_layout(const K7State* st, K7Layout& lay) {
  const int* src = (const int*)&st->lay;
  int* dst = (int*)&lay;
  for (int i = threadIdx.x; i < (int)(sizeof(K7Layout) / 4); i += blockDim.x) dst[i] = src[i];
  __syncthreads();
}

__device__ __forceinline__ u64 warp_max(u64 v) {
  for (int off = 16; off > 0; off >>= 1) {
    const u64 o = __shfl_down_sync(FULL_MASK, v, off);
    v = o > v ? o : v;
  }
  return v;
}

// Whether this block is the grid's last to arrive at counter `arrive`
// (after its writes are visible to the others).
__device__ __forceinline__ bool last_block(unsigned* arrive) {
  __shared__ bool last;
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    last = atomicAdd(arrive, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (last) __threadfence();
  return last;
}

// The live count and the least and greatest value of each ranged field;
// the last block lays out the prefix.
static __global__ void __launch_bounds__(K7_THREADS)
    k7_range(const K7Keys k, i64 rows, const uint8_t* __restrict__ mask, int n, K7State* st) {
  const i64 stride = (i64)gridDim.x * blockDim.x;
  const i64 t0 = (i64)blockIdx.x * blockDim.x + threadIdx.x;
  const int lane_id = threadIdx.x & 31;
  unsigned long long live = 0;
  for (i64 r = t0; r < rows; r += stride) live += mask[r] != 0;
  for (int off = 16; off > 0; off >>= 1) live += __shfl_down_sync(FULL_MASK, live, off);
  if (lane_id == 0 && live) atomicAdd(&st->live, live);
  for (int f = 0; f < k.n_fields; ++f) {
    u64 lo_inv = 0, hi = 0;
    for (i64 r = t0; r < rows; r += stride) {
      if (!mask[r]) continue;
      const u64 u = field(k, k.fkey[f], k.fpart[f], r);
      lo_inv = ~u > lo_inv ? ~u : lo_inv;
      hi = u > hi ? u : hi;
    }
    lo_inv = warp_max(lo_inv);
    hi = warp_max(hi);
    if (lane_id == 0) {
      if (lo_inv) atomicMax(&st->lo_inv[f], lo_inv);
      if (hi) atomicMax(&st->hi[f], hi);
    }
  }
  if (!last_block(&st->arrive[K7_ROUNDS]) || threadIdx.x != 0) return;
  K7Layout& lay = st->lay;  // zeroed
  lay.q = k.n_fields;
  const unsigned long long n_live = __ldcg(&st->live);
  int left = 64;
  for (int f = 0; f < k.n_fields && n_live; ++f) {
    const u64 lo = ~__ldcg(&st->lo_inv[f]), hi = __ldcg(&st->hi[f]);
    if (hi <= lo) continue;  // constant over the live rows: no bits
    const int w = 64 - __clzll((long long)(hi - lo));
    const int i = lay.n_pf++;
    lay.pf[i] = f;
    lay.lo[i] = lo;
    if (w > left) {  // cut to its high bits
      lay.shl[i] = 0;
      lay.shr[i] = w - left;
      lay.q = f;
      break;
    }
    left -= w;
    lay.shl[i] = left;
    lay.shr[i] = 0;
    if (left == 0) {
      lay.q = f + 1;
      break;
    }
  }
  st->need = (long long)n_live < n ? (long long)n_live : n;
  st->cnt = (long long)n_live;
  st->done = n_live <= K7_BUDGET;
}

// Select round `round`: the histogram of the next digit of the live
// rows whose resolved digits equal K; the last block picks the digit
// that holds the n-th row.
static __global__ void __launch_bounds__(K7_THREADS)
    k7_hist(const K7Keys k, i64 rows, const uint8_t* __restrict__ mask, K7State* st, int round) {
  typedef cub::BlockScan<unsigned long long, K7_THREADS> Scan;
  __shared__ K7Layout lay;
  __shared__ unsigned hist[K7_BINS];
  __shared__ typename Scan::TempStorage tmp;
  if (st->done) return;  // uniform: written by an earlier launch
  load_layout(st, lay);
  for (int b = threadIdx.x; b < K7_BINS; b += blockDim.x) hist[b] = 0;
  __syncthreads();
  const int kb = st->kb;
  const u64 K = st->K;
  const int bits = 64 - kb < K7_RADIX ? 64 - kb : K7_RADIX;
  const unsigned digit_mask = (1u << bits) - 1;
  const i64 stride = (i64)gridDim.x * blockDim.x;
  for (i64 r = (i64)blockIdx.x * blockDim.x + threadIdx.x; r < rows; r += stride) {
    if (!mask[r]) continue;
    const u64 p = prefix_of(k, lay, r);
    if (kb == 0 || (p >> (64 - kb)) == K)
      atomicAdd(&hist[(unsigned)(p >> (64 - kb - bits)) & digit_mask], 1u);
  }
  __syncthreads();
  unsigned* ghist = st->hist[round];
  for (int b = threadIdx.x; b < K7_BINS; b += blockDim.x)
    if (hist[b]) atomicAdd(&ghist[b], hist[b]);
  if (!last_block(&st->arrive[round])) return;
  // the digit b with below(b) < need - below <= below(b) + count(b)
  constexpr int per = K7_BINS / K7_THREADS;
  const int first = threadIdx.x * per;
  unsigned long long sum = 0;
  for (int j = 0; j < per; ++j) sum += first + j <= (int)digit_mask ? __ldcg(&ghist[first + j]) : 0;
  unsigned long long run;
  Scan(tmp).ExclusiveSum(sum, run);
  const long long want = st->need - st->below;
  for (int j = 0; j < per && first + j <= (int)digit_mask; ++j) {
    const unsigned long long c = __ldcg(&ghist[first + j]);
    if ((long long)run < want && want <= (long long)(run + c)) {
      const long long below = st->below + (long long)run;
      st->below = below;
      st->cnt = (long long)c;
      st->K = (K << bits) | (u64)(first + j);
      st->kb = kb + bits;
      st->done = below + (long long)c <= K7_BUDGET || kb + bits == 64;
    }
    run += c;
  }
}

// The candidates: every live row below the resolved digits, and the rows
// on them when they fit the budget; else those rows (tied on the whole
// prefix) into the tie list.
static __global__ void __launch_bounds__(K7_THREADS)
    k7_collect(const K7Keys k, i64 rows, const uint8_t* __restrict__ mask, K7State* st,
               u64* __restrict__ fin_prefix, int* __restrict__ fin_row, int* __restrict__ ties) {
  __shared__ K7Layout lay;
  load_layout(st, lay);
  const int kb = st->kb;
  const u64 K = st->K;
  const bool fit = st->below + st->cnt <= K7_BUDGET;
  const int lane_id = threadIdx.x & 31;
  const i64 stride = (i64)gridDim.x * blockDim.x;
  // whole warps walk the rows, so the appends can be warp-aggregated
  for (i64 base = (i64)blockIdx.x * blockDim.x; base < rows; base += stride) {
    const i64 r = base + threadIdx.x;
    bool take = false, tie = false;
    u64 p = 0;
    if (r < rows && mask[r]) {
      p = prefix_of(k, lay, r);
      const u64 hb = kb == 0 ? 0 : kb == 64 ? p : p >> (64 - kb);
      take = hb < K || (hb == K && fit);
      tie = hb == K && !fit;
    }
    const unsigned takes = __ballot_sync(FULL_MASK, take), tied = __ballot_sync(FULL_MASK, tie);
    const unsigned below_me = (1u << lane_id) - 1;
    if (takes) {
      int at = 0;
      if (lane_id == 0) at = atomicAdd(&st->n_final, __popc(takes));
      at = __shfl_sync(FULL_MASK, at, 0) + __popc(takes & below_me);
      if (take) {
        fin_prefix[at] = p;
        fin_row[at] = (int)r;
      }
    }
    if (tied) {
      int at = 0;
      if (lane_id == 0) at = atomicAdd(&st->n_ties, __popc(tied));
      at = __shfl_sync(FULL_MASK, at, 0) + __popc(tied & below_me);
      if (tie) {
        ties[at] = (int)r;
        if (at == 0) st->tie_prefix = p;
      }
    }
  }
}

// Pads sort last; two rows by prefix, a tie by the fields past it.
__device__ __forceinline__ bool cand_before(const K7Keys& k, const K7Layout& lay, u64 pa, int ra,
                                            u64 pb, int rb) {
  if (ra < 0 || rb < 0) return rb < 0 && ra >= 0;
  if (pa != pb) return pa < pb;
  return fields_before(k, k.fkey[lay.q], k.fpart[lay.q], ra, rb);
}

// One block: the ties past the prefix refined until they fit, then the
// candidates sorted (bitonic) and the first n row ids written.
static __global__ void __launch_bounds__(K7_FINAL_THREADS)
    k7_final(const K7Keys k, K7State* st, u64* __restrict__ fin_prefix, int* __restrict__ fin_row,
             int* __restrict__ ties, int n, int* __restrict__ out, int* __restrict__ out_cnt) {
  __shared__ K7Layout lay;
  __shared__ u64 sp[K7_BUDGET];
  __shared__ int sr[K7_BUDGET];
  __shared__ unsigned hist[K7_TIE_BINS];
  __shared__ int n_fin, n_tie, kept, pick;
  __shared__ long long want;
  load_layout(st, lay);
  const int t = threadIdx.x;
  if (t == 0) {
    n_fin = st->n_final;
    n_tie = st->n_ties;
    want = st->need - n_fin;
  }
  __syncthreads();
  const u64 tp = st->tie_prefix;
  // the ties: a radix select on each field past the prefix, 8 bits a round
  int c = k.fkey[lay.q], part = k.fpart[lay.q];
  for (; n_tie > 0 && n_fin + n_tie > K7_BUDGET && c != FK_END; next_field(k, c, part)) {
    for (int shift = 56; shift >= 0 && n_fin + n_tie > K7_BUDGET; shift -= 8) {
      for (int b = t; b < K7_TIE_BINS; b += blockDim.x) hist[b] = 0;
      __syncthreads();
      const int m = n_tie;
      for (int i = t; i < m; i += blockDim.x)
        atomicAdd(&hist[(field(k, c, part, ties[i]) >> shift) & 255], 1u);
      __syncthreads();
      if (t == 0) {
        long long run = 0;
        int b = 0;
        while (run + hist[b] < want) run += hist[b++];
        pick = b;
        kept = 0;
      }
      __syncthreads();
      // rows below the digit are candidates; rows on it stay ties
      for (int base = 0; base < m; base += blockDim.x) {
        const int i = base + t;
        int row = -1;
        unsigned dg = 0;
        if (i < m) {
          row = ties[i];
          dg = (unsigned)(field(k, c, part, row) >> shift) & 255;
        }
        __syncthreads();  // this chunk is read before any of it is rewritten
        if (row >= 0 && dg < (unsigned)pick) {
          const int at = atomicAdd(&n_fin, 1);
          fin_prefix[at] = tp;
          fin_row[at] = row;
        } else if (row >= 0 && dg == (unsigned)pick) {
          ties[atomicAdd(&kept, 1)] = row;
        }
      }
      __syncthreads();
      if (t == 0) {
        want = st->need - n_fin;
        n_tie = kept;
      }
      __syncthreads();
    }
  }
  for (int i = t; i < n_tie; i += blockDim.x) {
    fin_prefix[n_fin + i] = tp;
    fin_row[n_fin + i] = ties[i];
  }
  __syncthreads();
  const int m = n_fin + n_tie;  // <= K7_BUDGET
  int size = 2;
  while (size < m) size <<= 1;
  for (int i = t; i < size; i += blockDim.x) {
    sp[i] = i < m ? fin_prefix[i] : ~0ull;
    sr[i] = i < m ? fin_row[i] : -1;
  }
  __syncthreads();
  for (int w = 2; w <= size; w <<= 1) {
    for (int j = w >> 1; j > 0; j >>= 1) {
      for (int i = t; i < size; i += blockDim.x) {
        const int o = i ^ j;
        if (o > i) {
          const bool up = (i & w) == 0;
          if (cand_before(k, lay, sp[o], sr[o], sp[i], sr[i]) == up) {
            const u64 p = sp[i];
            sp[i] = sp[o];
            sp[o] = p;
            const int r = sr[i];
            sr[i] = sr[o];
            sr[o] = r;
          }
        }
      }
      __syncthreads();
    }
  }
  const int need = (int)st->need;
  for (int i = t; i < n; i += blockDim.x) out[i] = i < need ? sr[i] : 0;
  if (t == 0) *out_cnt = need;
}

// Scratch bytes for a page of `rows` rows.
extern "C" long long k7_scratch_bytes(i64 rows) {
  return (long long)((sizeof(K7State) + 15) / 16 * 16) + K7_BUDGET * (8 + 4) + 4 * (rows + 1);
}

// The first n (<= K7_MAX_N) live rows of `rows` under the keys' order:
// out[0..*out_cnt) row ids, the rest 0.  scratch: k7_scratch_bytes(rows).
extern "C" int k7_topn(i64 rows, const void* row_mask, int n_keys, const i64* data,
                       const i64* valid, const int* kind, const int* width, const int* asc,
                       const int* nulls_first, int n, void* scratch, void* out, void* out_cnt,
                       void* stream) {
  if (n_keys < 1 || n_keys > K7_MAX_KEYS || n < 1 || n > K7_MAX_N || rows < 0 ||
      rows >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  K7Keys k;
  k.n_keys = n_keys;
  for (int c = 0; c < n_keys; ++c) {
    k.data[c] = (const void*)data[c];
    k.valid[c] = (const uint8_t*)valid[c];
    k.kind[c] = kind[c];
    k.width[c] = width[c];
    if (width[c] < 1 || width[c] > K7_MAX_LANES) return (int)cudaErrorInvalidValue;
    k.asc[c] = asc[c];
    k.nulls_first[c] = nulls_first[c];
  }
  // the fields in order: each key's null rank and lanes, then the row
  int c = 0, part = 0, f = 0;
  for (; f <= K7_FIELDS; ++f) {
    k.fkey[f] = c;
    k.fpart[f] = part;
    if (c == FK_END) break;
    if (c == FK_ROW) {
      c = FK_END;
    } else if (part < width[c]) {
      ++part;
    } else {
      part = 0;
      if (++c == n_keys) c = FK_ROW;
    }
  }
  for (int g = f + 1; g <= K7_FIELDS; ++g) k.fkey[g] = FK_END, k.fpart[g] = 0;
  k.n_fields = 0;
  while (k.n_fields < K7_FIELDS && k.fkey[k.n_fields] != FK_END) ++k.n_fields;

  uint8_t* base = (uint8_t*)scratch;
  K7State* st = (K7State*)base;
  base += (sizeof(K7State) + 15) / 16 * 16;
  u64* fin_prefix = (u64*)base;
  int* fin_row = (int*)(base + 8 * K7_BUDGET);
  int* ties = fin_row + K7_BUDGET;
  cudaStream_t s = (cudaStream_t)stream;
  const uint8_t* mask = (const uint8_t*)row_mask;
  cudaMemsetAsync(st, 0, sizeof(K7State), s);
  const int grid = grid_for(rows, K7_THREADS, 4);
  k7_range<<<grid, K7_THREADS, 0, s>>>(k, rows, mask, n, st);
  for (int r = 0; r < K7_ROUNDS; ++r) k7_hist<<<grid, K7_THREADS, 0, s>>>(k, rows, mask, st, r);
  k7_collect<<<grid, K7_THREADS, 0, s>>>(k, rows, mask, st, fin_prefix, fin_row, ties);
  k7_final<<<1, K7_FINAL_THREADS, 0, s>>>(k, st, fin_prefix, fin_row, ties, n, (int*)out,
                                          (int*)out_cnt);
  return (int)cudaGetLastError();
}
