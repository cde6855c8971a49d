// K6 sorted_group_agg: grouped aggregation states over sorted packed
// keys, for key domains too large for a direct table.
//
// Replaces: presto_tpu/ops/aggregate.py _sorted_group_ids,
// _SortCtx.sum and the sort path of grouped_aggregate, and
// merge_aggregate with _merge_states (count, sum, avg, min and max
// states; _seg_min/_seg_max, _minmax_long), which XLA ran as a gather
// + cumsum + boundary difference over the sort's permutation; and
// _presorted_group_ids, grouped_aggregate's streaming branch; and the
// function surface's states and their merge (_partial_states :454,
// :492, :498, :569; _merge_states :1136, :1144, :1171).
//
// Bound on the H100: memory.  Past the sort (torch.sort, as the
// reference leaves its argsort to XLA), the sorted keys and the sort
// permutation are read once, each argument column once through the
// permutation (a gather), and the group states and representative
// keys written once.  TPC-H Q3 at SF10 groups each ~2^23-row lineitem
// split's probe output (~4.4 * 10^4 live rows) and then merges the
// partials.
//
// Design: keys.cu writes the masked key, exact or hashed (K9) (NULL
// keys group together, dead rows take a sentinel).  k6_count_live
// counts the live rows per tile and scans the counts (it reads the row
// mask, and a key only where the mask is set), and the host reads the
// live count.  k6_compact_rows then writes the live rows' keys and row
// ids densely, in input order (a block scan per tile), and, when the
// caller walks the runs, the dead rows' ids after the live count in
// `order`, in input order: the positions a stable sort of the whole
// page gives the sentinels.  Only those keys sort
// (torch.sort(stable=True)), so the live rows keep the positions the
// sort of the whole page gave them, and every pass after it covers the
// live positions alone.  A page whose rows are all live is its own
// compaction: its masked keys sort as they are and the sort's
// permutation is the order.  A page of at most
// SORT_WHOLE_ROWS rows (kernels/sorted_group_agg.py) sorts whole
// instead, its dead rows' sentinels last, and the live count comes back
// with the group count: there CUB's passes cost their launches whatever
// the live share, and a read of the live count before the sort would
// cost more.  k6_group_heads numbers the groups in packed-key order,
// the reference's group order, by the same count-scan-apply over the
// run heads (flags recomputed from the keys, never stored) and gathers
// the row ids through the sort's permutation; the host reads the group
// count once and sizes the outputs from it (count, allocate, write), so
// a partial emits every group it sees.
//
// k6_accumulate gives each warp one slot (a state's limb) over a tile
// of K6_TILE consecutive sorted positions, K6_ITEMS rows of 32: lane i
// reads position base + i, so the scan and the row ids are read
// coalesced, and the rows' values are gathered first, all in flight
// together.  The run boundaries of a row of the tile are a
// __ballot_sync of the head flags.  Each value is folded over its run by
// a segmented warp scan (__shfl_up_sync, bounded by the run's first
// lane), the run's total so far carried from one row of the tile to the
// next in one register, so every accumulator is a register and the
// kernel keeps no stack frame.  The lane at a run's last position writes
// it: a run that starts and ends inside the tile has one writer, a
// plain store; the tile's first and last runs may go on in the tiles
// beside them and combine by one 64-bit atomic.  The warp of a tile's
// first slot writes each group's representative key at its head (its
// first row in input order, since the sort is stable).  Long sums add
// four base-10^9 limbs, so every add is an exact integer add and the
// result does not depend on the order of the atomics.  k6_finish
// normalises the limbs to the reference's two base-10^18 limbs.
//
// min/max: a slot that starts at the int64 extreme no value passes;
// a run folds its rows in the warp scan and a shared run combines by one
// atomicMin or atomicMax.  A long decimal orders limb by limb, high limb
// first, so it takes the reference's phased walk: a first accumulate launch
// reduces the high limb, a second one the low limb over the rows whose
// high limb ties the group's.  An empty state keeps the identity (an
// int32 state the int32 one).
//
// Double states (a double sum; the variance state (s, m2, cnt) of
// _partial_states' two passes; its merge, _merge_states' Chan form
// M2 = sum of m2_i + c_i (mu_i - mu)^2) take no atomics: a double
// atomicAdd's order changes from run to run.  Each group's sorted run
// splits into chunks of K6_DSUM_CHUNK positions; k6_dchunks gives each
// chunk one thread that adds its values in sorted order from 0.0, and
// k6_dtree one thread per group that adds its chunk partials pairwise
// in place (stride 1, 2, 4, ...: the twin's level-by-level order).
// The counts come from integer states of the same launch.  Every double
// operation is an _rn intrinsic, so nothing contracts into an FMA and
// the card rounds as the plain twin (run_sums_plain) does, bit for bit.
//
// Presorted mode (streaming aggregation, equal keys arrive together):
// no sort.  The compacted live rows in page order stand in for the
// sorted ones; the heads, scan and states passes run unchanged over
// them, so a run's head is a live row whose key differs from the
// previous live row's (the reference's forward fill across dead rows)
// and groups come out in first-appearance order.
//
// The function surface: a double's min/max reduces an int64 order key
// (common.cuh minmax_key: -0.0 below 0.0, NaN moved to win, as the
// reference's segment reductions propagate it) and turns it back at the
// end; a boolean's min/max reads 0/1 and stores the fold's neutral
// value in an empty state; bitwise_and_agg / bitwise_or_agg fold by and
// / or (slot_fold in the warp scan, atomicAnd / atomicOr for a shared
// run; the reference's _seg_assoc); hll_merge's sum of 2^-rho (S_HLL)
// takes the double states' fixed order, each weight exact from its bits.
//
// The coupled and statistical states (_partial_states :480, :536 and
// _merge_states :1118, :1151): S_MOM runs the double pass four times,
// s, then sum dx*dx, (dx*dx)*dx and (dx*dx)*(dx*dx) with dx = x - mu;
// S_MOM_MERGE adds s_i, then m2_i + c_i d^2, m3_i + 3 m2_i d + c_i d^3
// and m4_i + 4 m3_i d + 6 m2_i d^2 + c_i d^4 with d = mu_i - mu, each
// in the reference's association.  min_by / max_by are three states,
// S_BY_X, S_BY_XV and S_BY_Y_MIN or S_BY_Y_MAX: the first accumulate
// launch reduces y's order key (a double's minmax_key), the second one
// (the phase of the long extremes) reads the group's reduced y and, over
// the rows whose y equals it as a value (a NaN extreme ties nothing),
// takes the greatest x by its order key (S_BY_X) and counts the rows
// with a valid x (S_BY_XV, stored as the 0/1 flag).  checksum is an
// S_SUM of K1's hashes (wadd wraps).
//
// The wide decimals (the sort path of _partial_states and
// _merge_states over decimal(37..38)): S_LIMBS_D38 adds a wide value's
// five limbs as they are (normalised at the end, _norm_wide), S_MIN_D38
// and S_MAX_D38 reduce limb 0 in the first accumulate launch and limb p
// in launch p over the rows tying the group's limbs before it (five
// launches; _minmax_long's answer).
//
// The narrow types: a SMALLINT or TINYINT state datum reads
// sign-extended (pk_load) and its min/max stores back narrowed, an
// empty state with its own type's identity; a REAL datum widens exactly
// to a double (DATA_F32) for its min/max order key or a double sum
// (S_DSUM's fixed order), and a REAL min/max stores back as float32.
// A SMALLINT or TINYINT group key's representative copies 2 or 1 bytes.

#include "keys.cuh"
#include "scan.cuh"

#define K6_MAX_STATES 32
#define K6_MAX_SLOTS 64
#define K6_ITEMS 4  // rows of 32 sorted positions in a warp's tile
#define K6_TILE (32 * K6_ITEMS)
#define FULL_MASK 0xffffffffu
#define K6_DSUM_CHUNK 256

// state kinds: keep in step with kernels/sorted_group_agg.py
enum { S_ONE = 0, S_VALID = 1, S_SUM = 2, S_LIMBS_SHORT = 3, S_LIMBS_LONG = 4, S_MIN = 5,
       S_MAX = 6, S_MIN_LONG = 7, S_MAX_LONG = 8, S_DSUM = 9, S_VAR = 10, S_VAR_MERGE = 11,
       S_MIN_F64 = 12, S_MAX_F64 = 13, S_BAND = 14, S_BOR = 15, S_HLL = 16, S_MOM = 17,
       S_MOM_MERGE = 18, S_BY_Y_MIN = 19, S_BY_Y_MAX = 20, S_BY_X = 21, S_BY_XV = 22,
       S_LIMBS_D38 = 23, S_MIN_D38 = 24, S_MAX_D38 = 25 };
// how k6_finish stores a state (kernels/sorted_group_agg.py _OUT_KINDS)
enum { OUT_I64 = 0, OUT_I32 = 1, OUT_BOOL = 2, OUT_F64 = 3, OUT_I16 = 4, OUT_I8 = 5,
       OUT_F32 = 6 };
// a state's data: pk_load's integer kinds, or a double's bits (DATA_F64)
// or a REAL's, widened exactly (DATA_F32)
#define DATA_F64 3
#define DATA_F32 6

// a double or REAL state datum as the bits of its double
__device__ __forceinline__ i64 data_bits(const void* p, int kind, i64 row) {
  return kind == DATA_F32 ? f32_bits(p, row) : ((const i64*)p)[row];
}

__host__ __device__ __forceinline__ bool is_int_state(int kind) {
  return (kind >= S_ONE && kind <= S_MAX_LONG) || (kind >= S_MIN_F64 && kind <= S_BOR) ||
         (kind >= S_BY_Y_MIN && kind <= S_MAX_D38);
}

// min_by / max_by: the order key of a y (is_min: min_by's) or an x
// (the max side)
__device__ __forceinline__ i64 by_key(const void* p, int kind, i64 row, bool is_min) {
  if (kind == DATA_F64 || kind == DATA_F32) return minmax_key(data_bits(p, kind, row), is_min);
  return pk_load(p, kind, row);
}

__host__ __device__ __forceinline__ int state_width(int kind) {
  return (kind == S_LIMBS_SHORT || kind == S_LIMBS_LONG) ? 4
      : (kind == S_MIN_LONG || kind == S_MAX_LONG) ? 2
      : (kind >= S_LIMBS_D38 && kind <= S_MAX_D38) ? D38_LIMBS : 1;
}

struct K6Desc {
  int n_keys;
  const uint8_t* key_src[PK_MAX_KEYS];
  const uint8_t* key_valid[PK_MAX_KEYS];
  uint8_t* key_dst[PK_MAX_KEYS];
  uint8_t* key_dst_valid[PK_MAX_KEYS];
  int key_width[PK_MAX_KEYS];
  int n_states;
  int kind[K6_MAX_STATES];
  int slot[K6_MAX_STATES];  // first raw slot
  const void* data[K6_MAX_STATES];
  int data_kind[K6_MAX_STATES];
  const uint8_t* valid[K6_MAX_STATES];
  i64* out[K6_MAX_STATES];  // (G,) or (G, 2) limbs; int32 or bool by out_kind
  int out_kind[K6_MAX_STATES];
  int raw_width;
  uint8_t slot_kind[K6_MAX_SLOTS];  // SLOT_ADD, SLOT_MIN, SLOT_MAX, SLOT_AND or SLOT_OR
};

__device__ __forceinline__ void copy_key(const uint8_t* src, uint8_t* dst, int width,
                                         i64 from, i64 to) {
  if (width == 1) dst[to] = src[from];
  else if (width == 2) ((short*)dst)[to] = ((const short*)src)[from];
  else if (width == 4) ((int*)dst)[to] = ((const int*)src)[from];
  else ((i64*)dst)[to] = ((const i64*)src)[from];
}

static __global__ void k6_init(const K6Desc d, i64 slots, i64* __restrict__ raw) {
  const i64 stride = (i64)gridDim.x * blockDim.x;
  for (i64 j = (i64)blockIdx.x * blockDim.x + threadIdx.x; j < slots; j += stride)
    raw[j] = slot_identity(d.slot_kind[j % d.raw_width]);
}

// Whether slot j of a state of `kind` takes accumulate phase `phase`.
// Phase 0: every state but the lower limbs of a long or wide min/max and
// min_by / max_by's x; phase p >= 1: a wide min/max's limb p, and in
// phase 1 a long min/max's low limb and min_by / max_by's x and x flag.
__host__ __device__ __forceinline__ bool in_phase(int kind, int j, int phase) {
  const bool long_x = kind == S_MIN_LONG || kind == S_MAX_LONG;
  const bool d38_x = kind == S_MIN_D38 || kind == S_MAX_D38;
  const bool by = kind == S_BY_X || kind == S_BY_XV;
  if (phase == 0) return !by && !(long_x && j == 1) && !(d38_x && j > 0);
  return (d38_x && j == phase) || (phase == 1 && ((long_x && j == 1) || by));
}

// What row `row` adds to slot j of state s in its phase (the slot's
// identity where it adds nothing).  group_raw: the raw slots of the
// row's group, which hold the earlier phases' results: a long or wide
// min/max reduces a lower limb over the rows whose limbs before it tie
// the group's, min_by / max_by's x over the rows whose y equals the
// group's extreme as a value (a NaN extreme ties nothing).
__device__ __forceinline__ i64 slot_value(const K6Desc& d, int s, int j, i64 row,
                                          const i64* group_raw) {
  const int kind = d.kind[s];
  const i64 none = slot_identity(d.slot_kind[d.slot[s] + j]);
  if (kind == S_ONE) return 1;
  if (kind == S_BY_X || kind == S_BY_XV) {
    const int y = s + (kind == S_BY_X ? 2 : 1);
    if (!d.valid[s][row] || !d.valid[y][row]) return none;
    const bool y_min = d.kind[y] == S_BY_Y_MIN;
    const i64 best = group_raw[d.slot[y]];
    const bool tie = d.data_kind[y] == DATA_F64
        ? __longlong_as_double(((const i64*)d.data[y])[row]) ==
              __longlong_as_double(minmax_value(best, y_min))
        : pk_load(d.data[y], d.data_kind[y], row) == best;
    if (!tie) return none;
    return kind == S_BY_XV ? 1 : by_key(d.data[s], d.data_kind[s], row, false);
  }
  if (!d.valid[s][row]) return none;
  switch (kind) {
    case S_VALID: return 1;
    case S_MIN_F64:
    case S_MAX_F64:  // by the order key (common.cuh)
      return minmax_key(data_bits(d.data[s], d.data_kind[s], row), kind == S_MIN_F64);
    case S_BY_Y_MIN:
    case S_BY_Y_MAX: return by_key(d.data[s], d.data_kind[s], row, kind == S_BY_Y_MIN);
    case S_MIN_LONG:
    case S_MAX_LONG: {  // the high limb, then the low one where the high one ties
      const i64* x = (const i64*)d.data[s] + 2 * row;
      if (j == 0) return x[0];
      return x[0] == group_raw[d.slot[s]] ? x[1] : none;
    }
    case S_MIN_D38:
    case S_MAX_D38: {  // limb j where the limbs before it tie
      const i64* x = (const i64*)d.data[s] + D38_LIMBS * row;
      for (int i = 0; i < j; ++i)
        if (x[i] != group_raw[d.slot[s] + i]) return none;
      return x[j];
    }
    case S_LIMBS_D38: return ((const i64*)d.data[s])[D38_LIMBS * row + j];  // as they are
    case S_LIMBS_SHORT:
    case S_LIMBS_LONG: {  // to_sum_limbs: each limb below 10^9 in size
      i64 x;
      if (kind == S_LIMBS_SHORT) {  // from_int64
        const i64 v = pk_load(d.data[s], d.data_kind[s], row);
        const i64 hi = fdiv(v, B18);
        x = j < 2 ? hi : v - hi * B18;
      } else {
        x = ((const i64*)d.data[s])[2 * row + (j >> 1)];
      }
      return (j & 1) ? fmod_(x, B9) : fdiv(x, B9);
    }
    default: return pk_load(d.data[s], d.data_kind[s], row);  // S_SUM, S_MIN/MAX, S_BAND/BOR
  }
}

// The slots an accumulate phase reduces: slot j[i] of state s[i].
struct K6Slots {
  int n;
  uint8_t s[K6_MAX_SLOTS];
  uint8_t j[K6_MAX_SLOTS];
};

// One accumulate phase over the m sorted live positions.  A warp takes
// one slot over a tile of K6_TILE positions, K6_ITEMS rows of 32 (lane
// i: position base + 32 k + i); the warps of a tile's slots are
// neighbours.  Group ids come from the heads' scan (the group of
// position p is scan[p + 1] - 1).  Phase 0 writes the representative
// keys, with a warp a tile when it has no slot (states all double).
static __global__ void __launch_bounds__(256, 1)
    k6_accumulate(const K6Desc d, const K6Slots sl, const i64* __restrict__ order, i64 m,
                  const int* __restrict__ scan, u64* __restrict__ raw, int phase) {
  const int lane = threadIdx.x & 31;
  const i64 warps = ((i64)gridDim.x * blockDim.x) >> 5;
  const int per_tile = sl.n > 0 ? sl.n : 1;
  const i64 work = (m + K6_TILE - 1) / K6_TILE * per_tile;
  for (i64 w = ((i64)blockIdx.x * blockDim.x + threadIdx.x) >> 5; w < work; w += warps) {
    const i64 t0 = w / per_tile * K6_TILE;
    const int a = (int)(w % per_tile);
    const i64 end = t0 + K6_TILE < m ? t0 + K6_TILE : m;
    int g[K6_ITEMS];
    i64 row[K6_ITEMS];
    unsigned heads[K6_ITEMS];  // a row's run heads (and positions past m)
#pragma unroll
    for (int k = 0; k < K6_ITEMS; ++k) {
      const i64 p = t0 + 32 * k + lane;
      const bool in = p < m;
      const int next = in ? scan[p + 1] : 0;
      g[k] = in ? next - 1 : -1;
      row[k] = in ? order[p] : 0;
      heads[k] = __ballot_sync(FULL_MASK, !in || next != scan[p]);
    }
    // the tile's first and last runs may go on in the tiles beside it
    const int g_first = scan[t0 + 1] - 1, g_last = scan[end] - 1;
    const bool open_first = !(heads[0] & 1u), open_last = end < m && scan[end + 1] == scan[end];
    if (phase == 0 && a == 0) {  // the representative keys, at the heads
#pragma unroll
      for (int k = 0; k < K6_ITEMS; ++k)
        if (g[k] >= 0 && ((heads[k] >> lane) & 1u))
          for (int c = 0; c < d.n_keys; ++c) {
            copy_key(d.key_src[c], d.key_dst[c], d.key_width[c], row[k], g[k]);
            d.key_dst_valid[c][g[k]] = d.key_valid[c][row[k]];
          }
    }
    if (sl.n == 0) continue;  // the keys alone
    const int s = sl.s[a], j = sl.j[a];
    const int slot = d.slot[s] + j;
    const int op = d.slot_kind[slot];
    const i64 none = slot_identity(op);
    i64 v[K6_ITEMS];  // every row's value first: their gathers in flight together
#pragma unroll
    for (int k = 0; k < K6_ITEMS; ++k)
      v[k] = g[k] >= 0 ? slot_value(d, s, j, row[k], (const i64*)raw + (i64)g[k] * d.raw_width)
                       : none;
    i64 carry = none;  // the open run's total over the rows before
#pragma unroll
    for (int k = 0; k < K6_ITEMS; ++k) {
      // the heads at or below this lane; none: the run began in a row before
      const unsigned low = heads[k] & (FULL_MASK >> (31 - lane));
      const int first = low ? 31 - __clz(low) : 0;
      i64 x = v[k];
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const i64 y = __shfl_up_sync(FULL_MASK, x, off);
        if (lane - off >= first) x = slot_fold(y, x, op);
      }
      if (!low) x = slot_fold(carry, x, op);
      const bool last = lane < 31 ? ((heads[k] >> (lane + 1)) & 1u) != 0
                                  : (k + 1 == K6_ITEMS ||
                                     (heads[k + 1 < K6_ITEMS ? k + 1 : k] & 1u));
      if (g[k] >= 0 && last) {
        u64* r = raw + (i64)g[k] * d.raw_width + slot;
        if (!(open_first && g[k] == g_first) && !(open_last && g[k] == g_last))
          *(i64*)r = x;  // the run's one writer
        else if (x != none)
          slot_combine(r, x, op);
      }
      carry = __shfl_sync(FULL_MASK, x, 31);
    }
  }
}

static __global__ void k6_finish(const K6Desc d, i64 groups, const i64* __restrict__ raw) {
  const i64 stride = (i64)gridDim.x * blockDim.x;
  for (i64 g = (i64)blockIdx.x * blockDim.x + threadIdx.x; g < groups; g += stride) {
    const i64* r = raw + g * d.raw_width;
    for (int s = 0; s < d.n_states; ++s) {
      const i64* v = r + d.slot[s];
      if (d.kind[s] == S_MIN_LONG || d.kind[s] == S_MAX_LONG) {
        d.out[s][2 * g] = v[0];
        d.out[s][2 * g + 1] = v[1];
        continue;
      }
      if (d.kind[s] >= S_LIMBS_D38 && d.kind[s] <= S_MAX_D38) {  // five limbs
        i64 w[D38_LIMBS];
        for (int j = 0; j < D38_LIMBS; ++j) w[j] = v[j];
        if (d.kind[s] == S_LIMBS_D38) w_norm(w);  // from_sum_limbs
        for (int j = 0; j < D38_LIMBS; ++j) d.out[s][D38_LIMBS * g + j] = w[j];
        continue;
      }
      if (d.kind[s] == S_MIN_F64 || d.kind[s] == S_MAX_F64) {
        const i64 x = minmax_value(v[0], d.kind[s] == S_MIN_F64);
        if (d.out_kind[s] == OUT_F32) ((float*)d.out[s])[g] = bits_f32(x);
        else d.out[s][g] = x;
        continue;
      }
      if (d.out_kind[s] == OUT_I16) {
        ((short*)d.out[s])[g] = (short)narrow_extreme_bits(v[0], 16);
        continue;
      }
      if (d.out_kind[s] == OUT_I8) {
        ((signed char*)d.out[s])[g] = (signed char)narrow_extreme_bits(v[0], 8);
        continue;
      }
      if (d.kind[s] == S_BY_XV) {
        d.out[s][g] = v[0] > 0;
        continue;
      }
      if (d.out_kind[s] == OUT_F64) {  // a min_by / max_by double: its order key back
        d.out[s][g] = minmax_value(v[0], d.kind[s] == S_BY_Y_MIN);
        continue;
      }
      if (d.out_kind[s] == OUT_I32) {
        ((int*)d.out[s])[g] = narrow_extreme(v[0]);
        continue;
      }
      if (d.out_kind[s] == OUT_BOOL) {  // an empty state: the fold's neutral value
        ((uint8_t*)d.out[s])[g] = v[0] == I64_MIN ? 0 : v[0] != 0;
        continue;
      }
      if (d.kind[s] != S_LIMBS_SHORT && d.kind[s] != S_LIMBS_LONG) {
        d.out[s][g] = v[0];
        continue;
      }
      // from_sum_limbs, then normalize (ops/decimal128.py)
      i64 h1 = v[0], h0 = v[1], l1 = v[2], l0 = v[3];
      i64 c = fdiv(l0, B9);
      l0 -= c * B9;
      l1 += c;
      c = fdiv(l1, B9);
      l1 -= c * B9;
      const i64 hi_extra = c;
      i64 lo = l1 * B9 + l0;
      c = fdiv(h0, B9);
      h0 -= c * B9;
      h1 += c;
      i64 hi = wadd(wadd(wmul(h1, B9), h0), hi_extra);
      c = fdiv(lo, B18);
      lo -= c * B18;
      d.out[s][2 * g] = wadd(hi, c);
      d.out[s][2 * g + 1] = lo;
    }
  }
}

// The positions of each tile of SCAN_TILE where `pred` holds, read
// coalesced.
template <class Pred>
static __global__ void k6_tile_counts(const Pred pred, i64 n, int* __restrict__ counts) {
  typedef cub::BlockReduce<int, SCAN_THREADS> Reduce;
  __shared__ typename Reduce::TempStorage tmp;
  const i64 base = (i64)blockIdx.x * SCAN_TILE;
  int c = 0;
  for (int j = threadIdx.x; j < SCAN_TILE; j += SCAN_THREADS) c += base + j < n && pred(base + j);
  const int total = Reduce(tmp).Sum(c);
  if (threadIdx.x == 0) counts[blockIdx.x] = total;
}

// A live row: its mask set and its masked key not the sentinel (a dead
// row's key is not read).
struct LiveRow {
  const uint8_t* mask;
  const i64* masked;
  __device__ __forceinline__ bool operator()(i64 i) const {
    return mask[i] && masked[i] != I64_MAX;
  }
};

// A sorted position that starts a run (dead rows' sentinels sort last
// and start none).
struct RunHead {
  const i64* sk;
  __device__ __forceinline__ bool operator()(i64 p) const {
    return sk[p] != I64_MAX && (p == 0 || sk[p] != sk[p - 1]);
  }
};

// Each tile's live rows to their ranks (prefix: the scanned tile
// counts, the live count at [tiles]); with `tail`, the dead rows' ids
// after the live count.
static __global__ void k6_compact_live(const LiveRow live_of, i64 n,
                                       const int* __restrict__ prefix, i64* __restrict__ keys,
                                       i64* __restrict__ rows, i64* __restrict__ tail) {
  typedef cub::BlockScan<int, SCAN_THREADS> Scan;
  __shared__ typename Scan::TempStorage tmp;
  const i64 base = (i64)blockIdx.x * SCAN_TILE + (i64)threadIdx.x * SCAN_ITEMS;
  bool f[SCAN_ITEMS];
  int c = 0;
#pragma unroll
  for (int j = 0; j < SCAN_ITEMS; ++j) {
    f[j] = base + j < n && live_of(base + j);
    c += f[j];
  }
  int excl;
  Scan(tmp).ExclusiveSum(c, excl);
  const i64 live = prefix[gridDim.x];
  i64 rank = prefix[blockIdx.x] + excl;
#pragma unroll
  for (int j = 0; j < SCAN_ITEMS; ++j) {
    const i64 i = base + j;
    if (i >= n) break;
    if (f[j]) {
      keys[rank] = live_of.masked[i];
      rows[rank++] = i;
    } else if (tail != nullptr) {
      tail[live + i - rank] = i;
    }
  }
}

// The live rows of a page of n rows (row_mask, and their masked keys),
// counted per tile and scanned: partials, scan_tiles(n) + 1 ints, ends
// with the live count at partials[scan_tiles(n)].
extern "C" int k6_count_live(const void* row_mask, const void* masked, i64 n, void* partials,
                             void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const i64 tiles = scan_tiles(n);
  if (tiles == 0) {
    cudaMemsetAsync(partials, 0, sizeof(int), s);
    return (int)cudaGetLastError();
  }
  const LiveRow live_of{(const uint8_t*)row_mask, (const i64*)masked};
  k6_tile_counts<<<(unsigned)tiles, SCAN_THREADS, 0, s>>>(live_of, n, (int*)partials);
  scan_partials<int><<<1, SCAN_THREADS, 0, s>>>((int*)partials, tiles);
  return (int)cudaGetLastError();
}

// Compacts the live rows counted by k6_count_live (partials), in input
// order: keys[0..live) and rows[0..live) their keys and row ids; with
// `tail`, tail[live..n) the dead rows' ids (tail may be rows itself).
extern "C" int k6_compact_rows(const void* row_mask, const void* masked, i64 n, void* keys,
                               void* rows, void* tail, const void* partials, void* stream) {
  const i64 tiles = scan_tiles(n);
  if (tiles == 0) return (int)cudaGetLastError();
  const LiveRow live_of{(const uint8_t*)row_mask, (const i64*)masked};
  k6_compact_live<<<(unsigned)tiles, SCAN_THREADS, 0, (cudaStream_t)stream>>>(
      live_of, n, (const int*)partials, (i64*)keys, (i64*)rows, (i64*)tail);
  return (int)cudaGetLastError();
}

// Each tile's exclusive head counts from its prefix (the head flags
// recomputed from the keys), and the row ids through the sort's
// permutation (perm null: the rows are in place already); with
// live_out, the live positions' count (the first sentinel's position).
static __global__ void k6_head_scan(const i64* __restrict__ sk, i64 m,
                                    const i64* __restrict__ perm, const i64* __restrict__ rows,
                                    i64* __restrict__ order, const int* __restrict__ prefix,
                                    int* __restrict__ scan, int* __restrict__ live_out) {
  typedef cub::BlockScan<int, SCAN_THREADS> Scan;
  __shared__ typename Scan::TempStorage tmp;
  const RunHead head{sk};
  const i64 base = (i64)blockIdx.x * SCAN_TILE + (i64)threadIdx.x * SCAN_ITEMS;
  bool f[SCAN_ITEMS];
  int c = 0;
#pragma unroll
  for (int j = 0; j < SCAN_ITEMS; ++j) {
    f[j] = base + j < m && head(base + j);
    c += f[j];
  }
  int run;
  Scan(tmp).ExclusiveSum(c, run);
  run += prefix[blockIdx.x];
#pragma unroll
  for (int j = 0; j < SCAN_ITEMS; ++j) {
    const i64 p = base + j;
    if (p >= m) break;
    scan[p] = run;
    run += f[j];
    if (perm != nullptr) order[p] = rows[perm[p]];
    if (live_out != nullptr && sk[p] != I64_MAX && (p + 1 == m || sk[p + 1] == I64_MAX))
      *live_out = (int)(p + 1);
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) scan[m] = prefix[gridDim.x];
}

// Over m sorted keys (dead rows' sentinels last, if any): order[0..m) =
// rows[perm] (perm null: left as it is), and scan (m + 1 ints) the
// exclusive count of run heads before each position, the group count
// at [m]; with live_out, the live positions' count there.  partials:
// scan_tiles(m) + 1 ints.
extern "C" int k6_group_heads(const void* sorted_keys, i64 m, const void* perm, const void* rows,
                              void* order, void* scan, void* partials, void* live_out,
                              void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (live_out != nullptr) cudaMemsetAsync(live_out, 0, sizeof(int), s);
  const i64 tiles = scan_tiles(m);
  if (tiles == 0) {
    cudaMemsetAsync(scan, 0, sizeof(int), s);
    return (int)cudaGetLastError();
  }
  k6_tile_counts<<<(unsigned)tiles, SCAN_THREADS, 0, s>>>(RunHead{(const i64*)sorted_keys}, m,
                                                          (int*)partials);
  scan_partials<int><<<1, SCAN_THREADS, 0, s>>>((int*)partials, tiles);
  k6_head_scan<<<(unsigned)tiles, SCAN_THREADS, 0, s>>>(
      (const i64*)sorted_keys, m, (const i64*)perm, (const i64*)rows, (i64*)order,
      (const int*)partials, (int*)scan, (int*)live_out);
  return (int)cudaGetLastError();
}

// The run of each group: starts[g] = the first sorted position of group
// g, starts[groups] = m, the live positions' count.
static __global__ void k6_starts(const int* __restrict__ scan, i64 m, i64 groups,
                                 i64* __restrict__ starts) {
  const i64 stride = (i64)gridDim.x * blockDim.x;
  const i64 t = (i64)blockIdx.x * blockDim.x + threadIdx.x;
  if (t == 0) starts[groups] = m;
  for (i64 p = t; p < m; p += stride)
    if (scan[p + 1] != scan[p]) starts[scan[p]] = p;
}

// starts: groups + 1 int64.
extern "C" int k6_run_starts(const void* scan, i64 m, i64 groups, void* starts, void* stream) {
  k6_starts<<<grid_for(m, 256, 8), 256, 0, (cudaStream_t)stream>>>((const int*)scan, m, groups,
                                                                    (i64*)starts);
  return (int)cudaGetLastError();
}

// Per-group states of `groups` groups over the m sorted live positions
// (order: their row ids; scan: k6_group_heads').  raw: groups *
// raw_width int64 of scratch.  Key columns gather into key_dst (groups
// elements of key_width bytes); state s writes out[s].
extern "C" int k6_group_states(const void* order, i64 m, const void* scan, i64 groups,
                               int n_keys, const i64* key_src, const i64* key_valid,
                               const i64* key_dst, const i64* key_dst_valid,
                               const int* key_width, int n_states,
                               const int* kind, const i64* data, const int* data_kind,
                               const i64* valid, const i64* out, const int* out_kind,
                               void* raw, void* stream) {
  if (n_keys > PK_MAX_KEYS || n_states > K6_MAX_STATES) return (int)cudaErrorInvalidValue;
  K6Desc d;
  d.n_keys = n_keys;
  for (int k = 0; k < n_keys; ++k) {
    d.key_src[k] = (const uint8_t*)key_src[k];
    d.key_valid[k] = (const uint8_t*)key_valid[k];
    d.key_dst[k] = (uint8_t*)key_dst[k];
    d.key_dst_valid[k] = (uint8_t*)key_dst_valid[k];
    d.key_width[k] = key_width[k];
  }
  d.n_states = n_states;
  int w = 0;
  int phases = 1;  // accumulate launches: 2 for a long min/max or min_by, 5 for a wide min/max
  for (int s = 0; s < n_states; ++s) {
    if (!is_int_state(kind[s])) return (int)cudaErrorInvalidValue;
    const int width = state_width(kind[s]);
    if (w + width > K6_MAX_SLOTS) return (int)cudaErrorInvalidValue;
    d.kind[s] = kind[s];
    d.slot[s] = w;
    // S_BY_X's partner y is two states on, S_BY_XV's one
    if ((kind[s] == S_BY_X && !(s + 2 < n_states && kind[s + 1] == S_BY_XV &&
                                (kind[s + 2] == S_BY_Y_MIN || kind[s + 2] == S_BY_Y_MAX))) ||
        (kind[s] == S_BY_XV && (s == 0 || kind[s - 1] != S_BY_X)))
      return (int)cudaErrorInvalidValue;
    const int sk_kind = (kind[s] == S_MIN || kind[s] == S_MIN_LONG || kind[s] == S_MIN_F64 ||
                         kind[s] == S_BY_Y_MIN || kind[s] == S_MIN_D38)
        ? SLOT_MIN
        : (kind[s] == S_MAX || kind[s] == S_MAX_LONG || kind[s] == S_MAX_F64 ||
           kind[s] == S_BY_Y_MAX || kind[s] == S_BY_X || kind[s] == S_MAX_D38) ? SLOT_MAX
        : kind[s] == S_BAND ? SLOT_AND : kind[s] == S_BOR ? SLOT_OR : SLOT_ADD;
    for (int j = 0; j < width; ++j) d.slot_kind[w + j] = sk_kind;
    if ((kind[s] == S_MIN_LONG || kind[s] == S_MAX_LONG || kind[s] == S_BY_X) && phases < 2)
      phases = 2;
    if (kind[s] == S_MIN_D38 || kind[s] == S_MAX_D38) phases = D38_LIMBS;
    w += width;
    d.data[s] = (const void*)data[s];
    d.data_kind[s] = data_kind[s];
    d.valid[s] = (const uint8_t*)valid[s];
    d.out[s] = (i64*)out[s];
    d.out_kind[s] = out_kind[s];
  }
  d.raw_width = w;
  cudaStream_t st = (cudaStream_t)stream;
  if (groups == 0) return (int)cudaGetLastError();
  k6_init<<<grid_for(groups * w, 256, 8), 256, 0, st>>>(d, groups * w, (i64*)raw);
  const i64 tiles = (m + K6_TILE - 1) / K6_TILE;
  for (int phase = 0; phase < phases; ++phase) {  // one warp a (tile, slot)
    K6Slots sl;
    sl.n = 0;
    for (int s = 0; s < n_states; ++s)
      for (int j = 0; j < state_width(kind[s]); ++j)
        if (in_phase(kind[s], j, phase)) {
          sl.s[sl.n] = (uint8_t)s;
          sl.j[sl.n++] = (uint8_t)j;
        }
    if (sl.n > 0 || phase == 0)  // phase 0 writes the keys
      k6_accumulate<<<grid_for(tiles * (sl.n > 0 ? sl.n : 1) * 32, 256, 8), 256, 0, st>>>(
          d, sl, (const i64*)order, m, (const int*)scan, (u64*)raw, phase);
  }
  k6_finish<<<grid_for(groups, 256, 8), 256, 0, st>>>(d, groups, (const i64*)raw);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// double states
// ---------------------------------------------------------------------------

// base[g]: the number of chunks of group g (base[groups]: 0), to be
// scanned into each group's first chunk
static __global__ void k6_run_chunks(const i64* __restrict__ starts, i64 groups,
                                     int* __restrict__ base) {
  const i64 g = (i64)blockIdx.x * blockDim.x + threadIdx.x;
  if (g < groups) base[g] = (int)((starts[g + 1] - starts[g] + K6_DSUM_CHUNK - 1) / K6_DSUM_CHUNK);
  else if (g == groups) base[g] = 0;
}

static __global__ void k6_chunk_groups(const int* __restrict__ base, i64 groups,
                                       int* __restrict__ chunk_group) {
  const i64 g = (i64)blockIdx.x * blockDim.x + threadIdx.x;
  if (g >= groups) return;
  for (int c = base[g]; c < base[g + 1]; ++c) chunk_group[c] = (int)g;
}

// One thread per chunk: the chunk's values in sorted order from 0.0.
// pass 0 adds x (a merge: s_i); pass 1 adds (x - mu)^2 (a variance
// merge: m2_i + c_i (mu_i - mu)^2, mu_i = s_i / max(c_i, 1)); the
// moments' passes 1..3 add dx^2, dx^2 dx, dx^2 dx^2 (a merge: the M2,
// M3, M4 terms of Chan's form with d = mu_i - mu).
static __global__ void k6_dchunks(const i64* __restrict__ order, const i64* __restrict__ starts,
                                  const int* __restrict__ base,
                                  const int* __restrict__ chunk_group, i64 groups, int kind,
                                  int pass, const double* __restrict__ x, int x_f32,
                                  const uint8_t* __restrict__ valid,
                                  const double* __restrict__ m2_in,
                                  const double* __restrict__ m3_in,
                                  const double* __restrict__ m4_in,
                                  const i64* __restrict__ c_in, const double* __restrict__ mu,
                                  double* __restrict__ part) {
  const i64 chunks = base[groups];
  const i64 stride = (i64)gridDim.x * blockDim.x;
  for (i64 t = (i64)blockIdx.x * blockDim.x + threadIdx.x; t < chunks; t += stride) {
    const int g = chunk_group[t];
    const i64 p0 = starts[g] + (t - base[g]) * K6_DSUM_CHUNK;
    const i64 p1 = p0 + K6_DSUM_CHUNK < starts[g + 1] ? p0 + K6_DSUM_CHUNK : starts[g + 1];
    double acc = 0.0;
    for (i64 p = p0; p < p1; ++p) {
      const i64 row = order[p];
      if (!valid[row]) continue;
      double v = kind == S_HLL ? hll_weight(((const i64*)x)[row])
                 : x_f32 ? (double)((const float*)x)[row] : x[row];
      if (pass == 1 && kind == S_VAR_MERGE) {
        const i64 c = c_in[row];
        const double cf = __ll2double_rn(c);
        const double mu_i = __ddiv_rn(v, cf > 1.0 ? cf : 1.0);
        const double dev = c > 0 ? __dsub_rn(mu_i, mu[g]) : 0.0;
        v = __dadd_rn(m2_in[row], __dmul_rn(__dmul_rn(cf, dev), dev));
      } else if (pass > 0 && kind == S_MOM_MERGE) {
        double t[3];
        moment_terms(v, m2_in[row], m3_in[row], m4_in[row], c_in[row], mu[g], t);
        v = pass == 1 ? t[0] : pass == 2 ? t[1] : t[2];
      } else if (pass > 0) {
        const double dx = __dsub_rn(v, mu[g]);
        const double dx2 = __dmul_rn(dx, dx);
        v = pass == 1 ? dx2 : pass == 2 ? __dmul_rn(dx2, dx) : __dmul_rn(dx2, dx2);
      }
      acc = __dadd_rn(acc, v);
    }
    part[t] = acc;
  }
}

// One thread per group: its chunk partials pairwise in place, the sum
// into out; with cnt set, mu = sum / max(cnt, 1) into mu_out.
static __global__ void k6_dtree(const int* __restrict__ base, i64 groups,
                                double* __restrict__ part, double* __restrict__ out,
                                const i64* __restrict__ cnt, double* __restrict__ mu_out) {
  const i64 g = (i64)blockIdx.x * blockDim.x + threadIdx.x;
  if (g >= groups) return;
  double* p = part + base[g];
  const int m = base[g + 1] - base[g];
  for (int w = 1; w < m; w *= 2)
    for (int k = 0; k + w < m; k += 2 * w) p[k] = __dadd_rn(p[k], p[k + w]);
  out[g] = p[0];
  if (cnt != nullptr) mu_out[g] = __ddiv_rn(p[0], __ll2double_rn(cnt[g] > 1 ? cnt[g] : 1));
}

// A double state over the sorted run of each of `groups` groups (m
// sorted live positions, order their row ids, scan k6_group_heads'): kind
// S_DSUM and S_HLL write out_s; S_VAR and S_VAR_MERGE write out_s and
// out_m2 (out_m2 holds mu between the passes), S_MOM and S_MOM_MERGE
// out_s, out_m2, out_m3 and out_m4 (out_m4 holds mu until the last
// pass), with cnt the group counts of their integer state.  x: the
// double argument (x_f32: a REAL's float32, for S_DSUM; a merge: s_i),
// m2_in, m3_in, m4_in and c_in a merge's m2_i, m3_i, m4_i and c_i.
// Scratch: starts groups + 1 int64, base groups + 1 ints, partials
// scan_tiles(groups + 1) + 1 ints, chunk_group and part `bound` (>= the
// chunk count) ints and doubles.
extern "C" int k6_double_state(const void* order, i64 m, const void* scan, i64 groups,
                               int kind, const void* x, int x_f32, const void* valid,
                               const void* m2_in, const void* m3_in, const void* m4_in,
                               const void* c_in, const void* cnt,
                               void* out_s, void* out_m2, void* out_m3, void* out_m4,
                               void* starts, void* base, void* partials, void* chunk_group,
                               void* part, i64 bound, void* stream) {
  if ((kind < S_DSUM || kind > S_VAR_MERGE) && kind != S_HLL && kind != S_MOM &&
      kind != S_MOM_MERGE)
    return (int)cudaErrorInvalidValue;
  if (groups == 0) return (int)cudaGetLastError();
  if ((m + K6_DSUM_CHUNK - 1) / K6_DSUM_CHUNK + groups > bound) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  k6_starts<<<grid_for(m, 256, 8), 256, 0, st>>>((const int*)scan, m, groups, (i64*)starts);
  k6_run_chunks<<<(int)((groups + 256) / 256), 256, 0, st>>>((const i64*)starts, groups,
                                                             (int*)base);
  scan_exclusive_inplace((int*)base, groups + 1, (int*)partials, st);
  k6_chunk_groups<<<(int)((groups + 255) / 256), 256, 0, st>>>((const int*)base, groups,
                                                               (int*)chunk_group);
  const bool var = kind == S_VAR || kind == S_VAR_MERGE;
  const bool mom = kind == S_MOM || kind == S_MOM_MERGE;
  double* outs[4] = {(double*)out_s, (double*)out_m2, (double*)out_m3, (double*)out_m4};
  double* mu = mom ? (double*)out_m4 : (double*)out_m2;
  for (int pass = 0; pass < (var ? 2 : mom ? 4 : 1); ++pass) {
    k6_dchunks<<<grid_for(bound, 128, 8), 128, 0, st>>>(
        (const i64*)order, (const i64*)starts, (const int*)base, (const int*)chunk_group,
        groups, kind, pass, (const double*)x, x_f32, (const uint8_t*)valid,
        (const double*)m2_in,
        (const double*)m3_in, (const double*)m4_in, (const i64*)c_in,
        pass ? (const double*)mu : nullptr, (double*)part);
    k6_dtree<<<(int)((groups + 127) / 128), 128, 0, st>>>(
        (const int*)base, groups, (double*)part, outs[pass],
        (var || mom) && pass == 0 ? (const i64*)cnt : nullptr, mu);
  }
  return (int)cudaGetLastError();
}

// The raw varchar extremes (the reference's _minmax_lanes :1627 over
// ops/rawstring.py pack_lanes' k int64 lanes, on the sort path of
// _partial_states :410 and in _merge_states :1085): one warp a group's
// run of sorted positions.  Each lane of the warp walks every 32nd
// position and keeps its best valid row, comparing whole lane rows
// (lexicographic, signed int64); the warp then reduces its 32 rows by
// shuffles, and lane 0 writes the winner's lanes (the identity in every
// lane where the group has no valid row).  No atomics: every output has
// one writer, and ties are equal lanes, so the result does not depend
// on the schedule.
__device__ __forceinline__ bool lanes_before(const i64* lanes, int k, i64 a, i64 b,
                                             bool is_min) {
  const i64* x = lanes + (i64)k * a;
  const i64* y = lanes + (i64)k * b;
  for (int j = 0; j < k; ++j)
    if (x[j] != y[j]) return is_min ? x[j] < y[j] : x[j] > y[j];
  return false;
}

static __global__ void k6_lanes(const i64* __restrict__ order, const i64* __restrict__ starts,
                                i64 groups, const i64* __restrict__ lanes, int k,
                                const uint8_t* __restrict__ valid, int is_min,
                                i64* __restrict__ out) {
  const i64 warps = ((i64)gridDim.x * blockDim.x) >> 5;
  const int lane = threadIdx.x & 31;
  for (i64 g = ((i64)blockIdx.x * blockDim.x + threadIdx.x) >> 5; g < groups; g += warps) {
    i64 best = -1;
    for (i64 p = starts[g] + lane; p < starts[g + 1]; p += 32) {
      const i64 r = order[p];
      if (valid[r] && (best < 0 || lanes_before(lanes, k, r, best, is_min != 0))) best = r;
    }
    for (int off = 16; off > 0; off >>= 1) {
      const i64 o = __shfl_down_sync(0xffffffffu, best, off);
      if (o >= 0 && (best < 0 || lanes_before(lanes, k, o, best, is_min != 0))) best = o;
    }
    if (lane == 0)
      for (int j = 0; j < k; ++j)
        out[(i64)k * g + j] = best >= 0 ? lanes[(i64)k * best + j] : (is_min ? I64_MAX : I64_MIN);
  }
}

// out: (groups, k) int64.  order: the row at each sorted position;
// starts: (groups + 1) int64, each group's first position.
extern "C" int k6_lane_extremes(const void* order, const void* starts, i64 groups,
                                const void* lanes, int k, const void* valid, int is_min,
                                void* out, void* stream) {
  if (groups < 0 || k < 1) return (int)cudaErrorInvalidValue;
  if (groups == 0) return 0;
  const int threads = 256;
  i64 blocks = (groups * 32 + threads - 1) / threads;
  if (blocks > 132 * 16) blocks = 132 * 16;
  k6_lanes<<<(int)blocks, threads, 0, (cudaStream_t)stream>>>(
      (const i64*)order, (const i64*)starts, groups, (const i64*)lanes, k,
      (const uint8_t*)valid, is_min, (i64*)out);
  return (int)cudaGetLastError();
}
