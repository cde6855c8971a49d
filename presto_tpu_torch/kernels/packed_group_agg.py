"""K2 ``packed_group_agg``: partial aggregation states per packed group.

:func:`packed_group_agg` computes, for each of ``n_groups`` slots, the
partial states the reference's ``grouped_aggregate(mode="partial")``
emits on its global and packed-direct branches: counts, short sums in
one int64, long sums as two normalised base-10^18 limbs, the least or
greatest value of a short (int32/int64) or long (two-limb) argument
beside its count of non-null rows, a double sum beside its count
(SUM_DOUBLE), or the variance state ``(s, m2, cnt)`` of a double
argument (VARIANCE), a double's, a boolean's or a varchar rank's
least or greatest value, bool_and / bool_or's count of true,
bitwise_and_agg / bitwise_or_agg's fold and hll_merge's sum of 2^-rho
(each beside its count), checksum's wrapping sum of K1's per-row
hashes (CHECKSUM), a wide decimal's sum and least or greatest value
(SUM_D38, MIN_D38, MAX_D38: five limbs beside the count), the central
moments ``(s, m2, m3, m4, cnt)`` of a double argument (MOMENTS:
skewness, kurtosis), and min_by / max_by's coupled extreme as two
entries (BY_X then BY_Y_MIN or BY_Y_MAX: the extreme of ``y`` with its
count of valid rows, then the greatest ``x`` among the rows whose
``y`` equals it, with a 0/1 flag that one was valid), plus the
``present`` flag of each slot.  Double
sums add in one fixed order, the same on the card and here
(:func:`chunk_sums_plain`), so the card's states equal the twin's bit
for bit.  On a CUDA tensor it launches
``csrc/packed_group_agg.cu``; on a CPU tensor it runs
:func:`packed_group_agg_plain`.
"""

from __future__ import annotations

import ctypes
from typing import List, Optional, Sequence, Tuple

import torch

from presto_tpu_torch.kernels import build
from presto_tpu_torch.ops import decimal128 as d128

# aggregate kinds: keep in step with csrc/packed_group_agg.cu
COUNT_STAR, COUNT, SUM_SHORT, SUM_LONG, MIN_SHORT, MAX_SHORT, MIN_LONG, MAX_LONG, \
    SUM_LONG_ARG, SUM_DOUBLE, VARIANCE, MIN_DOUBLE, MAX_DOUBLE, BOOL_COUNT, BIT_AND, BIT_OR, \
    HLL_SUM, CHECKSUM, MOMENTS, BY_Y_MIN, BY_Y_MAX, BY_X, SUM_D38, MIN_D38, MAX_D38, \
    MIN_LANES, MAX_LANES = range(27)
# MIN_LANES / MAX_LANES: a raw varchar's least or greatest value as its
# ``(n, k)`` int64 lanes (``ops/rawstring.pack_lanes``: lanes compare as
# signed int64 in the bytes' order), lane by lane, most significant
# first, beside its count; the entry point ``k2_lane_extremes`` computes
# the lanes, the main kernel the count (a COUNT over the argument's
# validity)
# SUM_D38: a wide (decimal(37..38), five base-10^9 limbs) argument's sum,
# its limbs added as they are (each below 10^9 in size, so 2^23 rows
# cannot wrap a lane) and normalised (``_norm_wide``); MIN_D38 / MAX_D38:
# its least or greatest value, limb by limb, most significant first
# MIN_DOUBLE / MAX_DOUBLE: a double's extreme (-0.0 below 0.0, NaN
# winning both, as the reference's segment_min/segment_max); BOOL_COUNT:
# bool_and / bool_or / every's (count of true, count); BIT_AND / BIT_OR:
# bitwise_and_agg / bitwise_or_agg's (fold, count); HLL_SUM: hll_merge's
# (sum of 2^-rho, count of present buckets), a double state;
# CHECKSUM: the wrapping sum of int64 values (K1 hashed them); MOMENTS:
# (s, m2, m3, m4, cnt) of a double, four fixed-order passes; BY_X and
# the BY_Y entry right after it: min_by / max_by's (x, x flag) and
# (y, count of valid y), y an integer, a double (its min/max order
# key: NaN wins, and then no row ties it) or a varchar's collation rank.
# A SMALLINT or TINYINT argument (MIN_SHORT, MAX_SHORT, SUM_SHORT) reads
# sign-extended, its min/max stored back narrowed; a REAL one
# (SUM_DOUBLE, MIN_DOUBLE, MAX_DOUBLE) widens exactly to a double, its
# min/max stored back as float32.
RAW_WIDTH = {COUNT_STAR: 1, COUNT: 1, SUM_SHORT: 2, SUM_LONG: 5, MIN_SHORT: 2, MAX_SHORT: 2,
             MIN_LONG: 3, MAX_LONG: 3, SUM_LONG_ARG: 5, SUM_DOUBLE: 1, VARIANCE: 1,
             MIN_DOUBLE: 2, MAX_DOUBLE: 2, BOOL_COUNT: 2, BIT_AND: 2, BIT_OR: 2, HLL_SUM: 1,
             CHECKSUM: 1, MOMENTS: 1, BY_Y_MIN: 2, BY_Y_MAX: 2, BY_X: 2, SUM_D38: 6,
             MIN_D38: 6, MAX_D38: 6}
BY_Y = (BY_Y_MIN, BY_Y_MAX)
EXTREMES = (MIN_SHORT, MAX_SHORT, MIN_LONG, MAX_LONG, MIN_DOUBLE, MAX_DOUBLE, MIN_D38,
            MAX_D38)
LANES = (MIN_LANES, MAX_LANES)
LONG_ARG = (MIN_LONG, MAX_LONG, SUM_LONG_ARG)  # kinds whose argument is (n, 2) limbs
D38_ARG = (SUM_D38, MIN_D38, MAX_D38)  # kinds whose argument is (n, 5) limbs
DOUBLE_ARG = (SUM_DOUBLE, VARIANCE, MIN_DOUBLE, MAX_DOUBLE, MOMENTS)  # a double argument
# states that add doubles in the fixed order (one slot at most here)
DOUBLE_STATES = (SUM_DOUBLE, VARIANCE, HLL_SUM, MOMENTS)
KIND_NAMES = {MIN_DOUBLE: "min_double", MAX_DOUBLE: "max_double", BOOL_COUNT: "bool",
              BIT_AND: "bitwise", BIT_OR: "bitwise", HLL_SUM: "hll", CHECKSUM: "checksum",
              MOMENTS: "moments", BY_Y_MIN: "min_by", BY_Y_MAX: "min_by", BY_X: "min_by",
              SUM_D38: "d38", MIN_D38: "d38", MAX_D38: "d38"}
# the slots a double state may have here: one, the global aggregate's
# (ops/aggregate.takes_sort_path sends keyed double states to K6, so
# every keyed double sum has one order, K6's)
DOUBLE_SLOT_LIMIT = 1
# rows per chunk of the fixed summation order (csrc/packed_group_agg.cu)
DSUM_CHUNK = 256
MAX_KEYS = 16
MAX_AGGS = 32
_KINDS = {torch.bool: 0, torch.int32: 1, torch.int64: 2, torch.int16: 5, torch.int8: 6}
KIND_D128, KIND_F64, KIND_F32, KIND_D38 = 3, 4, 7, 8
_FLOATS = (torch.float64, torch.float32)

launches = 0
#: launches whose aggregates include a min or max
minmax_launches = 0
#: launches with a variance state, and with a double sum
variance_launches = 0
double_sum_launches = 0
#: launches by the eighth slice's kinds (KIND_NAMES), min/max over
#: booleans ("min_bool"), and states over a SMALLINT, TINYINT or REAL
#: argument ("narrow")
kind_launches: dict = {}

# key: (data, valid, lo, card); agg: (kind, data or None, valid or None)
Key = Tuple[torch.Tensor, torch.Tensor, int, int]
Agg = Tuple[int, Optional[torch.Tensor], Optional[torch.Tensor]]


def identity(is_min: bool, dtype: torch.dtype) -> int:
    """The value an empty min (max) state holds: its storage's greatest
    (least) value, as the reference's segment_min (segment_max) leaves
    an empty segment."""
    info = torch.iinfo(dtype)
    return info.max if is_min else info.min


def seg_extreme(vals: torch.Tensor, slot: torch.Tensor, n_slots: int, is_min: bool):
    """Per-slot least (greatest) of ``vals`` (int64), the identity where
    a slot gets none; rows with ``slot == n_slots`` are dropped."""
    out = torch.full((n_slots + 1,), identity(is_min, torch.int64), dtype=torch.int64,
                     device=vals.device)
    out.scatter_reduce_(0, slot, vals, "amin" if is_min else "amax")
    return out[:n_slots]


def seg_extreme_long(limbs: torch.Tensor, slot: torch.Tensor, n_slots: int, is_min: bool):
    """The reference's ``_minmax_long``, over two or five limbs: the
    most significant limb's extreme per slot, then each next limb's
    among the rows that tie on every limb before it (an empty slot:
    the identity in every limb)."""
    at = torch.clamp(slot, max=max(n_slots - 1, 0))
    tie = slot < n_slots
    best = []
    for j in range(limbs.shape[1]):
        b = seg_extreme(limbs[:, j], torch.where(tie, slot, torch.full_like(slot, n_slots)),
                        n_slots, is_min)
        best.append(b)
        tie = tie & (limbs[:, j] == b[at])
    return torch.stack(best, dim=1)


def narrow(ext: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """An int64 extreme state in the argument's storage (the int64
    identities become the narrower type's; a boolean's become the
    neutral value of its fold: true for min, false for max)."""
    if dtype == torch.int64:
        return ext
    if dtype == torch.bool:
        return torch.where(ext == torch.iinfo(torch.int64).min, False, ext != 0)
    big, small = torch.iinfo(torch.int64), torch.iinfo(dtype)
    out = torch.where(ext == big.max, small.max, torch.where(ext == big.min, small.min, ext))
    return out.to(dtype)


_I64_MIN, _I64_MAX = -(1 << 63), (1 << 63) - 1
_NAN = 0x7FF8000000000000  # the canonical NaN's bits


def minmax_key(x: torch.Tensor, is_min: bool) -> torch.Tensor:
    """A double's min/max order key (csrc/common.cuh ``minmax_key``):
    -0.0 below 0.0, NaN past every number on the side where it wins."""
    from presto_tpu_torch.kernels.expr_eval import double_key

    nan_key = (_NAN | _I64_MIN) ^ _I64_MAX if is_min else _NAN
    return torch.where(torch.isnan(x), nan_key, double_key(x))


def minmax_value(key: torch.Tensor, is_min: bool) -> torch.Tensor:
    """A min/max key back to its double: the identity (an empty state)
    to +inf (min) or -inf (max), any NaN to the canonical one."""
    from presto_tpu_torch.kernels.expr_eval import double_key

    x = double_key(key).view(torch.float64)
    empty = key == (_I64_MAX if is_min else _I64_MIN)
    x = torch.where(empty, float("inf") if is_min else float("-inf"), x)
    return torch.where(torch.isnan(x), float("nan"), x)


def by_key(x: torch.Tensor, is_min: bool) -> torch.Tensor:
    """The int64 order key of min_by / max_by's ``y`` (``is_min``: the
    min side) or ``x`` (the max side): a double's min/max key, an
    integer as it is."""
    if x.dtype == torch.float64:
        return minmax_key(x, is_min)
    return x.to(torch.int64)


def by_value(key: torch.Tensor, is_min: bool, dtype: torch.dtype) -> torch.Tensor:
    """A min_by / max_by key back in the state's storage (an empty
    state: the extreme's identity)."""
    if dtype == torch.float64:
        return minmax_value(key, is_min)
    return narrow(key, dtype)


def by_tie(y: torch.Tensor, best: torch.Tensor) -> torch.Tensor:
    """Rows whose ``y`` equals the group's extreme, compared as values
    (the reference's ``y == y_best``): a NaN extreme ties no row, and a
    double -0.0 ties 0.0."""
    return y == best


def seg_by(x, xv, y, yv, slot, n_slots: int, y_min: bool):
    """min_by / max_by's two phases per slot (the reference's
    ``_partial_states`` :536): ``(x, x flag, y, count of valid y)``;
    rows with ``slot == n_slots`` are dropped."""
    drop = torch.full_like(slot, n_slots)
    ys = torch.where(yv, slot, drop)
    ycnt = torch.zeros(n_slots + 1, dtype=torch.int64, device=slot.device)
    ycnt.index_add_(0, ys, torch.ones_like(slot))
    best = by_value(seg_extreme(by_key(y, y_min), ys, n_slots, y_min), y_min, y.dtype)
    tie = yv & (ys < n_slots) & by_tie(y, best[torch.clamp(ys, max=max(n_slots - 1, 0))])
    xs = torch.where(tie & xv, slot, drop)
    xcnt = torch.zeros(n_slots + 1, dtype=torch.int64, device=slot.device)
    xcnt.index_add_(0, xs, torch.ones_like(slot))
    xb = by_value(seg_extreme(by_key(x, False), xs, n_slots, False), False, x.dtype)
    return xb, (xcnt[:n_slots] > 0).to(torch.int64), best, ycnt[:n_slots]


def moment_sums(x: torch.Tensor, ok: torch.Tensor, s: torch.Tensor, cnt: torch.Tensor,
                at: torch.Tensor, sums):
    """m2, m3 and m4 of the central moments' second pass: ``dx = x -
    mu`` (``mu = s / max(cnt, 1)`` at each row's group ``at``), summed by
    ``sums`` as ``dx*dx``, ``(dx*dx)*dx`` and ``(dx*dx)*(dx*dx)`` (the
    reference's order)."""
    mu = s / torch.clamp(cnt, min=1).to(torch.float64)
    dx = torch.where(ok, x - mu[at], torch.zeros_like(x))
    dx2 = dx * dx
    return [sums(dx2), sums(dx2 * dx), sums(dx2 * dx2)]


def moment_terms(s_i, m2_i, m3_i, m4_i, c_i, mu):
    """One partial's terms of a merged central-moment state: its m2, m3
    and m4 shifted by ``d = mu_i - mu`` (``mu_i = s_i / max(c_i, 1)``, d
    = 0 for an empty partial), in the reference's association
    (``_merge_states`` :1118); K6's merge sums them, K3's fold adds
    two (``csrc/common.cuh`` moment_terms)."""
    cf = c_i.to(torch.float64)
    d = torch.where(c_i > 0, s_i / torch.clamp(cf, min=1.0) - mu, torch.zeros_like(s_i))
    d2 = d * d
    three, four, six = (torch.full_like(d, v) for v in (3.0, 4.0, 6.0))
    return (m2_i + cf * d2, (m3_i + three * m2_i * d) + cf * d2 * d,
            ((m4_i + four * m3_i * d) + six * m2_i * d2) + cf * d2 * d2)


def hll_weight(rho: torch.Tensor) -> torch.Tensor:
    """2^-rho, exact (the double's bits; the reference's exp2 may miss
    the last bit)."""
    return ((1023 - rho.to(torch.int64)) << 52).view(torch.float64)


def seg_bitwise(vals: torch.Tensor, slot: torch.Tensor, n_slots: int, is_and: bool):
    """Per-slot bitwise and (or) of int64 ``vals``; an empty slot holds
    all ones (zero); rows with ``slot == n_slots`` are dropped.  Bit by
    bit: a bit survives an and where every row has it, an or where
    one does."""
    dev = vals.device
    rows = torch.zeros(n_slots + 1, dtype=torch.int64, device=dev)
    rows.index_add_(0, slot, torch.ones_like(vals))
    out = torch.zeros(n_slots + 1, dtype=torch.int64, device=dev)
    for b in range(64):
        bit = (vals >> b) & 1
        cnt = torch.zeros(n_slots + 1, dtype=torch.int64, device=dev)
        cnt.index_add_(0, slot, bit)
        on = cnt == rows if is_and else cnt > 0
        out = out | (on.to(torch.int64) << b)
    return out[:n_slots]


def chunk_sums_plain(vals: torch.Tensor, slot: torch.Tensor, n_slots: int) -> torch.Tensor:
    """Per-slot double sums in the kernel's fixed order: the rows split
    into chunks of ``DSUM_CHUNK``; within a chunk each slot adds its
    rows one by one in row order, from 0.0; then the chunk partials of
    a slot add pairwise, level by level (chunk 2i with 2i + 1; an odd
    last chunk passes up).  Rows with ``slot == n_slots`` are dropped.
    A partial never holds -0.0, so the zero padding is exact."""
    dev = vals.device
    n = vals.shape[0]
    c = max(-(-n // DSUM_CHUNK), 1)
    pad = c * DSUM_CHUNK - n
    sv = torch.cat([slot, torch.full((pad,), n_slots, dtype=slot.dtype, device=dev)])
    xv = torch.cat([vals, torch.zeros(pad, dtype=vals.dtype, device=dev)])
    sv, xv = sv.view(c, DSUM_CHUNK), xv.view(c, DSUM_CHUNK)
    part = torch.zeros((c, n_slots + 1), dtype=torch.float64, device=dev)
    rows = torch.arange(c, device=dev)
    for j in range(DSUM_CHUNK):
        part[rows, sv[:, j]] = part[rows, sv[:, j]] + xv[:, j]
    return pairwise_levels(part[:, :n_slots])


def pairwise_levels(part: torch.Tensor) -> torch.Tensor:
    """Row 2i plus row 2i + 1, level by level, down to one row (an odd
    last row passes up unchanged): the kernel's order across chunks."""
    while part.shape[0] > 1:
        if part.shape[0] % 2:
            part = torch.cat([part, torch.zeros_like(part[:1])])
        part = part[0::2] + part[1::2]
    return part[0]


def packed_group_agg_plain(n: int, row_mask: torch.Tensor, keys: Sequence[Key],
                           aggs: Sequence[Agg], n_groups: int):
    """Plain torch version: ``(states, present)`` where ``states`` holds
    per aggregate ``[count]``, ``[sum, count]`` (a min/max: ``[value,
    count]``), ``[s, m2, count]`` (VARIANCE), ``[sum]`` (CHECKSUM),
    ``[s, m2, m3, m4, count]`` (MOMENTS), ``[x, x flag]`` (BY_X) and
    ``[y, count]`` (BY_Y)."""
    dev = row_mask.device
    gid = torch.zeros(n, dtype=torch.int64, device=dev)
    for data, valid, lo, card in keys:
        code = torch.where(valid, data.to(torch.int64) - lo + 1, torch.zeros_like(gid))
        gid = gid * card + code
    live = row_mask & (gid >= 0) & (gid < n_groups)
    slot = torch.where(live, gid, torch.full_like(gid, n_groups))  # last = dropped

    def seg(vals):
        out = torch.zeros((n_groups + 1,) + tuple(vals.shape[1:]), dtype=torch.int64,
                          device=dev)
        out.index_add_(0, slot, vals)
        return out[:n_groups]

    present = seg(live.to(torch.int64)) > 0
    states: List[List[torch.Tensor]] = []
    by_y = {}  # a BY_Y entry's states, computed with its BY_X
    for a, (kind, data, valid) in enumerate(aggs):
        if kind in BY_Y:
            states.append(by_y.pop(a))
            continue
        if kind == BY_X:
            ykind, ydata, yvalid = aggs[a + 1]
            xb, xflag, yb, ycnt = seg_by(data, live & valid, ydata, live & yvalid, slot,
                                         n_groups, ykind == BY_Y_MIN)
            states.append([xb, xflag])
            by_y[a + 1] = [yb, ycnt]
            continue
        if kind == COUNT_STAR:
            states.append([seg(live.to(torch.int64))])
            continue
        nonnull = live & valid
        if kind in LANES:
            nn_slot = torch.where(nonnull, slot, torch.full_like(slot, n_groups))
            states.append([seg_extreme_long(data, nn_slot, n_groups, kind == MIN_LANES),
                           seg(nonnull.to(torch.int64))])
            continue
        cnt = seg(nonnull.to(torch.int64))
        if kind == COUNT:
            states.append([cnt])
        elif kind == CHECKSUM:
            states.append([seg(torch.where(nonnull, data.to(torch.int64), torch.zeros_like(gid)))])
        elif kind in (MIN_DOUBLE, MAX_DOUBLE):  # a REAL through its exact double
            is_min = kind == MIN_DOUBLE
            nn_slot = torch.where(nonnull, slot, torch.full_like(slot, n_groups))
            ext = seg_extreme(minmax_key(data.to(torch.float64), is_min), nn_slot, n_groups,
                              is_min)
            states.append([minmax_value(ext, is_min).to(data.dtype), cnt])
        elif kind == BOOL_COUNT:
            states.append([seg((nonnull & (data != 0)).to(torch.int64)), cnt])
        elif kind in (BIT_AND, BIT_OR):
            nn_slot = torch.where(nonnull, slot, torch.full_like(slot, n_groups))
            states.append([seg_bitwise(data.to(torch.int64), nn_slot, n_groups,
                                       kind == BIT_AND), cnt])
        elif kind == HLL_SUM:
            nn_slot = torch.where(nonnull, slot, torch.full_like(slot, n_groups))
            x = torch.where(nonnull, hll_weight(data), torch.zeros(n, dtype=torch.float64,
                                                                   device=dev))
            states.append([chunk_sums_plain(x, nn_slot, n_groups), cnt])
        elif kind in EXTREMES:
            is_min = kind in (MIN_SHORT, MIN_LONG, MIN_D38)
            nn_slot = torch.where(nonnull, slot, torch.full_like(slot, n_groups))
            if kind in LONG_ARG + D38_ARG:
                states.append([seg_extreme_long(data, nn_slot, n_groups, is_min), cnt])
            else:
                ext = seg_extreme(data.to(torch.int64), nn_slot, n_groups, is_min)
                states.append([narrow(ext, data.dtype), cnt])
        elif kind == SUM_SHORT:
            x = torch.where(nonnull, data.to(torch.int64), torch.zeros_like(gid))
            states.append([seg(x), cnt])
        elif kind in DOUBLE_ARG:
            nn_slot = torch.where(nonnull, slot, torch.full_like(slot, n_groups))
            data = data.to(torch.float64)  # a REAL widens exactly
            x = torch.where(nonnull, data, torch.zeros_like(data))
            s = chunk_sums_plain(x, nn_slot, n_groups)
            if kind == SUM_DOUBLE:
                states.append([s, cnt])
                continue
            if kind == MOMENTS:
                states.append([s] + moment_sums(
                    x, nonnull, s, cnt, torch.clamp(nn_slot, max=n_groups - 1),
                    lambda v: chunk_sums_plain(v, nn_slot, n_groups)) + [cnt])
                continue
            mu = s / torch.clamp(cnt, min=1).to(torch.float64)
            dx = torch.where(nonnull, x - mu[torch.clamp(nn_slot, max=n_groups - 1)],
                             torch.zeros_like(x))
            states.append([s, chunk_sums_plain(dx * dx, nn_slot, n_groups), cnt])
        else:
            if kind in (SUM_LONG_ARG, SUM_D38):  # a wide argument sums its limbs as they are
                limbs = d128.to_sum_limbs(data)
            else:
                limbs = d128.to_sum_limbs(d128.from_int64(data.to(torch.int64)))
            limbs = torch.where(nonnull[:, None], limbs, torch.zeros_like(limbs))
            states.append([d128.from_sum_limbs(seg(limbs)), cnt])
    return states, present


def packed_group_agg(n: int, row_mask: torch.Tensor, keys: Sequence[Key],
                     aggs: Sequence[Agg], n_groups: int):
    """Partial states of ``aggs`` over the ``n`` rows of ``row_mask``,
    grouped by the packed ``keys`` into ``n_groups`` slots (no keys: one
    global group).  CPU tensors take the plain version; CUDA tensors
    launch the kernel."""
    if any(k in DOUBLE_STATES for k, _, _ in aggs) and n_groups > DOUBLE_SLOT_LIMIT:
        raise ValueError(f"packed_group_agg: double states over {n_groups} slots")
    kinds = [k for k, _, _ in aggs]
    for a, kind in enumerate(kinds):
        if kind == BY_X and kinds[a + 1:a + 2] not in ([BY_Y_MIN], [BY_Y_MAX]) or \
                kind in BY_Y and kinds[a - 1:a] != [BY_X]:
            raise ValueError("packed_group_agg: a BY_Y entry must follow its BY_X")
    if not row_mask.is_cuda:
        return packed_group_agg_plain(n, row_mask, keys, aggs, n_groups)
    if not any(k in LANES for k in kinds):
        return _launch(n, row_mask, keys, aggs, n_groups)
    # a raw extreme's count from the main kernel, its lanes from k2_lane_extremes
    states, present = _launch(n, row_mask, keys, [(COUNT, v, v) if k in LANES else (k, d, v)
                                                  for k, d, v in aggs], n_groups)
    for a, (kind, data, valid) in enumerate(aggs):
        if kind in LANES:
            states[a] = [lane_extremes(n, row_mask, keys, data, valid, kind == MIN_LANES,
                                       n_groups), states[a][0]]
    return states, present


def lane_extremes(n: int, row_mask: torch.Tensor, keys: Sequence[Key], lanes: torch.Tensor,
                  valid: torch.Tensor, is_min: bool, n_groups: int) -> torch.Tensor:
    """The ``(n_groups, k)`` least (greatest) lanes of each packed group's
    valid live rows, the identity in every lane of an empty group, on
    the card (``k2_lane_extremes``: one launch a lane)."""
    global launches
    if lanes.dim() != 2 or lanes.shape[0] != n or lanes.dtype != torch.int64 \
            or not lanes.is_contiguous() or valid.dtype != torch.bool or valid.shape != (n,):
        raise ValueError("packed_group_agg: raw extremes take contiguous (n, k) int64 lanes "
                         "and (n,) bool validity")
    if len(keys) > MAX_KEYS:
        raise ValueError("packed_group_agg: too many keys")
    tensors = [row_mask, lanes, valid]
    for data, kvalid, _, _ in keys:
        _check_col(data, kvalid, n, "key")
        tensors += [data, kvalid]
    build.require_cuda(tensors, "packed_group_agg")
    k = lanes.shape[1]
    out = torch.empty((n_groups, k), dtype=torch.int64, device=lanes.device)
    fn = build.library().k2_lane_extremes
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_longlong, ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 5 \
        + [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
           ctypes.c_void_p, ctypes.c_void_p]
    err = fn(n, row_mask.data_ptr(), len(keys),
             build.ptrs(d.data_ptr() for d, _, _, _ in keys),
             build.ptrs(v.data_ptr() for _, v, _, _ in keys),
             build.ints(_KINDS[d.dtype] for d, _, _, _ in keys),
             build.ptrs(lo for _, _, lo, _ in keys), build.ptrs(card for _, _, _, card in keys),
             lanes.data_ptr(), k, valid.data_ptr(), int(is_min), n_groups, out.data_ptr(),
             build.stream_of(row_mask))
    build.check(err, "packed_group_agg")
    launches += 1
    kind_launches["lanes"] = kind_launches.get("lanes", 0) + 1
    return out


def _check_col(data, valid, n, what, limbs=False, double=False):
    if double:
        if data.shape != (n,) or data.dtype not in _FLOATS:
            raise ValueError(f"packed_group_agg: {what} must be (n,) float64 or float32")
    elif limbs:
        if data.shape != (n, limbs) or data.dtype != torch.int64 or not data.is_contiguous():
            raise ValueError(f"packed_group_agg: {what} must be contiguous (n, {limbs}) int64 "
                             "limbs")
    elif data.dim() != 1 or data.shape[0] != n or data.dtype not in _KINDS:
        raise ValueError(f"packed_group_agg: {what} must be (n,) int8/int16/int32/int64/bool")
    if valid.dtype != torch.bool or valid.shape != (n,):
        raise ValueError(f"packed_group_agg: {what} validity must be (n,) bool")


def _launch(n, row_mask, keys, aggs, n_groups):
    global launches, minmax_launches, variance_launches, double_sum_launches
    if len(keys) > MAX_KEYS or len(aggs) > MAX_AGGS or n_groups < 1:
        raise ValueError("packed_group_agg: too many keys or aggregates")

    if row_mask.dtype != torch.bool or row_mask.shape != (n,):
        raise ValueError("packed_group_agg: row_mask must be (n,) bool")
    tensors = [row_mask]
    for data, valid, _, _ in keys:
        _check_col(data, valid, n, "key")
        tensors += [data, valid]
    for kind, data, valid in aggs:
        if kind not in RAW_WIDTH:
            raise ValueError(f"packed_group_agg: aggregate kind {kind}")
        if kind in BY_Y or kind == BY_X:
            if data.dim() != 1 or data.shape[0] != n or data.dtype not in \
                    (torch.bool, torch.int32, torch.int64, torch.float64) \
                    or valid.dtype != torch.bool or valid.shape != (n,):
                raise ValueError("packed_group_agg: min_by / max_by columns must be (n,) "
                                 "integers, booleans or doubles with (n,) bool validity")
            tensors += [data, valid]
        elif kind != COUNT_STAR:
            _check_col(data, valid, n, "argument",
                       2 if kind in LONG_ARG else 5 if kind in D38_ARG else 0, kind in DOUBLE_ARG)
            tensors += [data, valid]
    doubles = any(k in DOUBLE_STATES for k, _, _ in aggs)
    build.require_cuda(tensors, "packed_group_agg")
    dev = row_mask.device
    raw_width = 1 + sum(RAW_WIDTH[k] for k, _, _ in aggs)
    raw = torch.empty(n_groups * raw_width, dtype=torch.int64, device=dev)
    present = torch.empty(n_groups, dtype=torch.bool, device=dev)
    states = []
    for kind, data, _ in aggs:
        cnt = torch.empty(n_groups, dtype=torch.int64, device=dev)
        if kind == SUM_SHORT:
            states.append([torch.empty(n_groups, dtype=torch.int64, device=dev), cnt])
        elif kind in (MIN_SHORT, MAX_SHORT):
            states.append([torch.empty(n_groups, dtype=data.dtype, device=dev), cnt])
        elif kind in (SUM_LONG, MIN_LONG, MAX_LONG, SUM_LONG_ARG):
            states.append([torch.empty((n_groups, 2), dtype=torch.int64, device=dev), cnt])
        elif kind in D38_ARG:
            states.append([torch.empty((n_groups, 5), dtype=torch.int64, device=dev), cnt])
        elif kind in (MIN_DOUBLE, MAX_DOUBLE):  # a REAL's extreme stays float32
            states.append([torch.empty(n_groups, dtype=data.dtype, device=dev), cnt])
        elif kind in (SUM_DOUBLE, HLL_SUM):
            states.append([torch.empty(n_groups, dtype=torch.float64, device=dev), cnt])
        elif kind in (BOOL_COUNT, BIT_AND, BIT_OR):
            states.append([torch.empty(n_groups, dtype=torch.int64, device=dev), cnt])
        elif kind == VARIANCE:
            states.append([torch.empty(n_groups, dtype=torch.float64, device=dev),
                           torch.empty(n_groups, dtype=torch.float64, device=dev), cnt])
        elif kind == MOMENTS:
            states.append([torch.empty(n_groups, dtype=torch.float64, device=dev)
                           for _ in range(4)] + [cnt])
        elif kind in BY_Y or kind == BY_X:  # (value, count or flag)
            states.append([torch.empty(n_groups, dtype=data.dtype, device=dev), cnt])
        else:  # a count, or CHECKSUM's sum
            states.append([cnt])
    # chunk partials of the double sums (one row of slots per chunk) and
    # the first pairwise level's
    chunks = max(-(-n // DSUM_CHUNK), 1)
    scratch = torch.empty((chunks + (chunks + 1) // 2) * n_groups if doubles else 1,
                          dtype=torch.float64, device=dev)
    null = 0
    c_key_data = build.ptrs(d.data_ptr() for d, _, _, _ in keys)
    c_key_valid = build.ptrs(v.data_ptr() for _, v, _, _ in keys)
    c_key_kind = build.ints(_KINDS[d.dtype] for d, _, _, _ in keys)
    c_key_lo = build.ptrs(lo for _, _, lo, _ in keys)
    c_key_card = build.ptrs(card for _, _, _, card in keys)
    c_agg_kind = build.ints(k for k, _, _ in aggs)
    c_arg_data = build.ptrs(d.data_ptr() if d is not None else null for _, d, _ in aggs)
    c_arg_valid = build.ptrs(v.data_ptr() if v is not None else null for _, _, v in aggs)
    c_arg_kind = build.ints((KIND_D128 if k in LONG_ARG else KIND_D38 if k in D38_ARG
                             else KIND_F32 if d.dtype ==
                             torch.float32 else KIND_F64 if k in DOUBLE_ARG
                             or d.dtype == torch.float64 else _KINDS[d.dtype])
                            if d is not None else 0 for k, d, _ in aggs)
    names = {KIND_NAMES[k] for k, _, _ in aggs if k in KIND_NAMES}
    names |= {"min_bool" for k, d, _ in aggs if k in (MIN_SHORT, MAX_SHORT)
              and d.dtype == torch.bool}
    names |= {"narrow" for _, d, _ in aggs if d is not None and d.dtype in (
        torch.int16, torch.int8, torch.float32)}
    c_out0 = build.ptrs(s[0].data_ptr() for s in states)
    c_out1 = build.ptrs(s[1].data_ptr() if len(s) > 1 else null for s in states)
    c_out2 = build.ptrs(s[2].data_ptr() if len(s) > 2 else null for s in states)
    c_out3 = build.ptrs(s[3].data_ptr() if len(s) > 3 else null for s in states)
    c_out4 = build.ptrs(s[4].data_ptr() if len(s) > 4 else null for s in states)
    fn = build.library().k2_packed_group_agg
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_longlong, ctypes.c_void_p,
                   ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_void_p,
                   ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
    err = fn(n, row_mask.data_ptr(),
             len(keys), c_key_data, c_key_valid, c_key_kind, c_key_lo, c_key_card,
             len(aggs), c_agg_kind, c_arg_data, c_arg_valid, c_arg_kind,
             n_groups, raw_width, raw.data_ptr(), c_out0, c_out1, c_out2, c_out3, c_out4,
             present.data_ptr(),
             scratch.data_ptr(), build.stream_of(row_mask))
    build.check(err, "packed_group_agg")
    launches += 1
    if any(k in EXTREMES for k, _, _ in aggs):
        minmax_launches += 1
    variance_launches += int(any(k == VARIANCE for k, _, _ in aggs))
    double_sum_launches += int(any(k == SUM_DOUBLE for k, _, _ in aggs))
    for name in names:
        kind_launches[name] = kind_launches.get(name, 0) + 1
    return states, present
