"""K6 ``sorted_group_agg``: grouped states over sorted packed keys.

:func:`sorted_group_agg` packs the group keys exactly, or hashes them
(K9) when they have no exact domain (NULL keys group together, dead
rows take a sentinel that sorts last), compacts the live rows of a
page past :data:`SORT_WHOLE_ROWS` on the card and sorts only their keys
with ``torch.sort(stable=True)`` (the reference leaves its argsort to
XLA; the dead rows would sort last, so the live rows keep their
positions; a page whose rows are all live needs no compaction, and a
smaller page sorts whole), numbers the runs of equal keys
in key order, and sums each group's states exactly; the reference's
``_sorted_group_ids``, ``_SortCtx.sum`` and the sort path of
``grouped_aggregate`` / ``merge_aggregate``
(``presto_tpu/ops/aggregate.py``).  It returns every group it sees
(the host reads the live count and the group count, once each, and
sizes the sort and the outputs from them) with each group's first
row's key values.  CUDA tensors launch ``csrc/sorted_group_agg.cu``;
CPU tensors run :func:`sorted_group_agg_plain`.

Double states never add by atomics: S_DSUM (a double sum), S_VAR (the
variance state ``(s, m2, cnt)`` of a double argument, two passes) and
S_VAR_MERGE (partial variance states merged, Chan's form generalised
to k partials) add each group's values in one fixed order, the same on
the card and in the twin (:func:`run_sums_plain`): the group's run of
sorted positions splits into chunks of ``DSUM_CHUNK``, each chunk adds
its values in sorted order from 0.0, and the chunk partials add
pairwise, level by level.

The coupled and statistical states: S_MOM (the central moments ``(s,
m2, m3, m4, cnt)`` of a double, four passes in that fixed order) and
S_MOM_MERGE (their partials merged by Chan's form extended to M3 and M4,
the reference's ``_merge_states``); min_by / max_by as S_BY_X, S_BY_XV
and S_BY_Y_MIN or S_BY_Y_MAX in that order: the extreme of ``y`` (an
integer, a collation rank or a double's min/max order key), then over
the rows whose ``y`` equals it the greatest ``x`` (S_BY_X) and a 0/1 flag
that one had a valid ``x`` (S_BY_XV).  checksum is an S_SUM (wrapping)
of K1's hashes.

``presorted=True`` is the streaming aggregation (the reference's
``_presorted_group_ids``): equal keys arrive together, so there is no
sort; the live rows keep their page order, a run of equal keys among
them is a group, and groups come out in first-appearance order.
"""

from __future__ import annotations

import ctypes
from typing import List, Optional, Sequence, Tuple

import torch

from presto_tpu_torch.kernels import build
from presto_tpu_torch.kernels import keys as pk
from presto_tpu_torch.ops import decimal128 as d128

# state kinds: keep in step with csrc/sorted_group_agg.cu.  ONE counts
# live rows, VALID counts rows whose valid bit is set, SUM adds int64
# values, LIMBS_SHORT / LIMBS_LONG add a short (int64) or long
# ((n, 2) limbs) decimal as four base-10^9 limbs and return two
# normalised base-10^18 limbs; MIN / MAX keep the least or greatest
# valid int32/int64 value (in its own dtype), MIN_LONG / MAX_LONG the
# least or greatest (n, 2) limbs; an empty state holds the identity.
S_ONE, S_VALID, S_SUM, S_LIMBS_SHORT, S_LIMBS_LONG, S_MIN, S_MAX, S_MIN_LONG, \
    S_MAX_LONG, S_DSUM, S_VAR, S_VAR_MERGE, S_MIN_F64, S_MAX_F64, S_BAND, S_BOR, \
    S_HLL, S_MOM, S_MOM_MERGE, S_BY_Y_MIN, S_BY_Y_MAX, S_BY_X, S_BY_XV, S_LIMBS_D38, \
    S_MIN_D38, S_MAX_D38, S_MIN_LANES, S_MAX_LANES = range(28)
# S_MIN_LANES / S_MAX_LANES: a raw varchar's least or greatest value as
# its ``(n, k)`` int64 lanes (``ops/rawstring.pack_lanes``), compared
# lane by lane as signed int64; the entry point ``k6_lane_extremes``
# reduces each group's run, one warp a run, after the other states
# S_LIMBS_D38 adds a wide decimal's ((n, 5) base-10^9 limbs) limbs as
# they are and gives five normalised limbs; S_MIN_D38 / S_MAX_D38 its
# least or greatest value, limb by limb (one phase per limb)
# S_MIN / S_MAX also take booleans (an empty state: the fold's neutral
# value) and SMALLINT / TINYINT values (stored back narrowed);
# S_MIN_F64 / S_MAX_F64 keep a double's or a REAL's extreme (-0.0 below
# 0.0, NaN winning, as the reference's segment reductions; a REAL's in
# float32); S_DSUM also sums a REAL in double; S_BAND / S_BOR
# fold int64 values by and / or (an empty state: all ones / zero);
# S_HLL adds 2^-rho of a valid int64 rho, a double state
# S_DSUM sums a valid double (one output); S_VAR takes a double and
# gives (s, m2, cnt); S_VAR_MERGE takes the partial states ``(s, m2,
# cnt)`` as its data (its validity: the live partial rows) and gives
# the merged (s, m2, cnt)
# S_MOM takes a double and gives (s, m2, m3, m4, cnt); S_MOM_MERGE
# takes the partial states (s, m2, m3, m4, cnt) and gives them merged;
# S_BY_X (data x), S_BY_XV (no data: x's validity) and the S_BY_Y_MIN /
# S_BY_Y_MAX after them (data y) are one min_by / max_by
DOUBLE_STATES = (S_DSUM, S_VAR, S_VAR_MERGE, S_HLL, S_MOM, S_MOM_MERGE)
S_BY_Y = (S_BY_Y_MIN, S_BY_Y_MAX)
_BY = (S_BY_Y_MIN, S_BY_Y_MAX, S_BY_X, S_BY_XV)
DSUM_CHUNK = 256  # csrc/sorted_group_agg.cu K6_DSUM_CHUNK
#: a page of at most this many rows sorts whole, its dead rows last,
#: and reads its live count with the group count; larger pages compact
#: their live rows and sort only those.  On an H100 the whole sort is
#: the faster below 2^20 rows (0.5% live at 2^18; all-live merges of
#: 119,102 and 200,000 rows) and the two meet at 2^20
#: (``tools/k6_k7_ab.py``): below that, CUB's passes cost their
#: launches whatever the live share, and the compaction adds a kernel
#: and a host read of the live count
SORT_WHOLE_ROWS = 1 << 20
_LIMBS = (S_LIMBS_SHORT, S_LIMBS_LONG, S_LIMBS_D38)
_PAIRS = (S_LIMBS_SHORT, S_LIMBS_LONG, S_MIN_LONG, S_MAX_LONG)  # (G, 2) outputs
_FIVES = (S_LIMBS_D38, S_MIN_D38, S_MAX_D38)  # (G, 5) outputs
_EXTREMES = (S_MIN, S_MAX, S_MIN_LONG, S_MAX_LONG, S_MIN_F64, S_MAX_F64, S_MIN_D38, S_MAX_D38,
             S_MIN_LANES, S_MAX_LANES)
_INT_STATES = (S_ONE, S_VALID, S_SUM, S_LIMBS_SHORT, S_LIMBS_LONG, S_MIN, S_MAX, S_MIN_LONG,
               S_MAX_LONG, S_MIN_F64, S_MAX_F64, S_BAND, S_BOR) + _BY + _FIVES
KIND_NAMES = {S_MIN_F64: "min_double", S_MAX_F64: "min_double", S_BAND: "bitwise",
              S_BOR: "bitwise", S_HLL: "hll", S_MOM: "moments", S_MOM_MERGE: "moments_merge",
              S_BY_Y_MIN: "min_by", S_BY_Y_MAX: "min_by", S_LIMBS_D38: "d38",
              S_MIN_D38: "d38", S_MAX_D38: "d38"}
# the columns of a double state's data and of its outputs
_DOUBLE_COLS = {S_VAR_MERGE: 3, S_MOM_MERGE: 5}
_DOUBLE_OUTS = {S_DSUM: 1, S_HLL: 1, S_VAR: 3, S_VAR_MERGE: 3, S_MOM: 5, S_MOM_MERGE: 5}
MAX_STATES = 32  # csrc/sorted_group_agg.cu K6_MAX_STATES
MAX_SLOTS = 64  # csrc/sorted_group_agg.cu K6_MAX_SLOTS
_WIDTH = {S_LIMBS_SHORT: 4, S_LIMBS_LONG: 4, S_MIN_LONG: 2, S_MAX_LONG: 2, S_LIMBS_D38: 5,
          S_MIN_D38: 5, S_MAX_D38: 5}
SCAN_TILE = 2048  # csrc/scan.cuh SCAN_TILE
_DATA_KINDS = {torch.bool: 0, torch.int32: 1, torch.int64: 2, torch.int16: 4, torch.int8: 5}
# a double's bits, a REAL's (widened exactly) (csrc/sorted_group_agg.cu)
DATA_F64, DATA_F32 = 3, 6
_FLOATS = (torch.float64, torch.float32)
_NARROW = (torch.int16, torch.int8, torch.float32)
# how k6_finish stores a state (csrc/sorted_group_agg.cu): int64, int32,
# int16 or int8 (narrowing the identities), a boolean (an identity: the
# neutral value), a double or a REAL
_OUT_KINDS = {torch.int32: 1, torch.bool: 2, torch.float64: 3, torch.int16: 4, torch.int8: 5,
              torch.float32: 6}

LANE_STATES = (S_MIN_LANES, S_MAX_LANES)

launches = 0
#: launches in presorted mode, and launches with a min/max state
presorted_launches = 0
minmax_launches = 0
#: launches with a variance state (partial), a variance merge, a double sum
variance_launches = 0
variance_merge_launches = 0
double_sum_launches = 0
#: launches by the eighth slice's kinds (KIND_NAMES), min/max over
#: booleans ("min_bool"), and states over a SMALLINT, TINYINT or REAL
#: datum ("narrow")
kind_launches: dict = {}

# (kind, data or None, valid or None)
State = Tuple[int, Optional[torch.Tensor], Optional[torch.Tensor]]


def _limbs(kind: int, data: torch.Tensor) -> torch.Tensor:
    if kind == S_LIMBS_SHORT:
        return d128.to_sum_limbs(d128.from_int64(data.to(torch.int64)))
    return d128.to_sum_limbs(data)


def run_sums_plain(v: torch.Tensor, gid: torch.Tensor, groups: int) -> torch.Tensor:
    """Per-group double sums of ``v`` over sorted positions (``gid``
    non-decreasing, every group present) in the kernel's fixed order:
    chunks of ``DSUM_CHUNK`` consecutive positions of a group's run
    add in order from 0.0, then each group's chunk partials add
    pairwise, level by level (an odd last partial passes up).  A
    ``(positions, m)`` ``v`` gives each of its ``m`` columns' sums."""
    dev = v.device
    if groups == 0:
        return torch.zeros((0,) + tuple(v.shape[1:]), dtype=torch.float64, device=dev)
    counts = torch.bincount(gid, minlength=groups)
    starts = torch.cumsum(counts, 0) - counts
    nch = (counts + DSUM_CHUNK - 1) // DSUM_CHUNK
    base = torch.cumsum(nch, 0) - nch
    # each chunk's first position and length, the chunks longest first:
    # at place jj the chunks longer than jj are a prefix, and each takes
    # its next value, so each chunk adds in order from 0.0 (O(n) memory)
    cg = torch.repeat_interleave(torch.arange(groups, device=dev), nch)
    ci = torch.arange(cg.shape[0], device=dev) - base[cg]
    first = starts[cg] + ci * DSUM_CHUNK
    length = torch.clamp(counts[cg] - ci * DSUM_CHUNK, max=DSUM_CHUNK)
    longest = torch.argsort(length, descending=True)
    first = first[longest]
    shorter = torch.cumsum(torch.bincount(length, minlength=DSUM_CHUNK + 1), 0)
    acc = torch.zeros((cg.shape[0],) + tuple(v.shape[1:]), dtype=torch.float64, device=dev)
    for jj, k in enumerate((cg.shape[0] - shorter[:DSUM_CHUNK]).tolist()):
        if k == 0:
            break
        acc[:k] = acc[:k] + v[first[:k] + jj]
    part = torch.empty_like(acc)
    part[longest] = acc
    while int(nch.max()) > 1:
        half = (nch + 1) // 2
        hbase = torch.cumsum(half, 0) - half
        g = torch.repeat_interleave(torch.arange(groups, device=dev), half)
        i = torch.arange(g.shape[0], device=dev) - hbase[g]
        left = base[g] + 2 * i
        pair = 2 * i + 1 < nch[g]
        right = torch.where(pair, left + 1, left)
        if part.dim() > 1:
            pair = pair[:, None]
        part = torch.where(pair, part[left] + part[right], part[left])
        nch, base = half, hbase
    return part


def _double_states_plain(kind, data, valid, rows, gid, groups):
    """The outputs of a double state (see ``DOUBLE_STATES``) over the
    sorted live ``rows`` with group ids ``gid``."""
    ok = valid[rows]
    zero = torch.zeros(rows.shape[0], dtype=torch.float64, device=rows.device)

    def count(vals):
        acc = torch.zeros(groups, dtype=torch.int64, device=rows.device)
        return acc.index_add_(0, gid, vals)

    if kind == S_VAR_MERGE:
        s_i, m2_i, c_i = (t[rows] for t in data)
        s = run_sums_plain(torch.where(ok, s_i, zero), gid, groups)
        cnt = count(torch.where(ok, c_i, torch.zeros_like(c_i)))
        mu = s / torch.clamp(cnt, min=1).to(torch.float64)
        cf = c_i.to(torch.float64)
        mu_i = s_i / torch.clamp(cf, min=1.0)
        dev = torch.where(c_i > 0, mu_i - mu[gid], zero)
        m2 = run_sums_plain(torch.where(ok, m2_i + cf * dev * dev, zero), gid, groups)
        return [s, m2, cnt]
    if kind == S_HLL:
        from presto_tpu_torch.kernels.packed_group_agg import hll_weight

        return [run_sums_plain(torch.where(ok, hll_weight(data[rows]), zero), gid, groups)]
    if kind == S_MOM_MERGE:
        return moments_merge_plain([t[rows] for t in data], ok, gid, groups)
    x = torch.where(ok, data[rows].to(torch.float64), zero)  # a REAL widens exactly
    s = run_sums_plain(x, gid, groups)
    if kind == S_DSUM:
        return [s]
    cnt = count(ok.to(torch.int64))
    if kind == S_MOM:
        from presto_tpu_torch.kernels.packed_group_agg import moment_sums

        return [s] + moment_sums(x, ok, s, cnt, gid,
                                 lambda v: run_sums_plain(v, gid, groups)) + [cnt]
    mu = s / torch.clamp(cnt, min=1).to(torch.float64)
    dx = torch.where(ok, x - mu[gid], zero)
    return [s, run_sums_plain(dx * dx, gid, groups), cnt]


def moments_merge_plain(cols, ok, gid, groups):
    """S_MOM_MERGE over the sorted live partial rows: each partial's
    ``moment_terms`` (Chan's form generalised to k partials and to M3 /
    M4, the reference's ``_merge_states`` :1118), summed in the fixed
    double order."""
    from presto_tpu_torch.kernels.packed_group_agg import moment_terms

    s_i, m2_i, m3_i, m4_i, c_i = cols
    zero = torch.zeros_like(s_i)
    s = run_sums_plain(torch.where(ok, s_i, zero), gid, groups)
    cnt = torch.zeros(groups, dtype=torch.int64, device=gid.device)
    cnt.index_add_(0, gid, torch.where(ok, c_i, torch.zeros_like(c_i)))
    mu = s / torch.clamp(cnt, min=1).to(torch.float64)
    return [s] + [run_sums_plain(torch.where(ok, m, zero), gid, groups)
                  for m in moment_terms(s_i, m2_i, m3_i, m4_i, c_i, mu[gid])] + [cnt]


def _by_plain(states, i, rows, gid, groups):
    """min_by / max_by's three states from S_BY_X at ``i``: ``[x, x
    flag, y]`` (the reference's two phases, ``packed_group_agg.seg_by``)."""
    from presto_tpu_torch.kernels.packed_group_agg import seg_by

    (_, x, xv), _, (ykind, y, yv) = states[i:i + 3]
    xb, xflag, yb, _ = seg_by(x[rows], xv[rows], y[rows], yv[rows], gid, groups,
                              ykind == S_BY_Y_MIN)
    return [xb, xflag, yb]


def sorted_group_agg_plain(keys: Sequence[pk.Key], row_mask: torch.Tensor,
                           states: Sequence[State], presorted: bool = False,
                           runs: bool = False):
    """``(key columns [(data, valid)...], state columns, groups)``; the
    plain version.  A state gives one column, S_VAR and S_VAR_MERGE
    three, S_MOM and S_MOM_MERGE five.  ``runs``: a fourth item, ``(order,
    starts)``: the row at each sorted position and the first position of
    each group's run (``starts[groups]``: the live rows' count), which
    K14 ``group_collect`` walks."""
    masked = _masked_plain(keys, row_mask)
    if presorted:  # the live rows in page order, the dead ones after them
        order = torch.cat([torch.nonzero(row_mask).flatten(), torch.nonzero(~row_mask).flatten()])
        sk = masked[order]
    else:
        sk, order = torch.sort(masked, stable=True)
    return _group_plain(keys, states, sk, order, runs)


def sorted_group_agg_compact_plain(keys: Sequence[pk.Key], row_mask: torch.Tensor,
                                   states: Sequence[State], presorted: bool = False,
                                   runs: bool = False):
    """The kernels' path in plain torch (:func:`compact_plain`: only the
    live rows' keys sort), for the tests to hold against the twin,
    :func:`sorted_group_agg_plain`."""
    sk, order = compact_plain(_masked_plain(keys, row_mask), presorted)
    return _group_plain(keys, states, sk, order, runs)


def _masked_plain(keys, row_mask):
    key, _ = pk.pack_plain(keys, row_mask.shape[0], row_mask.device)
    return torch.where(row_mask, key, torch.full_like(key, pk.I64_MAX))


def _group_plain(keys, states, sk, order, runs):
    """The groups and states over the sorted keys ``sk`` (the sentinel
    where dead) and the rows ``order`` at the sorted positions (``order``
    may run past ``sk``: dead rows)."""
    dev = order.device
    live = sk != pk.I64_MAX
    first = live.clone()
    first[1:] &= sk[1:] != sk[:-1]
    groups = int(first.sum())
    gid = (torch.cumsum(first.to(torch.int64), 0) - 1)[live]
    rows = order[:sk.shape[0]][live]
    rep = order[:sk.shape[0]][first]
    key_out = [(d[rep], v[rep]) for d, v, _, _ in keys]
    outs = []
    for i, (kind, data, valid) in enumerate(states):
        if kind == S_BY_X:
            outs.extend(_by_plain(states, i, rows, gid, groups))
            continue
        if kind in _BY:  # given with their S_BY_X
            continue
        if kind in DOUBLE_STATES:
            outs.extend(_double_states_plain(kind, data, valid, rows, gid, groups))
            continue
        if kind in _EXTREMES:
            outs.append(_extreme_plain(kind, data, valid, rows, gid, groups))
            continue
        if kind in (S_BAND, S_BOR):
            from presto_tpu_torch.kernels.packed_group_agg import seg_bitwise

            slot = torch.where(valid[rows], gid, torch.full_like(gid, groups))
            outs.append(seg_bitwise(data[rows].to(torch.int64), slot, groups, kind == S_BAND))
            continue
        if kind == S_ONE:
            vals = torch.ones(rows.shape[0], dtype=torch.int64, device=dev)
        else:
            ok = valid[rows]
            if kind == S_VALID:
                vals = ok.to(torch.int64)
            elif kind == S_SUM:
                vals = torch.where(ok, data[rows].to(torch.int64),
                                   torch.zeros_like(rows))
            else:
                vals = _limbs(kind, data[rows])
                vals = torch.where(ok[:, None], vals, torch.zeros_like(vals))
        acc = torch.zeros((groups,) + tuple(vals.shape[1:]), dtype=torch.int64,
                          device=dev)
        acc.index_add_(0, gid, vals)
        outs.append(d128.from_sum_limbs(acc) if kind in _LIMBS else acc)
    if runs:
        starts = torch.cat([torch.nonzero(first).flatten(),
                            live.sum().reshape(1)]).to(torch.int64)
        return key_out, outs, groups, (order, starts)
    return key_out, outs, groups


def _with_lane_states(keys, row_mask, states, presorted, runs):
    """The other states first (their runs kept), then each raw extreme
    over the groups' runs (:func:`lane_extremes`), put back in place."""
    rest = [s for s in states if s[0] not in LANE_STATES] or [(S_ONE, None, None)]
    key_out, outs, groups, (order, starts) = sorted_group_agg(keys, row_mask, rest, presorted,
                                                              runs=True)
    merged, it = [], iter(outs)
    for kind, data, valid in states:
        merged.append(lane_extremes(order, starts, data, valid, kind == S_MIN_LANES)
                      if kind in LANE_STATES else next(it))
    return (key_out, merged, groups) + (((order, starts),) if runs else ())


def lane_extremes_plain(order, starts, lanes, valid, is_min: bool) -> torch.Tensor:
    from presto_tpu_torch.kernels.packed_group_agg import seg_extreme_long

    groups = starts.shape[0] - 1
    live = int(starts[-1]) if groups else 0
    rows = order[:live]
    gid = torch.repeat_interleave(torch.arange(groups, device=order.device),
                                  starts[1:] - starts[:-1])
    slot = torch.where(valid[rows], gid, torch.full_like(gid, groups))
    return seg_extreme_long(lanes[rows], slot, groups, is_min)


def lane_extremes(order: torch.Tensor, starts: torch.Tensor, lanes: torch.Tensor,
                  valid: torch.Tensor, is_min: bool) -> torch.Tensor:
    """The ``(groups, k)`` least (greatest) lanes of each group's valid
    rows, over the sorted runs ``(order, starts)`` (the identity in every
    lane of a group with none): the reference's ``_minmax_lanes``.  CPU
    tensors take the plain version; CUDA tensors launch
    ``k6_lane_extremes``."""
    n = lanes.shape[0]
    if lanes.dim() != 2 or lanes.dtype != torch.int64 or not lanes.is_contiguous() \
            or valid.dtype != torch.bool or valid.shape != (n,) \
            or order.dtype != torch.int64 or starts.dtype != torch.int64:
        raise ValueError("sorted_group_agg: raw extremes take contiguous (n, k) int64 lanes, "
                         "(n,) bool validity and int64 runs")
    if not lanes.is_cuda:
        return lane_extremes_plain(order, starts, lanes, valid, is_min)
    global launches
    build.require_cuda([order, starts, lanes, valid], "sorted_group_agg")
    groups = starts.shape[0] - 1
    k = lanes.shape[1]
    out = torch.empty((groups, k), dtype=torch.int64, device=lanes.device)
    if groups:
        fn = build.library().k6_lane_extremes
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,
                       ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                       ctypes.c_void_p]
        build.check(fn(order.data_ptr(), starts.data_ptr(), groups, lanes.data_ptr(), k,
                       valid.data_ptr(), int(is_min), out.data_ptr(),
                       build.stream_of(lanes)), "sorted_group_agg")
    launches += 1
    kind_launches["lanes"] = kind_launches.get("lanes", 0) + 1
    return out


def _extreme_plain(kind, data, valid, rows, gid, groups):
    from presto_tpu_torch.kernels.packed_group_agg import (
        minmax_key, minmax_value, narrow, seg_extreme, seg_extreme_long,
    )

    ok = valid[rows]
    slot = torch.where(ok, gid, torch.full_like(gid, groups))
    is_min = kind in (S_MIN, S_MIN_LONG, S_MIN_F64, S_MIN_D38, S_MIN_LANES)
    if kind in (S_MIN_F64, S_MAX_F64):  # a REAL's extreme through its exact double
        x = data[rows].to(torch.float64)
        return minmax_value(seg_extreme(minmax_key(x, is_min), slot, groups, is_min),
                            is_min).to(data.dtype)
    if kind in (S_MIN_LONG, S_MAX_LONG, S_MIN_D38, S_MAX_D38) + LANE_STATES:
        return seg_extreme_long(data[rows], slot, groups, is_min)
    return narrow(seg_extreme(data[rows].to(torch.int64), slot, groups, is_min), data.dtype)


def sorted_group_agg(keys: Sequence[pk.Key], row_mask: torch.Tensor,
                     states: Sequence[State], presorted: bool = False, runs: bool = False):
    """Group the live rows of ``row_mask`` by the packed ``keys`` and
    compute ``states`` per group: ``(key columns, state columns,
    groups)``, groups in packed-key order (``presorted``: in page
    order, runs of equal keys).  CPU tensors take the plain version;
    CUDA tensors launch the kernels around ``torch.sort`` (presorted:
    around K6's page-order pass)."""
    # the kernel's limit, held on every device (a variance state counts
    # its rows in an integer state of its own)
    if sum(k != S_DSUM for k, _, _ in states) > MAX_STATES:
        raise ValueError("sorted_group_agg: too many states")
    kinds = [k for k, _, _ in states]
    for i, k in enumerate(kinds):
        if k == S_BY_X and (kinds[i + 1:i + 2] != [S_BY_XV]
                            or kinds[i + 2:i + 3] not in ([S_BY_Y_MIN], [S_BY_Y_MAX])) or \
                k == S_BY_XV and kinds[i - 1:i] != [S_BY_X] or \
                k in S_BY_Y and kinds[i - 2:i - 1] != [S_BY_X]:
            raise ValueError("sorted_group_agg: min_by / max_by states come as S_BY_X, "
                             "S_BY_XV, S_BY_Y")
    if not row_mask.is_cuda:
        return sorted_group_agg_plain(keys, row_mask, states, presorted, runs)
    if any(k in LANE_STATES for k in kinds):
        return _with_lane_states(keys, row_mask, states, presorted, runs)
    global launches, presorted_launches, minmax_launches, variance_launches, \
        variance_merge_launches, double_sum_launches
    n = row_mask.shape[0]
    if row_mask.dtype != torch.bool or row_mask.dim() != 1 or n >= (1 << 31) - 1:
        raise ValueError("sorted_group_agg: row_mask must be (n,) bool, n < 2^31")
    # the double states' counts run as integer states: S_VAR counts its
    # valid rows, S_VAR_MERGE adds its partials' counts
    int_states: List[State] = []
    plan = []  # per state: (kind, data, valid, index of its integer state)
    for kind, data, valid in states:
        if kind in DOUBLE_STATES:
            if valid is None or valid.dtype != torch.bool or valid.shape != (n,):
                raise ValueError("sorted_group_agg: state validity must be (n,) bool")
            ncols = _DOUBLE_COLS.get(kind, 1)
            cols = data if ncols > 1 else (data,)
            want = [torch.int64] if kind == S_HLL else \
                [torch.float64] * max(ncols - 1, 1) + [torch.int64] * (ncols > 1)
            if kind == S_DSUM and cols[0].dtype == torch.float32:
                want = [torch.float32]  # a REAL's sum, in double
            if len(cols) != ncols or any(c.shape != (n,) for c in cols) \
                    or [c.dtype for c in cols] != want:
                raise ValueError("sorted_group_agg: double state data must be (n,) float64 "
                                 "(S_DSUM: or float32; a merge: its float64 sums and an int64 "
                                 "cnt; S_HLL: int64 rho)")
            idx = None
            if kind in (S_VAR, S_MOM):
                idx = len(int_states)
                int_states.append((S_VALID, None, valid))
            elif kind in (S_VAR_MERGE, S_MOM_MERGE):
                idx = len(int_states)
                int_states.append((S_SUM, cols[-1], valid))
            plan.append((kind, data, valid, idx))
        else:
            plan.append((None, None, None, len(int_states)))
            int_states.append((kind, data, valid))
    if len(int_states) > MAX_STATES:
        raise ValueError("sorted_group_agg: too many states")
    tensors = [row_mask] + pk.check(keys, n, "sorted_group_agg")
    for kind, data, _, _ in plan:
        if kind is not None:
            tensors += list(data) if kind in _DOUBLE_COLS else [data]
    for kind, data, valid in int_states:
        if kind not in _INT_STATES:
            raise ValueError(f"sorted_group_agg: state kind {kind}")
        if kind != S_ONE:
            if valid is None or valid.dtype != torch.bool or valid.shape != (n,):
                raise ValueError("sorted_group_agg: state validity must be (n,) bool")
            tensors.append(valid)
        if kind in (S_SUM, S_LIMBS_SHORT, S_MIN, S_MAX, S_BAND, S_BOR):
            if data is None or data.shape != (n,) or data.dtype not in _DATA_KINDS:
                raise ValueError("sorted_group_agg: state data must be (n,) integers")
            tensors.append(data)
        if kind in (S_MIN_F64, S_MAX_F64):
            if data is None or data.shape != (n,) or data.dtype not in _FLOATS:
                raise ValueError("sorted_group_agg: double min/max data must be (n,) float64 "
                                 "or float32")
            tensors.append(data)
        if kind in (S_BY_X,) + S_BY_Y:
            if data is None or data.shape != (n,) or data.dtype not in (
                    torch.bool, torch.int32, torch.int64, torch.float64):
                raise ValueError("sorted_group_agg: min_by / max_by data must be (n,) "
                                 "integers, booleans or doubles")
            tensors.append(data)
        if kind in (S_LIMBS_LONG, S_MIN_LONG, S_MAX_LONG) + _FIVES:
            w = 5 if kind in _FIVES else 2
            if data is None or data.shape != (n, w) or data.dtype != torch.int64 \
                    or not data.is_contiguous():
                raise ValueError("sorted_group_agg: long state data must be contiguous (n, 2) "
                                 "or, wide, (n, 5) int64")
            tensors.append(data)
    states = int_states
    if sum(_WIDTH.get(k, 1) for k, _, _ in states) > MAX_SLOTS:
        raise ValueError("sorted_group_agg: too many state slots")
    build.require_cuda(tensors, "sorted_group_agg")
    dev = row_mask.device
    stream = build.stream_of(row_mask)
    lib = build.library()
    # the states' descriptor before the first read of a count, so the
    # host builds it while the card packs and compacts
    null = 0
    out_dtypes = [data.dtype if kind in (S_MIN, S_MAX, S_MIN_F64, S_MAX_F64, S_BY_X) + S_BY_Y
                  else torch.int64 for kind, data, _ in states]
    key_src = build.ptrs(d.data_ptr() for d, _, _, _ in keys)
    key_valid = build.ptrs(v.data_ptr() for _, v, _, _ in keys)
    key_width = build.ints(d.element_size() for d, _, _, _ in keys)
    state_kinds = build.ints(k for k, _, _ in states)
    data_ptrs = build.ptrs(d.data_ptr() if d is not None else null for _, d, _ in states)
    data_kinds = build.ints(_DATA_KINDS.get(d.dtype, DATA_F32 if d.dtype == torch.float32
                                            else DATA_F64) if d is not None else 0
                            for _, d, _ in states)
    valid_ptrs = build.ptrs(v.data_ptr() if v is not None else null for _, _, v in states)
    out_kinds = build.ints(_OUT_KINDS.get(t, 0) for t in out_dtypes)

    whole = not presorted and n <= SORT_WHOLE_ROWS
    if whole:  # the page sorts whole, its dead rows' sentinels last
        sk, order = torch.sort(pk.pack(keys, row_mask, False, "sorted_group_agg"), stable=True)
        perm, rows, m = None, order, n
    else:
        live_keys, rows, order, m = compact_live(keys, row_mask, presorted, runs)
        if presorted:  # the live rows in page order stand in for the sorted ones
            sk, perm = live_keys, None
        else:
            sk, perm = torch.sort(live_keys, stable=True)
            if rows is None:  # every row live: the sort's permutation is the order
                order, perm = perm, None
            elif order is None:
                order = torch.empty(m, dtype=torch.int64, device=dev)
    scan = torch.empty(m + 2, dtype=torch.int32, device=dev)  # [m + 1]: a live count
    partials = torch.empty(-(-m // SCAN_TILE) + 1, dtype=torch.int32, device=dev)
    fn = lib.k6_group_heads
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p, ctypes.c_longlong] + [ctypes.c_void_p] * 7
    build.check(fn(sk.data_ptr(), m, perm.data_ptr() if perm is not None else None,
                   rows.data_ptr() if rows is not None else None, order.data_ptr(),
                   scan.data_ptr(), partials.data_ptr(),
                   scan.data_ptr() + 4 * (m + 1) if whole else None, stream),
                "sorted_group_agg")
    # the synchronisation that sizes the outputs (a whole page's live
    # count with it)
    if whole:
        groups, m = scan[m:].tolist()
    else:
        groups = int(scan[m])

    key_out: List[Tuple[torch.Tensor, torch.Tensor]] = [
        (torch.empty(groups, dtype=d.dtype, device=dev),
         torch.empty(groups, dtype=torch.bool, device=dev)) for d, _, _, _ in keys]
    outs = [torch.empty((groups, 2) if kind in _PAIRS else (groups, 5) if kind in _FIVES
                        else (groups,), dtype=t, device=dev)
            for (kind, _, _), t in zip(states, out_dtypes)]
    width = sum(_WIDTH.get(kind, 1) for kind, _, _ in states)
    raw = torch.empty(max(groups * width, 1), dtype=torch.int64, device=dev)
    fn = lib.k6_group_states
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,
                   ctypes.c_longlong, ctypes.c_int] + [ctypes.c_void_p] * 5 + \
        [ctypes.c_int] + [ctypes.c_void_p] * 8
    err = fn(order.data_ptr(), m, scan.data_ptr(), groups, len(keys), key_src, key_valid,
             build.ptrs(d.data_ptr() for d, _ in key_out),
             build.ptrs(v.data_ptr() for _, v in key_out), key_width, len(states), state_kinds,
             data_ptrs, data_kinds, valid_ptrs, build.ptrs(o.data_ptr() for o in outs),
             out_kinds, raw.data_ptr(), stream)
    build.check(err, "sorted_group_agg")
    outs = _double_states(plan, outs, order, m, scan, groups, lib, stream)
    launches += 1
    presorted_launches += int(presorted)
    minmax_launches += int(any(k in _EXTREMES for k, _, _ in states))
    kinds = {k for k, _, _, _ in plan}
    variance_launches += int(S_VAR in kinds)
    variance_merge_launches += int(S_VAR_MERGE in kinds)
    double_sum_launches += int(S_DSUM in kinds)
    names = {KIND_NAMES[k] for k in kinds | {k for k, _, _ in states} if k in KIND_NAMES}
    names |= {"min_bool" for k, d, _ in states if k in (S_MIN, S_MAX)
              and d.dtype == torch.bool}
    data = [d for _, d, _, _ in plan] + [d for _, d, _ in states]
    if any(isinstance(d, torch.Tensor) and d.dtype in _NARROW for d in data):
        names.add("narrow")
    for name in names:
        kind_launches[name] = kind_launches.get(name, 0) + 1
    if runs:
        starts = torch.empty(groups + 1, dtype=torch.int64, device=dev)
        fn = lib.k6_run_starts
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong, ctypes.c_void_p,
                       ctypes.c_void_p]
        build.check(fn(scan.data_ptr(), m, groups, starts.data_ptr(), stream),
                    "sorted_group_agg")
        return key_out, outs, groups, (order, starts)
    return key_out, outs, groups


def compact_live(keys: Sequence[pk.Key], row_mask: torch.Tensor, presorted: bool = False,
                 runs: bool = False):
    """K6's first pass on the card: ``(live keys, live row ids, order,
    live count)``.  The masked keys (``keys.cu``) of the live rows and
    their ids, densely in input order.  ``order`` (n int64, or None when
    neither ``presorted`` nor ``runs``) holds, with ``runs``, the dead
    rows' ids after the live count, in input order (where a stable sort
    of the whole page puts the sentinels); ``presorted``: the live row
    ids themselves.  The host reads the live count (the call's first
    synchronisation) between the count and the compaction: where every
    row is live and not ``presorted``, the page is its own compaction,
    ``(masked keys, None, None, n)``.  CPU tensors take the plain version
    (``rows`` and ``order`` alike: the live ids, then the dead)."""
    n = row_mask.shape[0]
    dev = row_mask.device
    if not row_mask.is_cuda:
        masked = _masked_plain(keys, row_mask)
        live = masked != pk.I64_MAX
        order = torch.cat([torch.nonzero(live).flatten(), torch.nonzero(~live).flatten()])
        m = int(live.sum())
        return masked[order[:m]], order, order, m
    lib, stream = build.library(), build.stream_of(row_mask)
    masked = pk.pack(keys, row_mask, False, "sorted_group_agg")
    tiles = -(-n // SCAN_TILE)
    partials = torch.empty(tiles + 1, dtype=torch.int32, device=dev)
    fn = lib.k6_count_live
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong] + [ctypes.c_void_p] * 2
    build.check(fn(row_mask.data_ptr(), masked.data_ptr(), n, partials.data_ptr(), stream),
                "sorted_group_agg")
    m = int(partials[tiles])
    if m == n and not presorted:
        return masked, None, None, m
    live_keys = torch.empty(m, dtype=torch.int64, device=dev)
    order = torch.empty(n, dtype=torch.int64, device=dev) if presorted or runs else None
    rows = order if presorted else torch.empty(m, dtype=torch.int64, device=dev)
    fn = lib.k6_compact_rows
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong] + [ctypes.c_void_p] * 5
    build.check(fn(row_mask.data_ptr(), masked.data_ptr(), n, live_keys.data_ptr(),
                   rows.data_ptr(), order.data_ptr() if runs else None, partials.data_ptr(),
                   stream), "sorted_group_agg")
    return live_keys, rows, order, m


def compact_plain(masked: torch.Tensor, presorted: bool = False):
    """The plain version of K6's positions: ``(sorted live keys, order)``.
    The live rows (masked key not the sentinel) compact in input order
    and only their keys sort (stably; ``presorted``: they keep page
    order); ``order`` is their row ids in that order, then the dead rows'
    ids in input order.  Equal to the twin's sort of the whole page over
    the live positions, since the sentinel sorts last."""
    live = masked != pk.I64_MAX
    rows = torch.nonzero(live).flatten()
    dead = torch.nonzero(~live).flatten()
    sk = masked[rows]
    if not presorted:
        sk, perm = torch.sort(sk, stable=True)
        rows = rows[perm]
    return sk, torch.cat([rows, dead])


def _double_states(plan, int_outs, order, m, scan, groups, lib, stream):
    """The state columns in ``plan``'s order: each integer state's
    output, and each double state's fixed-order sums (K6's double
    pass) over the m sorted live positions, its counts from its integer
    state."""
    dev = order.device
    outs = []
    if any(k is not None for k, _, _, _ in plan):
        bound = -(-m // DSUM_CHUNK) + groups + 1
        starts = torch.empty(groups + 1, dtype=torch.int64, device=dev)
        base = torch.empty(groups + 1, dtype=torch.int32, device=dev)
        partials = torch.empty(-(-(groups + 1) // SCAN_TILE) + 1, dtype=torch.int32,
                               device=dev)
        chunk_group = torch.empty(bound, dtype=torch.int32, device=dev)
        part = torch.empty(bound, dtype=torch.float64, device=dev)
        fn = lib.k6_double_state
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,
                       ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p, ctypes.c_int] + \
            [ctypes.c_void_p] * 15 + [ctypes.c_longlong, ctypes.c_void_p]
    for kind, data, valid, idx in plan:
        if kind is None:
            outs.append(int_outs[idx])
            continue
        sums = [torch.empty(groups, dtype=torch.float64, device=dev) for _ in range(4)]
        cnt = int_outs[idx] if idx is not None else None
        # x (or s_i), m2_i, m3_i, m4_i and c_i
        cols = tuple(data) if kind in _DOUBLE_COLS else (data,)
        if kind == S_VAR_MERGE:
            cols = (cols[0], cols[1], None, None, cols[2])
        cols += (None,) * (5 - len(cols))
        ptr = [c.data_ptr() if c is not None else None for c in cols]
        err = fn(order.data_ptr(), m, scan.data_ptr(), groups, kind,
                 ptr[0], int(cols[0].dtype == torch.float32), valid.data_ptr(), ptr[1], ptr[2],
                 ptr[3], ptr[4],
                 cnt.data_ptr() if cnt is not None else None,
                 *(t.data_ptr() for t in sums), starts.data_ptr(), base.data_ptr(),
                 partials.data_ptr(), chunk_group.data_ptr(), part.data_ptr(), bound, stream)
        build.check(err, "sorted_group_agg")
        n_out = _DOUBLE_OUTS[kind]
        outs.extend(sums[:n_out - 1] + [cnt] if n_out > 1 else sums[:1])
    return outs
