"""K2 ``packed_group_agg``: partial aggregation states per packed group.

:func:`packed_group_agg` computes, for each of ``n_groups`` slots, the
partial states the reference's ``grouped_aggregate(mode="partial")``
emits on its global and packed-direct branches: counts, short sums in
one int64, long sums as two normalised base-10^18 limbs, the least or
greatest value of a short (int32/int64) or long (two-limb) argument
beside its count of non-null rows, a double sum beside its count
(SUM_DOUBLE), or the variance state ``(s, m2, cnt)`` of a double
argument (VARIANCE), plus the ``present`` flag of each slot.  Double
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
    SUM_LONG_ARG, SUM_DOUBLE, VARIANCE = range(11)
RAW_WIDTH = {COUNT_STAR: 1, COUNT: 1, SUM_SHORT: 2, SUM_LONG: 5, MIN_SHORT: 2, MAX_SHORT: 2,
             MIN_LONG: 3, MAX_LONG: 3, SUM_LONG_ARG: 5, SUM_DOUBLE: 1, VARIANCE: 1}
EXTREMES = (MIN_SHORT, MAX_SHORT, MIN_LONG, MAX_LONG)
LONG_ARG = (MIN_LONG, MAX_LONG, SUM_LONG_ARG)  # kinds whose argument is (n, 2) limbs
DOUBLE_ARG = (SUM_DOUBLE, VARIANCE)  # kinds whose argument is a double
# the slots a double state may have here: one, the global aggregate's
# (ops/aggregate.takes_sort_path sends keyed double states to K6, so
# every keyed double sum has one order, K6's)
DOUBLE_SLOT_LIMIT = 1
# rows per chunk of the fixed summation order (csrc/packed_group_agg.cu)
DSUM_CHUNK = 256
MAX_KEYS = 16
MAX_AGGS = 32
_KINDS = {torch.bool: 0, torch.int32: 1, torch.int64: 2}
KIND_D128, KIND_F64 = 3, 4

launches = 0
#: launches whose aggregates include a min or max
minmax_launches = 0
#: launches with a variance state, and with a double sum
variance_launches = 0
double_sum_launches = 0

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
    """The reference's ``_minmax_long``: the high limb's extreme per
    slot, then the low limb's among the rows that tie on it."""
    hi = seg_extreme(limbs[:, 0], slot, n_slots, is_min)
    tie = slot < n_slots
    tie = tie & (limbs[:, 0] == hi[torch.clamp(slot, max=max(n_slots - 1, 0))])
    lo = seg_extreme(limbs[:, 1], torch.where(tie, slot, torch.full_like(slot, n_slots)),
                     n_slots, is_min)
    return torch.stack([hi, lo], dim=1)


def narrow(ext: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """An int64 extreme state in the argument's storage (the int64
    identities become the narrower type's)."""
    if dtype == torch.int64:
        return ext
    big, small = torch.iinfo(torch.int64), torch.iinfo(dtype)
    out = torch.where(ext == big.max, small.max, torch.where(ext == big.min, small.min, ext))
    return out.to(dtype)


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
    count]``) or ``[s, m2, count]`` (VARIANCE)."""
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
    for kind, data, valid in aggs:
        if kind == COUNT_STAR:
            states.append([seg(live.to(torch.int64))])
            continue
        nonnull = live & valid
        cnt = seg(nonnull.to(torch.int64))
        if kind == COUNT:
            states.append([cnt])
        elif kind in EXTREMES:
            is_min = kind in (MIN_SHORT, MIN_LONG)
            nn_slot = torch.where(nonnull, slot, torch.full_like(slot, n_groups))
            if kind in LONG_ARG:
                states.append([seg_extreme_long(data, nn_slot, n_groups, is_min), cnt])
            else:
                ext = seg_extreme(data.to(torch.int64), nn_slot, n_groups, is_min)
                states.append([narrow(ext, data.dtype), cnt])
        elif kind == SUM_SHORT:
            x = torch.where(nonnull, data.to(torch.int64), torch.zeros_like(gid))
            states.append([seg(x), cnt])
        elif kind in DOUBLE_ARG:
            nn_slot = torch.where(nonnull, slot, torch.full_like(slot, n_groups))
            x = torch.where(nonnull, data, torch.zeros_like(data))
            s = chunk_sums_plain(x, nn_slot, n_groups)
            if kind == SUM_DOUBLE:
                states.append([s, cnt])
                continue
            mu = s / torch.clamp(cnt, min=1).to(torch.float64)
            dx = torch.where(nonnull, x - mu[torch.clamp(nn_slot, max=n_groups - 1)],
                             torch.zeros_like(x))
            states.append([s, chunk_sums_plain(dx * dx, nn_slot, n_groups), cnt])
        else:
            if kind == SUM_LONG_ARG:
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
    if any(k in DOUBLE_ARG for k, _, _ in aggs) and n_groups > DOUBLE_SLOT_LIMIT:
        raise ValueError(f"packed_group_agg: double states over {n_groups} slots")
    if not row_mask.is_cuda:
        return packed_group_agg_plain(n, row_mask, keys, aggs, n_groups)
    return _launch(n, row_mask, keys, aggs, n_groups)


def _check_col(data, valid, n, what, limbs=False, double=False):
    if double:
        if data.shape != (n,) or data.dtype != torch.float64:
            raise ValueError(f"packed_group_agg: {what} must be (n,) float64")
    elif limbs:
        if data.shape != (n, 2) or data.dtype != torch.int64:
            raise ValueError(f"packed_group_agg: {what} must be (n, 2) int64 limbs")
    elif data.dim() != 1 or data.shape[0] != n or data.dtype not in _KINDS:
        raise ValueError(f"packed_group_agg: {what} must be (n,) int32/int64/bool")
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
        if kind != COUNT_STAR:
            _check_col(data, valid, n, "argument", kind in LONG_ARG, kind in DOUBLE_ARG)
            if kind in EXTREMES and data.dtype == torch.bool:
                raise ValueError("packed_group_agg: min/max over booleans")
            tensors += [data, valid]
    doubles = any(k in DOUBLE_ARG for k, _, _ in aggs)
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
        elif kind == SUM_DOUBLE:
            states.append([torch.empty(n_groups, dtype=torch.float64, device=dev), cnt])
        elif kind == VARIANCE:
            states.append([torch.empty(n_groups, dtype=torch.float64, device=dev),
                           torch.empty(n_groups, dtype=torch.float64, device=dev), cnt])
        else:
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
    c_arg_kind = build.ints((KIND_D128 if k in LONG_ARG else KIND_F64 if k in DOUBLE_ARG
                             else _KINDS[d.dtype]) if d is not None else 0
                            for k, d, _ in aggs)
    c_out0 = build.ptrs(s[0].data_ptr() for s in states)
    c_out1 = build.ptrs(s[1].data_ptr() if len(s) > 1 else null for s in states)
    c_out2 = build.ptrs(s[2].data_ptr() if len(s) > 2 else null for s in states)
    fn = build.library().k2_packed_group_agg
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_longlong, ctypes.c_void_p,
                   ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_void_p,
                   ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_void_p]
    err = fn(n, row_mask.data_ptr(),
             len(keys), c_key_data, c_key_valid, c_key_kind, c_key_lo, c_key_card,
             len(aggs), c_agg_kind, c_arg_data, c_arg_valid, c_arg_kind,
             n_groups, raw_width, raw.data_ptr(), c_out0, c_out1, c_out2, present.data_ptr(),
             scratch.data_ptr(), build.stream_of(row_mask))
    build.check(err, "packed_group_agg")
    launches += 1
    if any(k in EXTREMES for k, _, _ in aggs):
        minmax_launches += 1
    variance_launches += int(any(k == VARIANCE for k, _, _ in aggs))
    double_sum_launches += int(any(k == SUM_DOUBLE for k, _, _ in aggs))
    return states, present
