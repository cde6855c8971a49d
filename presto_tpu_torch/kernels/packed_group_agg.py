"""K2 ``packed_group_agg``: partial aggregation states per packed group.

:func:`packed_group_agg` computes, for each of ``n_groups`` slots, the
partial states the reference's ``grouped_aggregate(mode="partial")``
emits on its global and packed-direct branches: counts, short sums in
one int64, long sums as two normalised base-10^18 limbs, the least or
greatest value of a short (int32/int64) or long (two-limb) argument
beside its count of non-null rows, plus the ``present`` flag of each
slot.  On a CUDA tensor it launches
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
COUNT_STAR, COUNT, SUM_SHORT, SUM_LONG, MIN_SHORT, MAX_SHORT, MIN_LONG, MAX_LONG = range(8)
RAW_WIDTH = {COUNT_STAR: 1, COUNT: 1, SUM_SHORT: 2, SUM_LONG: 5, MIN_SHORT: 2, MAX_SHORT: 2,
             MIN_LONG: 3, MAX_LONG: 3}
EXTREMES = (MIN_SHORT, MAX_SHORT, MIN_LONG, MAX_LONG)
LONG_ARG = (MIN_LONG, MAX_LONG)  # kinds whose argument is (n, 2) limbs
MAX_KEYS = 8
MAX_AGGS = 32
_KINDS = {torch.bool: 0, torch.int32: 1, torch.int64: 2}
KIND_D128 = 3

launches = 0
#: launches whose aggregates include a min or max
minmax_launches = 0

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


def packed_group_agg_plain(n: int, row_mask: torch.Tensor, keys: Sequence[Key],
                           aggs: Sequence[Agg], n_groups: int):
    """Plain torch version: ``(states, present)`` where ``states`` holds
    per aggregate ``[count]`` or ``[sum, count]``."""
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
    if not row_mask.is_cuda:
        return packed_group_agg_plain(n, row_mask, keys, aggs, n_groups)
    return _launch(n, row_mask, keys, aggs, n_groups)


def _check_col(data, valid, n, what, limbs=False):
    if limbs:
        if data.shape != (n, 2) or data.dtype != torch.int64:
            raise ValueError(f"packed_group_agg: {what} must be (n, 2) int64 limbs")
    elif data.dim() != 1 or data.shape[0] != n or data.dtype not in _KINDS:
        raise ValueError(f"packed_group_agg: {what} must be (n,) int32/int64/bool")
    if valid.dtype != torch.bool or valid.shape != (n,):
        raise ValueError(f"packed_group_agg: {what} validity must be (n,) bool")


def _launch(n, row_mask, keys, aggs, n_groups):
    global launches, minmax_launches
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
            _check_col(data, valid, n, "argument", kind in LONG_ARG)
            if kind in EXTREMES and data.dtype == torch.bool:
                raise ValueError("packed_group_agg: min/max over booleans")
            tensors += [data, valid]
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
        elif kind in (SUM_LONG, MIN_LONG, MAX_LONG):
            states.append([torch.empty((n_groups, 2), dtype=torch.int64, device=dev), cnt])
        else:
            states.append([cnt])
    null = 0
    c_key_data = build.ptrs(d.data_ptr() for d, _, _, _ in keys)
    c_key_valid = build.ptrs(v.data_ptr() for _, v, _, _ in keys)
    c_key_kind = build.ints(_KINDS[d.dtype] for d, _, _, _ in keys)
    c_key_lo = build.ptrs(lo for _, _, lo, _ in keys)
    c_key_card = build.ptrs(card for _, _, _, card in keys)
    c_agg_kind = build.ints(k for k, _, _ in aggs)
    c_arg_data = build.ptrs(d.data_ptr() if d is not None else null for _, d, _ in aggs)
    c_arg_valid = build.ptrs(v.data_ptr() if v is not None else null for _, _, v in aggs)
    c_arg_kind = build.ints((KIND_D128 if k in LONG_ARG else _KINDS[d.dtype])
                            if d is not None else 0 for k, d, _ in aggs)
    c_out0 = build.ptrs(s[0].data_ptr() for s in states)
    c_out1 = build.ptrs(s[1].data_ptr() if len(s) > 1 else null for s in states)
    fn = build.library().k2_packed_group_agg
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_longlong, ctypes.c_void_p,
                   ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_void_p,
                   ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
    err = fn(n, row_mask.data_ptr(),
             len(keys), c_key_data, c_key_valid, c_key_kind, c_key_lo, c_key_card,
             len(aggs), c_agg_kind, c_arg_data, c_arg_valid, c_arg_kind,
             n_groups, raw_width, raw.data_ptr(), c_out0, c_out1, present.data_ptr(),
             build.stream_of(row_mask))
    build.check(err, "packed_group_agg")
    launches += 1
    if any(k in EXTREMES for k, _, _ in aggs):
        minmax_launches += 1
    return states, present
