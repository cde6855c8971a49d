"""K6 ``sorted_group_agg``: grouped states over sorted packed keys.

:func:`sorted_group_agg` packs the group keys exactly, or hashes them
(K9) when they have no exact domain (NULL keys group together, dead
rows take a sentinel that sorts last), sorts them with
``torch.sort(stable=True)`` (the reference leaves its argsort to XLA),
numbers the runs of equal keys in key order, and sums each
group's states exactly; the reference's ``_sorted_group_ids``,
``_SortCtx.sum`` and the sort path of ``grouped_aggregate`` /
``merge_aggregate`` (``presto_tpu/ops/aggregate.py``).  It returns
every group it sees (the host reads the group count once and sizes
the outputs from it) with each group's first row's key values.  CUDA
tensors launch ``csrc/sorted_group_agg.cu``; CPU tensors run
:func:`sorted_group_agg_plain`.

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
    S_MAX_LONG = range(9)
_LIMBS = (S_LIMBS_SHORT, S_LIMBS_LONG)
_PAIRS = (S_LIMBS_SHORT, S_LIMBS_LONG, S_MIN_LONG, S_MAX_LONG)  # (G, 2) outputs
_EXTREMES = (S_MIN, S_MAX, S_MIN_LONG, S_MAX_LONG)
MAX_STATES = 16
MAX_SLOTS = 64  # csrc/sorted_group_agg.cu K6_MAX_SLOTS
_WIDTH = {S_LIMBS_SHORT: 4, S_LIMBS_LONG: 4, S_MIN_LONG: 2, S_MAX_LONG: 2}
SCAN_TILE = 2048  # csrc/scan.cuh SCAN_TILE
_DATA_KINDS = {torch.bool: 0, torch.int32: 1, torch.int64: 2}

launches = 0
#: launches in presorted mode, and launches with a min/max state
presorted_launches = 0
minmax_launches = 0

# (kind, data or None, valid or None)
State = Tuple[int, Optional[torch.Tensor], Optional[torch.Tensor]]


def _limbs(kind: int, data: torch.Tensor) -> torch.Tensor:
    if kind == S_LIMBS_SHORT:
        return d128.to_sum_limbs(d128.from_int64(data.to(torch.int64)))
    return d128.to_sum_limbs(data)


def sorted_group_agg_plain(keys: Sequence[pk.Key], row_mask: torch.Tensor,
                           states: Sequence[State], presorted: bool = False):
    """``(key columns [(data, valid)...], state columns, groups)``; the
    plain version."""
    n = row_mask.shape[0]
    key, _ = pk.pack_plain(keys, n, row_mask.device)
    masked = torch.where(row_mask, key, torch.full_like(key, pk.I64_MAX))
    if presorted:  # the live rows in page order, the dead ones after them
        order = torch.cat([torch.nonzero(row_mask).flatten(), torch.nonzero(~row_mask).flatten()])
        sk = masked[order]
    else:
        sk, order = torch.sort(masked, stable=True)
    live = sk != pk.I64_MAX
    first = live.clone()
    first[1:] &= sk[1:] != sk[:-1]
    groups = int(first.sum())
    gid = (torch.cumsum(first.to(torch.int64), 0) - 1)[live]
    rows = order[live]
    rep = order[first]
    key_out = [(d[rep], v[rep]) for d, v, _, _ in keys]
    outs = []
    for kind, data, valid in states:
        if kind in _EXTREMES:
            outs.append(_extreme_plain(kind, data, valid, rows, gid, groups))
            continue
        if kind == S_ONE:
            vals = torch.ones(rows.shape[0], dtype=torch.int64, device=row_mask.device)
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
                          device=row_mask.device)
        acc.index_add_(0, gid, vals)
        outs.append(d128.from_sum_limbs(acc) if kind in (S_LIMBS_SHORT, S_LIMBS_LONG)
                    else acc)
    return key_out, outs, groups


def _extreme_plain(kind, data, valid, rows, gid, groups):
    from presto_tpu_torch.kernels.packed_group_agg import narrow, seg_extreme, seg_extreme_long

    ok = valid[rows]
    slot = torch.where(ok, gid, torch.full_like(gid, groups))
    is_min = kind in (S_MIN, S_MIN_LONG)
    if kind in (S_MIN_LONG, S_MAX_LONG):
        return seg_extreme_long(data[rows], slot, groups, is_min)
    return narrow(seg_extreme(data[rows].to(torch.int64), slot, groups, is_min), data.dtype)


def sorted_group_agg(keys: Sequence[pk.Key], row_mask: torch.Tensor,
                     states: Sequence[State], presorted: bool = False):
    """Group the live rows of ``row_mask`` by the packed ``keys`` and
    compute ``states`` per group: ``(key columns, state columns,
    groups)``, groups in packed-key order (``presorted``: in page
    order, runs of equal keys).  CPU tensors take the plain version;
    CUDA tensors launch the kernels around ``torch.sort`` (presorted:
    around K6's page-order pass)."""
    if not row_mask.is_cuda:
        return sorted_group_agg_plain(keys, row_mask, states, presorted)
    global launches, presorted_launches, minmax_launches
    n = row_mask.shape[0]
    if row_mask.dtype != torch.bool or row_mask.dim() != 1 or n >= (1 << 31) - 1:
        raise ValueError("sorted_group_agg: row_mask must be (n,) bool, n < 2^31")
    if len(states) > MAX_STATES:
        raise ValueError("sorted_group_agg: too many states")
    tensors = [row_mask] + pk.check(keys, n, "sorted_group_agg")
    for kind, data, valid in states:
        if not S_ONE <= kind <= S_MAX_LONG:
            raise ValueError(f"sorted_group_agg: state kind {kind}")
        if kind != S_ONE:
            if valid is None or valid.dtype != torch.bool or valid.shape != (n,):
                raise ValueError("sorted_group_agg: state validity must be (n,) bool")
            tensors.append(valid)
        if kind in (S_SUM, S_LIMBS_SHORT, S_MIN, S_MAX):
            if data is None or data.shape != (n,) or data.dtype not in _DATA_KINDS \
                    or (kind in _EXTREMES and data.dtype == torch.bool):
                raise ValueError("sorted_group_agg: state data must be (n,) integers")
            tensors.append(data)
        if kind in (S_LIMBS_LONG, S_MIN_LONG, S_MAX_LONG):
            if data is None or data.shape != (n, 2) or data.dtype != torch.int64:
                raise ValueError("sorted_group_agg: long state data must be (n, 2) int64")
            tensors.append(data)
    if sum(_WIDTH.get(k, 1) for k, _, _ in states) > MAX_SLOTS:
        raise ValueError("sorted_group_agg: too many state slots")
    build.require_cuda(tensors, "sorted_group_agg")
    dev = row_mask.device
    stream = build.stream_of(row_mask)
    lib = build.library()

    masked = pk.pack(keys, row_mask, False, "sorted_group_agg")
    scan = torch.empty(n + 1, dtype=torch.int32, device=dev)
    partials = torch.empty(-(-n // SCAN_TILE) + 1, dtype=torch.int32, device=dev)
    if presorted:  # K6's page-order pass in place of the sort
        sk = torch.empty_like(masked)
        order = torch.empty(n, dtype=torch.int64, device=dev)
        fn = lib.k6_presorted_order
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p, ctypes.c_longlong] + [ctypes.c_void_p] * 5
        build.check(fn(masked.data_ptr(), n, sk.data_ptr(), order.data_ptr(), scan.data_ptr(),
                       partials.data_ptr(), stream), "sorted_group_agg")
    else:
        sk, order = torch.sort(masked, stable=True)
    fn = lib.k6_group_heads
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_void_p]
    build.check(fn(sk.data_ptr(), n, scan.data_ptr(), partials.data_ptr(), stream),
                "sorted_group_agg")
    groups = int(scan[n])  # the one synchronisation: sizes the outputs

    key_out: List[Tuple[torch.Tensor, torch.Tensor]] = [
        (torch.empty(groups, dtype=d.dtype, device=dev),
         torch.empty(groups, dtype=torch.bool, device=dev)) for d, _, _, _ in keys]
    outs = [torch.empty((groups, 2) if kind in _PAIRS else (groups,),
                        dtype=data.dtype if kind in (S_MIN, S_MAX) else torch.int64, device=dev)
            for kind, data, _ in states]
    width = sum(_WIDTH.get(kind, 1) for kind, _, _ in states)
    raw = torch.empty(max(groups * width, 1), dtype=torch.int64, device=dev)
    fn = lib.k6_group_states
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,
                   ctypes.c_longlong, ctypes.c_int] + [ctypes.c_void_p] * 5 + \
        [ctypes.c_int] + [ctypes.c_void_p] * 8
    null = 0
    err = fn(sk.data_ptr(), order.data_ptr(), n, scan.data_ptr(), groups, len(keys),
             build.ptrs(d.data_ptr() for d, _, _, _ in keys),
             build.ptrs(v.data_ptr() for _, v, _, _ in keys),
             build.ptrs(d.data_ptr() for d, _ in key_out),
             build.ptrs(v.data_ptr() for _, v in key_out),
             build.ints(d.element_size() for d, _, _, _ in keys),
             len(states), build.ints(k for k, _, _ in states),
             build.ptrs(d.data_ptr() if d is not None else null for _, d, _ in states),
             build.ints(_DATA_KINDS.get(d.dtype, 2) if d is not None else 0
                        for _, d, _ in states),
             build.ptrs(v.data_ptr() if v is not None else null for _, _, v in states),
             build.ptrs(o.data_ptr() for o in outs),
             build.ints(int(o.dtype == torch.int32) for o in outs), raw.data_ptr(), stream)
    build.check(err, "sorted_group_agg")
    launches += 1
    presorted_launches += int(presorted)
    minmax_launches += int(any(k in _EXTREMES for k, _, _ in states))
    return key_out, outs, groups
