"""K14 ``group_collect``: the per-group element lists of array_agg, map_agg,
hll_sketch, multimap_agg and map_union.

:func:`group_collect` writes each group's selected rows, in the order
they appear in the group's run of sorted positions (K6's stable sort
keeps the input order within a group), into slots ``1..cap`` of the
group's row of a ``(groups, 1 + halves * cap)`` matrix: a NULL value
as the sentinel, rows past ``cap`` dropped, the length ``min(selected,
cap)`` in slot 0.  The last half may be ``vw`` slots wide per element
(multimap_agg's value half: each entry's array row, a ``(cap, vw)``
block, the sentinel throughout for a NULL array).
:func:`group_collect_merge` concatenates partial states: each live
partial's elements land at the group's running offset, in the order of
the group's run, capped at ``cap``, the length ``min(total, cap)``;
map_union's partial state is that merge over its input maps, whose
slot count ``in_cap`` may differ from the state's.  The reference's
``grouped_aggregate`` branches for array_agg, map_agg, hll_sketch,
multimap_agg and map_union (``presto_tpu/ops/aggregate.py:640``,
``:660``, ``:684``, ``:709``: a scatter to ``(group, rank)`` slots, the
rank from the stable ``_within_group_rank`` :1014) and their merge
(``:1185``).  There is no per-group atomic counter: an atomic's order
would differ from the reference's.  CUDA tensors launch
``csrc/group_collect.cu``; CPU tensors run the plain versions.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Sequence, Tuple

import torch

from presto_tpu_torch.kernels import build
from presto_tpu_torch.kernels.container_eval import astype_values, cast_values, lengths, \
    sentinel

_KIND = {torch.bool: 0, torch.int32: 1, torch.int64: 2, torch.float64: 3}
STORAGE = (torch.int32, torch.int64, torch.float64)

launches = 0
merge_launches = 0
#: launches with a value half wider than one slot (multimap_agg)
wide_launches = 0
#: merges over input maps (map_union's partial state)
union_launches = 0

Column = Tuple[torch.Tensor, torch.Tensor]


def _positions(order: Optional[torch.Tensor], starts: torch.Tensor):
    """(group of each run position, row of each position, first
    position of each position's group) over the positions in runs."""
    dev = starts.device
    groups = starts.shape[0] - 1
    live = int(starts[-1]) if groups else 0
    counts = starts[1:] - starts[:-1]
    g = torch.repeat_interleave(torch.arange(groups, device=dev), counts)
    p = torch.arange(live, device=dev)
    rows = order[:live].to(torch.int64) if order is not None else p
    return g, rows, starts[:-1][g]


def _lane_values(d: torch.Tensor, v: Optional[torch.Tensor], storage) -> torch.Tensor:
    x = d.to(storage) if d.dtype == torch.bool else cast_values(d, storage)
    if v is None:
        return x
    return torch.where(v, x, torch.full_like(x, sentinel(storage)))


def group_collect_plain(order, starts, sel, halves: Sequence[Column], cap: int, storage):
    groups = starts.shape[0] - 1
    dev = starts.device
    last = halves[-1][0]
    vw = last.shape[1] if last.dim() == 2 else 1
    out = torch.full((groups, 1 + (len(halves) - 1) * cap + cap * vw), sentinel(storage),
                     dtype=storage, device=dev)
    g, rows, first = _positions(order, starts)
    s = sel[rows].to(torch.int64)
    before = torch.cumsum(s, 0) - s  # selected positions before each position
    rank = before - before[first] if before.numel() else before
    ok = (s > 0) & (rank < cap)
    for h, (d, v) in enumerate(halves[:-1]):
        out[g[ok], 1 + h * cap + rank[ok]] = _lane_values(d[rows], None, storage)[ok]
    d, v = halves[-1]
    base = 1 + (len(halves) - 1) * cap
    if vw == 1:
        vals = _lane_values(d[rows], v[rows], storage)[:, None]
    else:  # an array row converts as the reference's astype, its slots' sentinels too
        vals = astype_values(d[rows], storage)
        vals = torch.where(v[rows][:, None], vals, torch.full_like(vals, sentinel(storage)))
    for c in range(vw):
        out[g[ok], base + rank[ok] * vw + c] = vals[ok, c]
    count = torch.zeros(groups, dtype=torch.int64, device=dev).index_add_(0, g, s)
    out[:, 0] = torch.clamp(count, max=cap).to(storage)
    return out


def _widths(halves: int, vw: int):
    return [1] * (halves - 1) + [vw]


def group_collect_merge_plain(order, starts, live, parts: torch.Tensor, cap: int,
                              halves: Optional[int] = None, vw: int = 1,
                              in_cap: Optional[int] = None):
    halves = (parts.shape[1] - 1) // cap if halves is None else halves
    in_cap = cap if in_cap is None else in_cap
    groups = starts.shape[0] - 1
    dev = starts.device
    storage = parts.dtype
    widths = _widths(halves, vw)
    out = torch.full((groups, 1 + cap * sum(widths)), sentinel(storage), dtype=storage,
                     device=dev)
    g, rows, first = _positions(order, starts)
    L = torch.where(live[rows], torch.clamp(lengths(parts)[rows], max=in_cap),
                    torch.zeros_like(rows))
    before = torch.cumsum(L, 0) - L
    off = before - before[first] if before.numel() else before
    for j in range(in_cap):
        ok = (j < L) & (off + j < cap)
        o_in, o_out = 1, 1
        for w in widths:
            for c in range(w):
                out[g[ok], o_out + (off[ok] + j) * w + c] = parts[rows[ok], o_in + j * w + c]
            o_in += in_cap * w
            o_out += cap * w
    total = torch.zeros(groups, dtype=torch.int64, device=dev).index_add_(0, g, L)
    out[:, 0] = torch.clamp(total, max=cap).to(storage)
    return out


def _check_runs(order, starts, n, what):
    if starts.dtype != torch.int64 or starts.dim() != 1 or starts.shape[0] < 1:
        raise ValueError(f"{what}: starts must be (groups + 1,) int64")
    if order is not None and (order.dtype != torch.int64 or order.shape != (n,)):
        raise ValueError(f"{what}: order must be (n,) int64")


def group_collect(order: Optional[torch.Tensor], starts: torch.Tensor, sel: torch.Tensor,
                  halves: Sequence[Column], cap: int, storage: torch.dtype) -> torch.Tensor:
    """The ``(groups, 1 + (len(halves) - 1) * cap + cap * vw)`` state
    matrix of the groups whose rows are the run positions ``starts[g] ..
    starts[g + 1]`` (the row at position ``p`` is ``order[p]``, or ``p``
    without ``order``): the selected rows' values in run order.
    ``halves``: the value lane (array_agg), or the key and value lanes
    (map_agg, hll_sketch, multimap_agg; the keys' NULL rows are left out
    of ``sel`` and the values' NULLs stored as the sentinel); the last
    lane's data may be ``(n, vw)`` (multimap_agg's arrays)."""
    n = sel.shape[0]
    if not 1 <= len(halves) <= 2 or cap < 1:
        raise ValueError("group_collect: one or two halves, cap >= 1")
    if not sel.is_cuda:
        return group_collect_plain(order, starts, sel, halves, cap, storage)
    global launches, wide_launches
    _check_runs(order, starts, n, "group_collect")
    if sel.dtype != torch.bool or storage not in STORAGE:
        raise ValueError("group_collect: sel (n,) bool; storage int32, int64 or float64")
    for h, (d, v) in enumerate(halves):
        wide = h == len(halves) - 1 and d.dim() == 2
        if d.shape[0] != n or d.dim() != (2 if wide else 1) or d.dtype not in _KIND \
                or v.shape != (n,) or v.dtype != torch.bool:
            raise ValueError("group_collect: lanes are (n,) bool, int32, int64 or float64 "
                             "(the last may be (n, vw))")
    vw = halves[-1][0].shape[1] if halves[-1][0].dim() == 2 else 1
    tensors = [starts, sel] + [t for c in halves for t in c] + \
        ([order] if order is not None else [])
    build.require_cuda(tensors, "group_collect")
    groups = starts.shape[0] - 1
    out = torch.empty((groups, 1 + (len(halves) - 1) * cap + cap * vw), dtype=storage,
                      device=sel.device)
    fn = build.library().k14_group_collect
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_int] + [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + \
        [ctypes.c_void_p] * 2
    err = fn(groups, order.data_ptr() if order is not None else None, starts.data_ptr(),
             sel.data_ptr(), len(halves), build.ptrs(d.data_ptr() for d, _ in halves),
             build.ptrs(v.data_ptr() for _, v in halves),
             build.ints(_KIND[d.dtype] for d, _ in halves), cap, vw, _KIND[storage],
             out.data_ptr(), build.stream_of(sel))
    build.check(err, "group_collect")
    launches += 1
    wide_launches += int(vw > 1)
    return out


def group_collect_merge(order: Optional[torch.Tensor], starts: torch.Tensor,
                        live: torch.Tensor, parts: torch.Tensor, cap: int,
                        halves: Optional[int] = None, vw: int = 1,
                        in_cap: Optional[int] = None) -> torch.Tensor:
    """Partial state matrices ``parts`` merged per group (runs as in
    :func:`group_collect`; ``live`` marks the partial rows to take):
    ``halves`` halves (by default as many as the width gives), the last
    ``vw`` slots per element.  ``in_cap``: the rows' own slot count when
    they are map_union's input maps (each row's length clamped to it);
    by default ``cap``."""
    n = live.shape[0]
    halves = (parts.shape[1] - 1) // cap if halves is None else halves
    union = in_cap is not None
    in_cap = cap if in_cap is None else in_cap
    if parts.dim() != 2 or parts.shape[0] != n or not 1 <= halves <= 2 or vw < 1 \
            or parts.shape[1] != 1 + in_cap * sum(_widths(halves, vw)):
        raise ValueError("group_collect_merge: parts must be (n, 1 + in_cap * (halves - 1 "
                         "+ vw))")
    if not live.is_cuda:
        return group_collect_merge_plain(order, starts, live, parts, cap, halves, vw, in_cap)
    global launches, merge_launches, wide_launches, union_launches
    _check_runs(order, starts, n, "group_collect_merge")
    if live.dtype != torch.bool or parts.dtype not in STORAGE:
        raise ValueError("group_collect_merge: live (n,) bool; parts int32, int64 or "
                         "float64")
    build.require_cuda([starts, live, parts] + ([order] if order is not None else []),
                       "group_collect_merge")
    groups = starts.shape[0] - 1
    out = torch.empty((groups, 1 + cap * sum(_widths(halves, vw))), dtype=parts.dtype,
                      device=live.device)
    fn = build.library().k14_group_collect_merge
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_longlong] + [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + \
        [ctypes.c_void_p] * 2
    err = fn(groups, order.data_ptr() if order is not None else None, starts.data_ptr(),
             live.data_ptr(), parts.data_ptr(), halves, vw, in_cap, cap, _KIND[parts.dtype],
             out.data_ptr(), build.stream_of(live))
    build.check(err, "group_collect_merge")
    launches += 1
    merge_launches += int(not union)
    union_launches += int(union)
    wide_launches += int(vw > 1)
    return out
