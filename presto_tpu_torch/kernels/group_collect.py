"""K14 ``group_collect``: array_agg's and map_agg's per-group element lists.

:func:`group_collect` writes each group's selected rows, in the order
they appear in the group's run of sorted positions (K6's stable sort
keeps the input order within a group), into slots ``1..cap`` of the
group's row of a ``(groups, 1 + halves * cap)`` matrix: a NULL value
as the sentinel, rows past ``cap`` dropped, the length ``min(selected,
cap)`` in slot 0.  :func:`group_collect_merge` concatenates partial
states: each live partial's elements land at the group's running
offset, in the order of the group's run, capped at ``cap``, the length
``min(total, cap)``.  The reference's ``grouped_aggregate`` branches
for array_agg and map_agg (``presto_tpu/ops/aggregate.py:640``,
``:660``: a scatter to ``(group, rank)`` slots, the rank from the
stable ``_within_group_rank`` :1014) and their merge (``:1185``).  There
is no per-group atomic counter: an atomic's order would differ from
the reference's.  CUDA tensors launch ``csrc/group_collect.cu``; CPU
tensors run the plain versions.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Sequence, Tuple

import torch

from presto_tpu_torch.kernels import build
from presto_tpu_torch.kernels.container_eval import cast_values, lengths, sentinel

_KIND = {torch.bool: 0, torch.int32: 1, torch.int64: 2, torch.float64: 3}
STORAGE = (torch.int32, torch.int64, torch.float64)

launches = 0
merge_launches = 0

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
    out = torch.full((groups, 1 + len(halves) * cap), sentinel(storage), dtype=storage,
                     device=dev)
    g, rows, first = _positions(order, starts)
    s = sel[rows].to(torch.int64)
    before = torch.cumsum(s, 0) - s  # selected positions before each position
    rank = before - before[first] if before.numel() else before
    ok = (s > 0) & (rank < cap)
    for h, (d, v) in enumerate(halves):
        vals = _lane_values(d[rows], None if h + 1 < len(halves) else v[rows], storage)
        out[g[ok], 1 + h * cap + rank[ok]] = vals[ok]
    count = torch.zeros(groups, dtype=torch.int64, device=dev).index_add_(0, g, s)
    out[:, 0] = torch.clamp(count, max=cap).to(storage)
    return out


def group_collect_merge_plain(order, starts, live, parts: torch.Tensor, cap: int):
    groups = starts.shape[0] - 1
    dev = starts.device
    storage = parts.dtype
    halves = (parts.shape[1] - 1) // cap
    out = torch.full((groups, parts.shape[1]), sentinel(storage), dtype=storage, device=dev)
    g, rows, first = _positions(order, starts)
    L = torch.where(live[rows], lengths(parts)[rows], torch.zeros_like(rows))
    before = torch.cumsum(L, 0) - L
    off = before - before[first] if before.numel() else before
    for j in range(cap):
        ok = (j < L) & (off + j < cap)
        for h in range(halves):
            out[g[ok], 1 + h * cap + off[ok] + j] = parts[rows[ok], 1 + h * cap + j]
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
    """The ``(groups, 1 + len(halves) * cap)`` state matrix of the groups
    whose rows are the run positions ``starts[g] .. starts[g + 1]`` (the
    row at position ``p`` is ``order[p]``, or ``p`` without ``order``):
    the selected rows' values in run order.  ``halves``: the value lane
    (array_agg), or the key and value lanes (map_agg; the keys' NULL
    rows are left out of ``sel`` and the values' NULLs stored as the
    sentinel)."""
    n = sel.shape[0]
    if not 1 <= len(halves) <= 2 or cap < 1:
        raise ValueError("group_collect: one or two halves, cap >= 1")
    if not sel.is_cuda:
        return group_collect_plain(order, starts, sel, halves, cap, storage)
    global launches
    _check_runs(order, starts, n, "group_collect")
    if sel.dtype != torch.bool or storage not in STORAGE:
        raise ValueError("group_collect: sel (n,) bool; storage int32, int64 or float64")
    for d, v in halves:
        if d.shape != (n,) or d.dtype not in _KIND or v.shape != (n,) or v.dtype != torch.bool:
            raise ValueError("group_collect: lanes are (n,) bool, int32, int64 or float64")
    tensors = [starts, sel] + [t for c in halves for t in c] + \
        ([order] if order is not None else [])
    build.require_cuda(tensors, "group_collect")
    groups = starts.shape[0] - 1
    out = torch.empty((groups, 1 + len(halves) * cap), dtype=storage, device=sel.device)
    fn = build.library().k14_group_collect
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_int] + [ctypes.c_void_p] * 3 + [ctypes.c_int, ctypes.c_int,
                                                            ctypes.c_void_p, ctypes.c_void_p]
    err = fn(groups, order.data_ptr() if order is not None else None, starts.data_ptr(),
             sel.data_ptr(), len(halves), build.ptrs(d.data_ptr() for d, _ in halves),
             build.ptrs(v.data_ptr() for _, v in halves),
             build.ints(_KIND[d.dtype] for d, _ in halves), cap, _KIND[storage],
             out.data_ptr(), build.stream_of(sel))
    build.check(err, "group_collect")
    launches += 1
    return out


def group_collect_merge(order: Optional[torch.Tensor], starts: torch.Tensor,
                        live: torch.Tensor, parts: torch.Tensor, cap: int) -> torch.Tensor:
    """Partial state matrices ``parts`` merged per group (runs as in
    :func:`group_collect`; ``live`` marks the partial rows to take)."""
    n = live.shape[0]
    if parts.dim() != 2 or parts.shape[0] != n or (parts.shape[1] - 1) % cap:
        raise ValueError("group_collect_merge: parts must be (n, 1 + halves * cap)")
    if not live.is_cuda:
        return group_collect_merge_plain(order, starts, live, parts, cap)
    global launches, merge_launches
    _check_runs(order, starts, n, "group_collect_merge")
    if live.dtype != torch.bool or parts.dtype not in STORAGE:
        raise ValueError("group_collect_merge: live (n,) bool; parts int32, int64 or "
                         "float64")
    build.require_cuda([starts, live, parts] + ([order] if order is not None else []),
                       "group_collect_merge")
    groups = starts.shape[0] - 1
    out = torch.empty((groups, parts.shape[1]), dtype=parts.dtype, device=live.device)
    fn = build.library().k14_group_collect_merge
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_longlong] + [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + \
        [ctypes.c_void_p] * 2
    err = fn(groups, order.data_ptr() if order is not None else None, starts.data_ptr(),
             live.data_ptr(), parts.data_ptr(), parts.shape[1], cap, _KIND[parts.dtype],
             out.data_ptr(), build.stream_of(live))
    build.check(err, "group_collect_merge")
    launches += 1
    merge_launches += 1
    return out
