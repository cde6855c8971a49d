"""K15 ``group_topn``: the per-group lanes of the top-n aggregates.

max(x, n), min(x, n), max_by(x, y, n) and min_by(x, y, n) keep, per
group, a ``(1 + n [+ n])`` row: slot 0 ``min(size, n)``, then the values
of the group's n extreme entries ordered by key (descending for the max
forms, ascending for the min forms), then (the ``*_by_n`` forms) their
keys, the sentinel past the group's size.  :func:`sorted_entries` is
the host's half, two stable ``torch.sort`` passes (the reference's
``jnp.lexsort`` by (group, key) is XLA's sort): the permutation of the
selected entries by (group, key), and each group's first position.
:func:`group_topn` writes the lanes from that permutation: lane ``j``
of a group of ``size`` entries starting at ``start`` is the entry at
``start + size - 1 - j`` (max forms) or ``start + j`` (min forms).  The
reference's ``_topn_halves`` (``presto_tpu/ops/aggregate.py:1020``),
which both the partial states (:784) and their merge (:1254) call.
CUDA tensors launch ``csrc/group_topn.cu``; CPU tensors run
:func:`group_topn_plain`.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from presto_tpu_torch.kernels import build
from presto_tpu_torch.kernels.container_eval import sentinel
from presto_tpu_torch.kernels.topn import double_sort_key

_KIND = {torch.int32: 1, torch.int64: 2, torch.float64: 3}

launches = 0
merge_launches = 0


def sort_key(key: torch.Tensor) -> torch.Tensor:
    """An integer whose ascending order is the reference's sort order of
    ``key``: a double's (``double_sort_key``: -0.0 equal to 0.0, NaN
    after +inf), a boolean as 0/1, an integer itself."""
    if key.is_floating_point():
        return double_sort_key(key, True)
    return key.to(torch.int64) if key.dtype == torch.bool else key


def sorted_entries(g: torch.Tensor, key: torch.Tensor, ok: torch.Tensor,
                   groups: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(perm, starts)``: the entries ``ok`` selects ordered by (group
    ``g``, ``key``), ties in entry order (a stable sort by key, then a
    stable sort by group), the others after them; and the first
    position of each group's run (``starts[groups]``: the selected
    entries' count)."""
    egid = torch.where(ok, g, torch.full_like(g, groups))
    perm = torch.sort(sort_key(key), stable=True)[1]
    perm = perm[torch.sort(egid[perm], stable=True)[1]]
    sizes = torch.bincount(egid, minlength=groups + 1)[:groups]
    starts = torch.zeros(groups + 1, dtype=torch.int64, device=g.device)
    torch.cumsum(sizes, 0, out=starts[1:])
    return perm, starts


def group_topn_plain(perm: torch.Tensor, starts: torch.Tensor, vals: torch.Tensor,
                     keys: Optional[torch.Tensor], cap: int, descending: bool) -> torch.Tensor:
    groups = starts.shape[0] - 1
    dev = starts.device
    size = (starts[1:] - starts[:-1])[:, None]
    lane = torch.arange(cap, device=dev)[None, :]
    ok = lane < size
    rank = size - 1 - lane if descending else lane.expand(groups, cap)
    m = perm.shape[0]
    pos = torch.clamp(starts[:-1, None] + rank, 0, max(m - 1, 0))
    rows = perm[pos] if m else torch.zeros_like(pos)
    out = [torch.clamp(size, max=cap).to(vals.dtype)]
    for src in (vals,) if keys is None else (vals, keys):
        got = src[rows] if m else torch.zeros(rows.shape, dtype=src.dtype, device=dev)
        out.append(torch.where(ok, got, torch.full_like(got, sentinel(src.dtype))))
    return torch.cat(out, 1)


def group_topn(perm: torch.Tensor, starts: torch.Tensor, vals: torch.Tensor,
               keys: Optional[torch.Tensor], cap: int, descending: bool,
               merge: bool = False) -> torch.Tensor:
    """The ``(groups, 1 + cap)`` state of max_n / min_n (``keys`` None)
    or ``(groups, 1 + 2 * cap)`` of max_by_n / min_by_n over the sorted
    entries ``(perm, starts)`` of :func:`sorted_entries` (``perm``
    indexes ``vals`` and ``keys``, which are in the state's storage
    dtype).  ``merge`` counts the launch as a merge of partial lanes."""
    if cap < 1 or perm.dim() != 1 or vals.dim() != 1 \
            or (keys is not None and (keys.shape != vals.shape or keys.dtype != vals.dtype)):
        raise ValueError("group_topn: perm (m,), vals and keys (n,) of one dtype, cap >= 1")
    if not vals.is_cuda:
        return group_topn_plain(perm, starts, vals, keys, cap, descending)
    global launches, merge_launches
    if perm.dtype != torch.int64 or starts.dtype != torch.int64 or starts.dim() != 1 \
            or vals.dtype not in _KIND:
        raise ValueError("group_topn: perm and starts int64; storage int32, int64 or float64")
    build.require_cuda([perm, starts, vals] + ([keys] if keys is not None else []),
                       "group_topn")
    groups = starts.shape[0] - 1
    halves = 1 if keys is None else 2
    out = torch.empty((groups, 1 + halves * cap), dtype=vals.dtype, device=vals.device)
    fn = build.library().k15_group_topn
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_longlong] + [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + \
        [ctypes.c_void_p] * 2
    err = fn(groups, perm.data_ptr(), starts.data_ptr(), vals.data_ptr(),
             keys.data_ptr() if keys is not None else None, cap, halves, int(descending),
             _KIND[vals.dtype], out.data_ptr(), build.stream_of(vals))
    build.check(err, "group_topn")
    launches += 1
    merge_launches += int(merge)
    return out
