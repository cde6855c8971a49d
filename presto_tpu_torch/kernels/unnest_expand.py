"""K13 ``unnest_expand``: container rows expanded into one row per element.

:func:`unnest_expand` counts each live row's output rows (the longest
of its containers, a NULL container counting 0, at most the widest
slot count), takes an exclusive scan, reads the total once, and writes
one output row per (row, slot), in input order: the outer columns
replicated, each container's element (a map's key and value) with
NULL past that container's length, and the 1-based ordinality.  The
reference's ``unnest_expand`` (``presto_tpu/ops/container.py:472``,
executor ``presto_tpu/exec/local.py:1275``) computes the same rows as a
static ``capacity * slots`` page with a liveness mask; here the output
holds exactly the live rows, sized from the count as K8 ``join_expand``
sizes its own.  The lambda functions flatten their containers through
it too (the offsets place element ``j`` of row ``r`` at ``offsets[r] +
j``).  CUDA tensors launch ``csrc/unnest_expand.cu``; CPU tensors run
:func:`unnest_expand_plain`.
"""

from __future__ import annotations

import ctypes
from typing import Sequence, Tuple

import torch

from presto_tpu_torch.kernels import build
from presto_tpu_torch.kernels.container_eval import cast_values, is_null, lengths

MAX_ARGS = 8  # csrc/unnest_expand.cu K13_MAX_ARGS
MAX_HALVES = 16
MAX_COLS = 64
SCAN_TILE = 2048  # csrc/scan.cuh SCAN_TILE
_KIND = {torch.bool: 0, torch.int32: 1, torch.int64: 2, torch.float64: 3}

launches = 0

Column = Tuple[torch.Tensor, torch.Tensor]
# a container argument: (matrix, row validity, slots per half, [(first
# slot, output dtype) per half]): an array has one half at slot 1, a
# map two, at 1 and 1 + slots
Arg = Tuple[torch.Tensor, torch.Tensor, int, Sequence[Tuple[int, torch.dtype]]]


def _element(x: torch.Tensor, ok: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    out = (x != 0) if dtype == torch.bool else cast_values(x, dtype)
    return torch.where(ok, out, torch.zeros_like(out))


def unnest_expand_plain(row_mask: torch.Tensor, args: Sequence[Arg],
                        outer: Sequence[Column], ordinality: bool = False):
    """``(outer columns, element columns, ordinality or None, total,
    offsets)``; the plain version.  Columns hold ``max(total, 1)`` rows
    (all zero when total is 0)."""
    n = row_mask.shape[0]
    dev = row_mask.device
    widest = max(m for _, _, m, _ in args)
    longest = torch.zeros(n, dtype=torch.int64, device=dev)
    for d, v, _, _ in args:
        longest = torch.maximum(longest, torch.where(v, lengths(d), torch.zeros_like(longest)))
    counts = torch.where(row_mask, torch.clamp(longest, max=widest), torch.zeros_like(longest))
    offsets = torch.cat([torch.zeros(1, dtype=torch.int64, device=dev), torch.cumsum(counts, 0)])
    total = int(offsets[-1])
    rows = max(total, 1)
    r = torch.repeat_interleave(torch.arange(n, device=dev), counts)
    s = torch.arange(total, device=dev) - offsets[r]
    pad = rows - total

    def padded(t):
        if not pad:
            return t
        return torch.cat([t, torch.zeros((pad,) + tuple(t.shape[1:]), dtype=t.dtype,
                                         device=dev)])

    outer_out = [(padded(d[r]), padded(v[r])) for d, v in outer]
    elems = []
    for d, v, m, halves in args:
        L = lengths(d)[r]
        for first, dtype in halves:
            w = d.shape[1]
            x = d.reshape(-1)[r * w + torch.clamp(first + s, max=w - 1)]
            ok = v[r] & (s < L) & (s < m) & ~is_null(x)
            elems.append((padded(_element(x, ok, dtype)), padded(ok)))
    ordn = padded(s + 1) if ordinality else None
    return outer_out, elems, ordn, total, offsets


def unnest_expand(row_mask: torch.Tensor, args: Sequence[Arg], outer: Sequence[Column],
                  ordinality: bool = False):
    """Expand the live rows of ``row_mask``: see :func:`unnest_expand_plain`.
    CPU tensors take the plain version; CUDA tensors launch the kernels."""
    if not args:
        raise ValueError("unnest_expand: no container")
    if not row_mask.is_cuda:
        return unnest_expand_plain(row_mask, args, outer, ordinality)
    global launches
    n = row_mask.shape[0]
    if row_mask.dtype != torch.bool or row_mask.dim() != 1:
        raise ValueError("unnest_expand: row_mask must be (n,) bool")
    halves = [(i, first, dtype) for i, (_, _, _, hs) in enumerate(args) for first, dtype in hs]
    if len(args) > MAX_ARGS or len(halves) > MAX_HALVES or len(outer) > MAX_COLS:
        raise ValueError("unnest_expand: too many containers or columns")
    for d, v, m, _ in args:
        if d.dim() != 2 or d.shape[0] != n or d.dtype not in (torch.int32, torch.int64,
                                                               torch.float64) \
                or v.shape != (n,) or v.dtype != torch.bool:
            raise ValueError("unnest_expand: containers are (n, slots) int32, int64 or "
                             "float64 matrices with (n,) bool validity")
    if any(dt not in _KIND for _, _, dt in halves):
        raise ValueError("unnest_expand: elements are bool, int32, int64 or float64")
    for d, v in outer:
        if d.shape[0] != n or v.shape != (n,) or v.dtype != torch.bool:
            raise ValueError("unnest_expand: outer columns must have n rows")
    tensors = [row_mask] + [t for d, v, _, _ in args for t in (d, v)] + \
        [t for c in outer for t in c]
    build.require_cuda(tensors, "unnest_expand")
    dev = row_mask.device
    stream = build.stream_of(row_mask)
    lib = build.library()
    offsets = torch.empty(n + 1, dtype=torch.int64, device=dev)
    partials = torch.empty(-(-n // SCAN_TILE) + 1, dtype=torch.int64, device=dev)
    fn = lib.k13_unnest_count
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_longlong, ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 5 + \
        [ctypes.c_void_p] * 3
    err = fn(n, row_mask.data_ptr(), len(args),
             build.ptrs(d.data_ptr() for d, _, _, _ in args),
             build.ptrs(v.data_ptr() for _, v, _, _ in args),
             build.ints(_KIND[d.dtype] for d, _, _, _ in args),
             build.ints(d.shape[1] for d, _, _, _ in args),
             build.ints(m for _, _, m, _ in args),
             offsets.data_ptr(), partials.data_ptr(), stream)
    build.check(err, "unnest_expand")
    total = int(offsets[n])  # the one synchronisation: sizes the output
    rows = max(total, 1)
    make = torch.zeros if total == 0 else torch.empty
    outer_out = [(make((rows,) + tuple(d.shape[1:]), dtype=d.dtype, device=dev),
                  make(rows, dtype=torch.bool, device=dev)) for d, _ in outer]
    elems = [(make(rows, dtype=dt, device=dev), make(rows, dtype=torch.bool, device=dev))
             for _, _, dt in halves]
    ordn = make(rows, dtype=torch.int64, device=dev) if ordinality else None
    if total:
        fn = lib.k13_unnest_expand
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_longlong, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int] + \
            [ctypes.c_void_p] * 5 + [ctypes.c_int] + [ctypes.c_void_p] * 5 + \
            [ctypes.c_int] + [ctypes.c_void_p] * 5 + [ctypes.c_void_p] * 2
        err = fn(n, offsets.data_ptr(), total, len(args),
                 build.ptrs(d.data_ptr() for d, _, _, _ in args),
                 build.ptrs(v.data_ptr() for _, v, _, _ in args),
                 build.ints(_KIND[d.dtype] for d, _, _, _ in args),
                 build.ints(d.shape[1] for d, _, _, _ in args),
                 build.ints(m for _, _, m, _ in args),
                 len(halves), build.ints(i for i, _, _ in halves),
                 build.ints(first for _, first, _ in halves),
                 build.ints(_KIND[dt] for _, _, dt in halves),
                 build.ptrs(d.data_ptr() for d, _ in elems),
                 build.ptrs(v.data_ptr() for _, v in elems),
                 len(outer), build.ptrs(d.data_ptr() for d, _ in outer),
                 build.ptrs(v.data_ptr() for _, v in outer),
                 build.ptrs(d.data_ptr() for d, _ in outer_out),
                 build.ptrs(v.data_ptr() for _, v in outer_out),
                 build.ints(d[:1].numel() * d.element_size() for d, _ in outer),
                 ordn.data_ptr() if ordn is not None else None, stream)
        build.check(err, "unnest_expand")
    launches += 1
    return outer_out, elems, ordn, total, offsets
