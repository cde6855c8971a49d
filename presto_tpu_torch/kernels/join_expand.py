"""K8 ``join_expand``: the expanding (many-to-many) join probe.

:func:`join_expand` packs each probe row's key (exact or hashed; dead
rows and, unless ``null_safe``, NULL keys never match), finds its
match range in the build (``starts``, or two binary searches over the
sorted keys), counts its output rows (a live unmatched row of a left
join counts one), reads the total once, and writes one output row per
(probe row, matching build row): the probe row's columns and the build
row's, the build's NULL past the match range.  Rows come in the
reference's order, probe row first, then the build's sorted position.
For a FULL join it also stores 1 into ``matched`` (a build-sized bool
mask, accumulated across probe pages) for every matched build row.
The reference's ``probe_expand`` and ``_lookup_range``
(``presto_tpu/ops/join.py``), sized from the match count instead of a
capacity retry.  CUDA tensors launch ``csrc/join_expand.cu``; CPU
tensors run :func:`join_expand_plain`.
"""

from __future__ import annotations

import ctypes
from typing import List, Optional, Sequence, Tuple

import torch

from presto_tpu_torch.kernels import build
from presto_tpu_torch.kernels import keys as pk

MAX_COLS = 64  # probe and build columns together: csrc/gather.cuh GATHER_MAX_COLS
SCAN_TILE = 2048  # csrc/scan.cuh SCAN_TILE
MAX_OUTPUT_ROWS = (1 << 31) - 1  # int32 offsets

launches = 0

Column = Tuple[torch.Tensor, torch.Tensor]


def _lookup_range_plain(keys, row_mask, sorted_keys, starts, null_safe):
    n = row_mask.shape[0]
    key, ok = pk.pack_plain(keys, n, row_mask.device)
    key_ok = row_mask if null_safe else row_mask & ok
    key = torch.where(key_ok, key, torch.full_like(key, pk.I64_MAX - 1))
    if starts is not None:
        d = starts.shape[0] - 1
        kk = torch.clamp(key, 0, d - 1)
        in_dom = (key >= 0) & (key < d)
        zero = torch.zeros_like(key)
        lo = torch.where(in_dom, starts[kk].to(torch.int64), zero)
        hi = torch.where(in_dom, starts[kk + 1].to(torch.int64), zero)
    else:
        lo = torch.searchsorted(sorted_keys, key)
        hi = torch.searchsorted(sorted_keys, key, right=True)
    return lo, hi


def _empty_like_rows(cols: Sequence[Column], rows: int, zero: bool) -> List[Column]:
    make = torch.zeros if zero else torch.empty
    return [(make((rows,) + tuple(d.shape[1:]), dtype=d.dtype, device=d.device),
             make(rows, dtype=torch.bool, device=d.device)) for d, _ in cols]


def join_expand_plain(keys: Sequence[pk.Key], row_mask: torch.Tensor,
                      sorted_keys: torch.Tensor, perm: torch.Tensor,
                      starts: Optional[torch.Tensor], probe_cols: Sequence[Column],
                      build_cols: Sequence[Column], left: bool = False,
                      null_safe: bool = False, matched: Optional[torch.Tensor] = None):
    """``(probe columns, build columns, total)``; the plain version.
    The columns hold ``max(total, 1)`` rows (all zero when total is
    0)."""
    n = row_mask.shape[0]
    dev = row_mask.device
    lo, hi = _lookup_range_plain(keys, row_mask, sorted_keys, starts, null_safe)
    m = torch.where(row_mask, hi - lo, torch.zeros_like(lo))
    counts = torch.where(row_mask & (m == 0), torch.ones_like(m), m) if left else m
    offsets = torch.cumsum(counts, 0) - counts
    total = int(counts.sum())
    if total == 0:
        return (_empty_like_rows(probe_cols, 1, True), _empty_like_rows(build_cols, 1, True),
                0)
    p = torch.repeat_interleave(torch.arange(n, device=dev), counts)
    rank = torch.arange(total, device=dev) - offsets[p]
    hit = rank < m[p]
    pos = torch.clamp(lo[p] + rank, 0, sorted_keys.shape[0] - 1)
    b_row = torch.where(hit, perm[pos].to(torch.int64), torch.zeros_like(pos))
    probe_out = [(d[p], v[p]) for d, v in probe_cols]
    build_out = []
    for d, v in build_cols:
        keep = hit.view((total,) + (1,) * (d.dim() - 1))
        build_out.append((torch.where(keep, d[b_row], torch.zeros_like(d[b_row])),
                          v[b_row] & hit))
    if matched is not None:
        matched[b_row[hit]] = True
    return probe_out, build_out, total


def _widths(cols: Sequence[Column], rows: int, what: str) -> List[int]:
    out = []
    for data, valid in cols:
        width = data.element_size() * (data.shape[1] if data.dim() == 2 else 1)
        if data.shape[0] != rows or valid.shape != (rows,) or valid.dtype != torch.bool \
                or width not in (1, 4, 8, 16) or data.dim() > 2:
            raise ValueError(f"join_expand: {what} columns must be ({rows},) or "
                             f"({rows}, 2) limbs")
        out.append(width)
    return out


def join_expand(keys: Sequence[pk.Key], row_mask: torch.Tensor, sorted_keys: torch.Tensor,
                perm: torch.Tensor, starts: Optional[torch.Tensor],
                probe_cols: Sequence[Column], build_cols: Sequence[Column],
                left: bool = False, null_safe: bool = False,
                matched: Optional[torch.Tensor] = None):
    """Expand ``row_mask``'s probe rows against a build (``sorted_keys``,
    ``perm``, optional ``starts``): ``(probe columns, build columns,
    total)``, each column of ``max(total, 1)`` rows.  CPU tensors take
    the plain version; CUDA tensors launch the kernels."""
    if not row_mask.is_cuda:
        return join_expand_plain(keys, row_mask, sorted_keys, perm, starts, probe_cols,
                                 build_cols, left, null_safe, matched)
    global launches
    n = row_mask.shape[0]
    cap = sorted_keys.shape[0]
    if row_mask.dtype != torch.bool or row_mask.dim() != 1 or n >= (1 << 31) - 1:
        raise ValueError("join_expand: row_mask must be (n,) bool, n < 2^31")
    if sorted_keys.dtype != torch.int64 or perm.dtype != torch.int32 \
            or perm.shape != (cap,) or cap < 1:
        raise ValueError("join_expand: build keys int64 (cap,), perm int32 (cap,)")
    if starts is not None and (starts.dtype != torch.int32 or starts.dim() != 1):
        raise ValueError("join_expand: starts must be int32")
    if matched is not None and (matched.dtype != torch.bool or matched.shape != (cap,)):
        raise ValueError("join_expand: matched must be (build capacity,) bool")
    if len(probe_cols) + len(build_cols) > MAX_COLS:
        raise ValueError(f"join_expand: more than {MAX_COLS} probe and build columns")
    widths = _widths(probe_cols, n, "probe") + _widths(build_cols, cap, "build")
    tensors = [row_mask, sorted_keys, perm] + pk.check(keys, n, "join_expand") + \
        [t for c in list(probe_cols) + list(build_cols) for t in c]
    tensors += [t for t in (starts, matched) if t is not None]
    build.require_cuda(tensors, "join_expand")
    dev = row_mask.device
    stream = build.stream_of(row_mask)
    lib = build.library()
    lo = torch.empty(n, dtype=torch.int32, device=dev)
    m = torch.empty(n, dtype=torch.int32, device=dev)
    offsets = torch.empty(n + 1, dtype=torch.int32, device=dev)
    partials = torch.empty(-(-n // SCAN_TILE) + 1, dtype=torch.int32, device=dev)
    total_t = torch.empty(1, dtype=torch.int64, device=dev)
    fn = lib.k8_join_count
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_longlong, ctypes.c_void_p] + pk.C_ARGTYPES + [
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,
        ctypes.c_longlong] + [ctypes.c_void_p] * 6
    err = fn(n, row_mask.data_ptr(), *pk.c_args(keys), int(null_safe), int(left),
             starts.data_ptr() if starts is not None else None,
             starts.shape[0] - 1 if starts is not None else 0, sorted_keys.data_ptr(), cap,
             lo.data_ptr(), m.data_ptr(), offsets.data_ptr(), partials.data_ptr(),
             total_t.data_ptr(), stream)
    build.check(err, "join_expand")
    total = int(total_t[0])  # the one synchronisation: sizes the output
    if total > MAX_OUTPUT_ROWS:
        raise ValueError(f"join_expand: {total} output rows past int32 offsets")
    rows = max(total, 1)
    probe_out = _empty_like_rows(probe_cols, rows, total == 0)
    build_out = _empty_like_rows(build_cols, rows, total == 0)
    fn = lib.k8_join_expand
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_longlong] + [ctypes.c_void_p] * 3 + [
        ctypes.c_longlong, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_int] + \
        [ctypes.c_void_p] * 7
    srcs = list(probe_cols) + list(build_cols)
    dsts = probe_out + build_out
    err = fn(n, offsets.data_ptr(), lo.data_ptr(), m.data_ptr(), total, perm.data_ptr(), cap,
             len(srcs), len(probe_cols), build.ptrs(d.data_ptr() for d, _ in srcs),
             build.ptrs(v.data_ptr() for _, v in srcs), build.ptrs(d.data_ptr() for d, _ in dsts),
             build.ptrs(v.data_ptr() for _, v in dsts), build.ints(widths),
             matched.data_ptr() if matched is not None else None, stream)
    build.check(err, "join_expand")
    launches += 1
    return probe_out, build_out, total
