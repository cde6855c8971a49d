"""K21 ``exchange_partition``: a page's rows scattered into ``n_parts``
buckets of ``bucket_cap`` rows by their partition target.

:func:`exchange_partition` computes what the reference's
``partition_targets`` (after the packed key) and
``partition_for_exchange`` compute together
(``presto_tpu/parallel/exchange.py``): each live row's target
``_mix64(key) % n_parts`` in unsigned 64-bit arithmetic (a dead row's
target is ``n_parts``), then the stable grouping of the rows by target,
each row's slot in its target's run, the drop of the slots past
``bucket_cap``, and the copy of every column (any trailing width: limb
matrices, raw-string lanes), its valid bits and the row mask into an
``n_parts * bucket_cap`` page, bucket p at rows ``[p * bucket_cap,
(p + 1) * bucket_cap)``; ``fill`` is the largest target's count (past
``bucket_cap``, rows were dropped).  :func:`exchange_layout` is the
first pass (targets, their per-block counts, ``fill``) and
:func:`exchange_scatter` the second, so a caller can size the buckets
from the fills before it scatters; :func:`exchange_targets` is the
targets alone.  Given targets in place of a key, the same launches are
``partition_for_exchange``.  CUDA tensors launch
``csrc/exchange_partition.cu``; CPU tensors run the plain versions.
Torch has no unsigned 64-bit arithmetic on the CPU, so the plain
version mixes in wrapping int64 (the same bits) and takes the unsigned
remainder of a negative int64 as ``((x & INT64_MAX) % n + 2**63 % n)
% n``.
"""

from __future__ import annotations

import ctypes
import math
from typing import List, NamedTuple, Optional, Sequence, Tuple

import torch

from presto_tpu_torch.kernels import build
from presto_tpu_torch.kernels import keys as pk

MAX_PARTS = 256  # csrc/exchange_partition.cu K21_MAX_PARTS
MAX_COLS = 64  # columns scattered by one launch: csrc/gather.cuh GATHER_MAX_COLS

#: K21 launch sequences (one per page partitioned)
launches = 0

Column = Tuple[torch.Tensor, torch.Tensor]


def _check(row_mask: torch.Tensor, n_parts: int, what: str) -> int:
    n = row_mask.shape[0]
    if row_mask.dtype != torch.bool or row_mask.dim() != 1 or not 1 <= n < (1 << 31):
        raise ValueError(f"{what}: row_mask must be (n,) bool, 1 <= n < 2^31")
    if not 1 <= n_parts <= MAX_PARTS:
        raise ValueError(f"{what}: 1 to {MAX_PARTS} parts, not {n_parts}")
    return n


def _check_key(key: torch.Tensor, n: int, what: str) -> None:
    if key.dtype != torch.int64 or key.shape != (n,):
        raise ValueError(f"{what}: the key must be (n,) int64")


def _check_cols(cols: Sequence[Column], n: int) -> List[int]:
    out = []
    for data, valid in cols:
        if data.shape[0] != n or valid.shape != (n,) or valid.dtype != torch.bool:
            raise ValueError(f"exchange_partition: columns must be ({n},...) with (n,) bool valid")
        out.append(data.element_size() * math.prod(data.shape[1:]))
    return out


def unsigned_mod(h: torch.Tensor, n: int) -> torch.Tensor:
    """``h`` read as unsigned 64-bit, modulo ``n`` (int64 lanes)."""
    return ((h & pk.I64_MAX) % n + (h < 0).to(torch.int64) * ((1 << 63) % n)) % n


def targets_plain(key: torch.Tensor, row_mask: torch.Tensor, n_parts: int) -> torch.Tensor:
    """int32 target of each row, ``n_parts`` for a dead row; the plain
    version."""
    t = unsigned_mod(pk._mix64(key), n_parts)
    return torch.where(row_mask, t, torch.full_like(t, n_parts)).to(torch.int32)


class Layout(NamedTuple):
    """K21's first pass over a page: each row's target (int32, ``n_parts``
    for a dead row), the scanned per-block target counts the scatter
    reads (``None`` on the CPU) and ``fill``, the largest target's count
    (an int32 scalar tensor)."""

    targets: torch.Tensor
    block_counts: Optional[torch.Tensor]
    fill: torch.Tensor


def exchange_layout(key: Optional[torch.Tensor], row_mask: torch.Tensor, n_parts: int,
                    targets: Optional[torch.Tensor] = None) -> Layout:
    """The targets from ``key`` (int64, one per row), or ``targets`` as
    given, with their counts and ``fill``.  CPU tensors take the plain
    version; CUDA tensors launch K21's first pass."""
    n = _check(row_mask, n_parts, "exchange_partition")
    if (key is None) == (targets is None):
        raise ValueError("exchange_partition: pass a key or targets")
    if key is not None:
        _check_key(key, n, "exchange_partition")
    elif targets.shape != (n,):
        raise ValueError("exchange_partition: targets must be (n,)")
    if row_mask.is_cuda:
        return Layout(*_targets(key, row_mask, n_parts, targets))
    if targets is None:
        t = targets_plain(key, row_mask, n_parts)
    else:
        t = targets.to(torch.int32)
        t = torch.where((t < 0) | (t > n_parts), torch.full_like(t, n_parts), t)
    fill = torch.bincount(t.to(torch.int64), minlength=n_parts + 1)[:n_parts].max()
    return Layout(t, None, fill.to(torch.int32))


def exchange_targets(key: torch.Tensor, row_mask: torch.Tensor, n_parts: int) -> torch.Tensor:
    """The target of every row (int32; ``n_parts`` for a dead row).  CPU
    tensors take the plain version; CUDA tensors launch K21's first pass
    alone."""
    global launches
    layout = exchange_layout(key, row_mask, n_parts)
    if row_mask.is_cuda:
        launches += 1
    return layout.targets


def partition_plain(key: Optional[torch.Tensor], targets: Optional[torch.Tensor],
                    row_mask: torch.Tensor, n_parts: int, bucket_cap: int,
                    cols: Sequence[Column]) -> Tuple[List[Column], torch.Tensor, torch.Tensor]:
    """``(columns, mask, fill)`` of the bucketized page; the plain
    version of :func:`exchange_partition` (the targets from ``key``, or
    ``targets`` as given)."""
    n = _check(row_mask, n_parts, "exchange_partition")
    _check_cols(cols, n)
    if targets is None:
        targets = targets_plain(key, row_mask, n_parts)
    t = targets.to(torch.int64)
    t = torch.where((t < 0) | (t > n_parts), torch.full_like(t, n_parts), t)
    order = torch.argsort(t, stable=True)
    st = t[order]
    counts = torch.bincount(t, minlength=n_parts + 1)[:n_parts + 1]
    starts = torch.cumsum(counts, 0) - counts
    slot = torch.arange(n, device=t.device) - starts[st]
    out_cap = n_parts * bucket_cap
    dest = torch.where((st < n_parts) & (slot < bucket_cap), st * bucket_cap + slot,
                       torch.full_like(st, out_cap))

    def scatter(x: torch.Tensor) -> torch.Tensor:
        out = torch.zeros((out_cap + 1,) + tuple(x.shape[1:]), dtype=x.dtype, device=x.device)
        out[dest] = x[order]
        return out[:out_cap]

    out_cols = [(scatter(d), scatter(v)) for d, v in cols]
    fill = counts[:n_parts].max().to(torch.int32)
    return out_cols, scatter(row_mask), fill


def _targets(key: Optional[torch.Tensor], row_mask: torch.Tensor, n_parts: int,
             targets: Optional[torch.Tensor]):
    """K21's first pass on the card: (targets, scanned block counts,
    fill)."""
    n = row_mask.shape[0]
    build.require_cuda([row_mask] + ([key] if key is not None else [targets]),
                       "exchange_partition")
    lib = build.library()
    for name in ("k21_blocks", "k21_scan_partials"):
        getattr(lib, name).restype = ctypes.c_longlong
        getattr(lib, name).argtypes = [ctypes.c_longlong]
    blocks = lib.k21_blocks(n)
    m = n_parts * blocks
    dev = row_mask.device
    if targets is None:
        targets = torch.empty(n, dtype=torch.int32, device=dev)
    else:
        targets = targets.to(torch.int32).clone()
    block_counts = torch.empty(m + 1, dtype=torch.int32, device=dev)
    partials = torch.empty(lib.k21_scan_partials(m), dtype=torch.int32, device=dev)
    fill = torch.empty((), dtype=torch.int32, device=dev)
    fn = lib.k21_exchange_targets
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int] + \
        [ctypes.c_void_p] * 5
    err = fn(n, key.data_ptr() if key is not None else None, row_mask.data_ptr(), n_parts,
             targets.data_ptr(), block_counts.data_ptr(), partials.data_ptr(), fill.data_ptr(),
             build.stream_of(row_mask))
    build.check(err, "exchange_partition")
    return targets, block_counts, fill


def exchange_scatter(layout: Layout, row_mask: torch.Tensor, n_parts: int, bucket_cap: int,
                     cols: Sequence[Column]) -> Tuple[List[Column], torch.Tensor, torch.Tensor]:
    """The bucketized page of ``cols`` by ``layout`` (an
    :func:`exchange_layout` of the same rows and ``n_parts``):
    ``(columns, row mask, fill)``, each column ``(n_parts * bucket_cap,
    ...)``.  CPU tensors take the plain version; CUDA tensors launch
    K21's scatter once per run of ``MAX_COLS`` columns."""
    n = _check(row_mask, n_parts, "exchange_partition")
    if bucket_cap < 0:
        raise ValueError("exchange_partition: bucket_cap must be >= 0")
    widths = _check_cols(cols, n)
    if not row_mask.is_cuda:
        return partition_plain(None, layout.targets, row_mask, n_parts, bucket_cap, cols)
    global launches
    build.require_cuda([layout.targets, layout.block_counts] + [t for c in cols for t in c],
                       "exchange_partition")
    out_cap = n_parts * bucket_cap
    dev = row_mask.device
    out_cols = [(torch.zeros((out_cap,) + tuple(d.shape[1:]), dtype=d.dtype, device=dev),
                 torch.zeros(out_cap, dtype=torch.bool, device=dev)) for d, _ in cols]
    out_mask = torch.zeros(out_cap, dtype=torch.bool, device=dev)
    fn = build.library().k21_exchange_scatter
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_longlong, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                   ctypes.c_longlong, ctypes.c_int] + [ctypes.c_void_p] * 8
    for c0 in range(0, max(len(cols), 1), MAX_COLS):
        src, dst = cols[c0:c0 + MAX_COLS], out_cols[c0:c0 + MAX_COLS]
        err = fn(n, layout.targets.data_ptr(), n_parts, layout.block_counts.data_ptr(),
                 bucket_cap, len(src),
                 build.ptrs(d.data_ptr() for d, _ in src),
                 build.ptrs(v.data_ptr() for _, v in src),
                 build.ptrs(d.data_ptr() for d, _ in dst),
                 build.ptrs(v.data_ptr() for _, v in dst),
                 build.ints(widths[c0:c0 + MAX_COLS]), row_mask.data_ptr(),
                 out_mask.data_ptr() if c0 == 0 else None, build.stream_of(row_mask))
        build.check(err, "exchange_partition")
    launches += 1
    return out_cols, out_mask, layout.fill


def exchange_partition(key: Optional[torch.Tensor], row_mask: torch.Tensor, n_parts: int,
                       bucket_cap: int, cols: Sequence[Column],
                       targets: Optional[torch.Tensor] = None,
                       ) -> Tuple[List[Column], torch.Tensor, torch.Tensor]:
    """The bucketized page of ``cols``: :func:`exchange_scatter` of the
    :func:`exchange_layout` of ``key`` or ``targets``; on the card one
    K21 launch sequence."""
    _check_cols(cols, row_mask.shape[0])
    return exchange_scatter(exchange_layout(key, row_mask, n_parts, targets), row_mask, n_parts,
                            bucket_cap, cols)
