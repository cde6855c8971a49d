"""K4 ``join_build``: the build side of a join.

:func:`join_build_unique` is the reference's sort-free unique-direct
branch (``presto_tpu/ops/join.py`` ``build_join``): live keys counted
into a domain-sized table, ranks from a prefix scan of presence, keys
and row ids scattered to their ranks, and ``unique_ok`` False when a
slot holds two live rows.  :func:`join_build_sorted` is the sorted
branch: ``torch.sort`` of the sentinel-masked keys (as the reference
leaves the sort to XLA) and, with a domain, the CSR ``starts`` table
written by a kernel.  Both branches also return the build's flags
(a live row has a NULL key; any row is live), which the null-aware
probes read.  Hashed keys (K9) take the sorted branch without a
``starts`` table.  :func:`null_flags` computes those flags alone, for
the partitioned join's global flags (the reference's
``build_null_flags``).  CUDA tensors launch ``csrc/join_build.cu`` (and
the key pack of ``csrc/keys.cu``); CPU tensors run the plain versions.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Sequence

import torch

from presto_tpu_torch.kernels import build
from presto_tpu_torch.kernels import keys as pk

SCAN_TILE = 2048  # csrc/scan.cuh SCAN_TILE

launches = 0
#: launches of the ``null_flags`` entry (``build_null_flags``)
null_flags_launches = 0


def join_build_unique_plain(keys: Sequence[pk.Key], row_mask: torch.Tensor, prod: int,
                            null_safe: bool = False):
    """``(sorted_keys, perm, starts, unique_ok, flags)`` of the
    unique-direct branch; the plain version."""
    cap = row_mask.shape[0]
    dev = row_mask.device
    key, flags = pk.masked_plain(keys, row_mask, not null_safe)
    live = key != pk.I64_MAX
    key_c = torch.clamp(key, 0, prod - 1)
    slot = torch.where(live, key_c, torch.full_like(key_c, prod))
    counts = torch.zeros(prod + 1, dtype=torch.int32, device=dev)
    counts.index_add_(0, slot, live.to(torch.int32))
    present = torch.clamp(counts[:prod], max=1)
    starts = torch.cat([torch.zeros(1, dtype=torch.int64, device=dev),
                        torch.cumsum(present, 0)]).to(torch.int32)
    rank = starts[key_c].to(torch.int64)
    tgt = torch.where(live, rank, torch.full_like(rank, cap))
    sorted_keys = torch.full((cap + 1,), pk.I64_MAX, dtype=torch.int64, device=dev)
    sorted_keys[tgt] = key
    perm = torch.zeros(cap + 1, dtype=torch.int32, device=dev)
    perm[tgt] = torch.arange(cap, dtype=torch.int32, device=dev)
    unique_ok = ~torch.any(counts[:prod] > 1)
    return sorted_keys[:cap], perm[:cap], starts, unique_ok, flags


def join_build_sorted_plain(keys: Sequence[pk.Key], row_mask: torch.Tensor,
                            domain: Optional[int], null_safe: bool = False):
    """``(sorted_keys, perm, starts or None, flags)`` of the sorted
    branch; the plain version."""
    key, flags = pk.masked_plain(keys, row_mask, not null_safe)
    sorted_keys, order = torch.sort(key, stable=True)
    starts = None
    if domain is not None:
        q = torch.arange(domain + 1, dtype=torch.int64, device=row_mask.device)
        starts = torch.searchsorted(sorted_keys, q).to(torch.int32)
    return sorted_keys, order.to(torch.int32), starts, flags


def join_build_unique(keys: Sequence[pk.Key], row_mask: torch.Tensor, prod: int,
                      null_safe: bool = False):
    """The unique-direct build over ``prod`` key slots: ``(sorted_keys,
    perm, starts, unique_ok, flags)``, ``unique_ok`` a device bool
    scalar, ``flags`` the build's int32 (has a NULL key, nonempty).
    ``null_safe`` keeps rows with NULL keys (code 0).  CPU tensors take
    the plain version; CUDA tensors launch the kernel."""
    if not row_mask.is_cuda:
        return join_build_unique_plain(keys, row_mask, prod, null_safe)
    global launches
    n = _check(keys, row_mask, prod)
    dev = row_mask.device
    flags = torch.empty(2, dtype=torch.int32, device=dev)
    masked = pk.pack(keys, row_mask, not null_safe, "join_build", flags)
    counts = torch.empty(prod, dtype=torch.int32, device=dev)
    starts = torch.empty(prod + 1, dtype=torch.int32, device=dev)
    partials = torch.empty(-(-prod // SCAN_TILE) + 1, dtype=torch.int32, device=dev)
    sorted_keys = torch.empty(n, dtype=torch.int64, device=dev)
    perm = torch.empty(n, dtype=torch.int32, device=dev)
    collision = torch.empty(1, dtype=torch.int32, device=dev)
    fn = build.library().k4_join_build_unique
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_longlong, ctypes.c_void_p, ctypes.c_longlong] + \
        [ctypes.c_void_p] * 7
    err = fn(n, masked.data_ptr(), prod, counts.data_ptr(), starts.data_ptr(),
             partials.data_ptr(), sorted_keys.data_ptr(), perm.data_ptr(),
             collision.data_ptr(), build.stream_of(row_mask))
    build.check(err, "join_build")
    launches += 1
    return sorted_keys, perm, starts, collision[0] == 0, flags


def join_build_sorted(keys: Sequence[pk.Key], row_mask: torch.Tensor,
                      domain: Optional[int], null_safe: bool = False):
    """The sorted build: ``(sorted_keys, perm, starts or None, flags)``,
    with the CSR ``starts`` table over ``domain`` slots when one is
    given (never for hashed keys).  CPU tensors take the plain version;
    CUDA tensors launch the kernels around ``torch.sort``."""
    if not row_mask.is_cuda:
        return join_build_sorted_plain(keys, row_mask, domain, null_safe)
    global launches
    n = _check(keys, row_mask, domain or 1)
    flags = torch.empty(2, dtype=torch.int32, device=row_mask.device)
    sorted_keys, order = torch.sort(pk.pack(keys, row_mask, not null_safe, "join_build",
                                            flags), stable=True)
    starts = None
    if domain is not None:
        starts = torch.empty(domain + 1, dtype=torch.int32, device=row_mask.device)
        fn = build.library().k4_join_starts
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong,
                       ctypes.c_void_p, ctypes.c_void_p]
        err = fn(sorted_keys.data_ptr(), n, domain, starts.data_ptr(),
                 build.stream_of(row_mask))
        build.check(err, "join_build")
    launches += 1
    return sorted_keys, order.to(torch.int32), starts, flags


def null_flags_plain(valids: Sequence[torch.Tensor], row_mask: torch.Tensor) -> torch.Tensor:
    """int32 (has a NULL key, nonempty) of a page; the plain version."""
    all_valid = valids[0]
    for v in valids[1:]:
        all_valid = all_valid & v
    return torch.stack([torch.any(row_mask & ~all_valid),
                        torch.any(row_mask)]).to(torch.int32)


def null_flags(valids: Sequence[torch.Tensor], row_mask: torch.Tensor) -> torch.Tensor:
    """The build-side flags of three-valued IN / NOT IN without building
    the index: int32 (2,) on the page's device, [a live row has a NULL
    key, a row is live], from the key columns' valids.  CPU tensors take
    the plain version; CUDA tensors launch ``k4_null_flags``."""
    if not valids or len(valids) > pk.MAX_KEYS:
        raise ValueError(f"null_flags: 1 to {pk.MAX_KEYS} key columns")
    n = row_mask.shape[0]
    if row_mask.dtype != torch.bool or row_mask.dim() != 1 or any(
            v.dtype != torch.bool or v.shape != (n,) for v in valids):
        raise ValueError("null_flags: row mask and valids must be (n,) bool")
    if not row_mask.is_cuda:
        return null_flags_plain(valids, row_mask)
    global null_flags_launches
    build.require_cuda([row_mask, *valids], "null_flags")
    flags = torch.empty(2, dtype=torch.int32, device=row_mask.device)
    fn = build.library().k4_null_flags
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_longlong, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_void_p]
    err = fn(n, row_mask.data_ptr(), len(valids), build.ptrs(v.data_ptr() for v in valids),
             flags.data_ptr(), build.stream_of(row_mask))
    build.check(err, "null_flags")
    null_flags_launches += 1
    return flags


def _check(keys, row_mask, prod) -> int:
    n = row_mask.shape[0]
    if row_mask.dtype != torch.bool or row_mask.dim() != 1 or n < 1:
        raise ValueError("join_build: row_mask must be (n,) bool, n >= 1")
    if not 1 <= prod < (1 << 31) - 1 or n >= (1 << 31):
        raise ValueError(f"join_build: domain {prod} or {n} rows past int32 positions")
    build.require_cuda([row_mask] + pk.check(keys, n, "join_build"), "join_build")
    return n
