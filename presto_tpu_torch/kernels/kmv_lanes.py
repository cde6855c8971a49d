"""K16 ``kmv_lanes``: the KMV set digest of each group.

A digest (``SetDigestType``) is a ``(1 + 64 + 64)`` int64 row: slot 0
``min(distinct, 64)``, then the group's 64 smallest distinct hashes in
ascending order, then each hash's count, the sentinel past the
distinct count.  :func:`sorted_entries` (K15's host half) orders the
selected entries by (group, hash); :func:`kmv_lanes` flags the runs of
equal (group, hash), scans the flags and the counts, and writes each
run whose distinct rank in its group is below 64: its hash and the sum
of its counts; it also gives each group's distinct total.  The
reference's ``_kmv_lanes`` (``presto_tpu/ops/aggregate.py:944``), which
make_set_digest (:753), merge_set_digest (:770) and the digest merge
(:1235) call; :func:`digest_entries` is its ``_digest_entries`` (:982),
which flattens digest rows into entries for a merge.  CUDA tensors
launch ``csrc/kmv_lanes.cu``; CPU tensors run :func:`kmv_lanes_plain`.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from presto_tpu_torch.kernels import build
from presto_tpu_torch.kernels.container_eval import lengths

SCAN_TILE = 2048  # csrc/scan.cuh SCAN_TILE
I64_MIN = -(1 << 63)

launches = 0
merge_launches = 0


def digest_entries(rows: torch.Tensor, g: torch.Tensor, ok: torch.Tensor, cap: int):
    """``(group, hash, count, selected)`` per lane of the digest rows
    ``rows`` (row-major: a row's lanes in order), a lane selected where
    its row is (``ok``) and it lies below the row's length."""
    lens = torch.where(ok, torch.clamp(lengths(rows), max=cap), torch.zeros_like(g))
    lane_ok = torch.arange(cap, device=rows.device)[None, :] < lens[:, None]
    # repeat_interleave, not a stride-0 view: one row's group ids stay contiguous
    return (g.repeat_interleave(cap), rows[:, 1:1 + cap].reshape(-1),
            rows[:, 1 + cap:1 + 2 * cap].reshape(-1), lane_ok.reshape(-1))


def kmv_lanes_plain(perm: torch.Tensor, egid: torch.Tensor, hashes: torch.Tensor,
                    counts: Optional[torch.Tensor], starts: torch.Tensor, cap: int):
    groups = starts.shape[0] - 1
    dev = starts.device
    live = int(starts[-1]) if groups else 0
    p = perm[:live]
    gs, hs = egid[p], hashes[p]
    cs = torch.ones_like(hs) if counts is None else counts[p]
    head = torch.ones(live, dtype=torch.bool, device=dev)
    head[1:] = (gs[1:] != gs[:-1]) | (hs[1:] != hs[:-1])
    rid = torch.cumsum(head.to(torch.int64), 0) - 1
    runs = int(head.sum())
    rsum = torch.zeros(runs, dtype=torch.int64, device=dev).index_add_(0, rid, cs)
    distinct = torch.bincount(gs[head], minlength=groups)[:groups] if live else \
        torch.zeros(groups, dtype=torch.int64, device=dev)
    first_run = torch.zeros(groups, dtype=torch.int64, device=dev)
    torch.cumsum(distinct[:-1], 0, out=first_run[1:])
    rank = rid - first_run[gs]
    ok = head & (rank < cap)
    out = torch.full((groups, 1 + 2 * cap), I64_MIN, dtype=torch.int64, device=dev)
    out[gs[ok], 1 + rank[ok]] = hs[ok]
    out[gs[ok], 1 + cap + rank[ok]] = rsum[rid[ok]]
    out[:, 0] = torch.clamp(distinct, max=cap)
    return out, distinct


def kmv_lanes(perm: torch.Tensor, egid: torch.Tensor, hashes: torch.Tensor,
              counts: Optional[torch.Tensor], starts: torch.Tensor, cap: int,
              merge: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(state (groups, 1 + 2 * cap) int64, distinct (groups,) int64)``
    of the entries ``(perm, starts)`` sorted by K15's ``sorted_entries``
    (by group ``egid``, then hash), ``counts`` None where each entry
    counts 1 (make_set_digest's rows); ``merge`` counts the launch as a
    merge of partial digests."""
    m = perm.shape[0]
    for t in (perm, egid, hashes) + (() if counts is None else (counts,)):
        if t.shape != (m,) or t.dtype != torch.int64:
            raise ValueError("kmv_lanes: perm, egid, hashes and counts are (m,) int64")
    if cap < 1 or starts.dim() != 1 or starts.dtype != torch.int64:
        raise ValueError("kmv_lanes: starts (groups + 1,) int64, cap >= 1")
    if not perm.is_cuda:
        return kmv_lanes_plain(perm, egid, hashes, counts, starts, cap)
    global launches, merge_launches
    build.require_cuda([perm, egid, hashes, starts] + ([] if counts is None else [counts]),
                       "kmv_lanes")
    groups = starts.shape[0] - 1
    live = int(starts[-1]) if groups else 0
    dev = perm.device
    heads = torch.empty(live + 1, dtype=torch.int64, device=dev)
    csum = None if counts is None else torch.empty(live + 1, dtype=torch.int64, device=dev)
    partials = torch.empty(-(-live // SCAN_TILE) + 1, dtype=torch.int64, device=dev)
    c_start = torch.empty((max(groups, 1), cap), dtype=torch.int64, device=dev)
    c_end = torch.empty_like(c_start)
    out = torch.empty((groups, 1 + 2 * cap), dtype=torch.int64, device=dev)
    distinct = torch.empty(groups, dtype=torch.int64, device=dev)
    fn = build.library().k16_kmv_lanes
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_longlong, ctypes.c_longlong] + [ctypes.c_void_p] * 5 + \
        [ctypes.c_int] + [ctypes.c_void_p] * 8
    err = fn(groups, live, perm.data_ptr(), egid.data_ptr(), hashes.data_ptr(),
             None if counts is None else counts.data_ptr(), starts.data_ptr(), cap,
             heads.data_ptr(), None if csum is None else csum.data_ptr(),
             partials.data_ptr(), c_start.data_ptr(), c_end.data_ptr(), out.data_ptr(),
             distinct.data_ptr(), build.stream_of(perm))
    build.check(err, "kmv_lanes")
    launches += 1
    merge_launches += int(merge)
    return out, distinct
