"""Order-preserving merge of pre-sorted pages.

Counterpart of ``presto_tpu/ops/merge.py``: the consumer side of a
distributed ORDER BY (MergeOperator.java:45's role).  Each row gets one
int64 total-order key (floats through the IEEE-754 order-isomorphic bit
map; several keys pack their lanes by the ranges they span across
every page); two sorted runs then merge on K22 (``merge_sorted``): a
row's position is its own rank plus its rank in the other run.  k runs
fold pairwise, ties toward the earlier run.  Specs that cannot form
one exact key (a raw varchar or a long decimal key, lanes whose ranges
multiply past 2^62) fall back to concatenate and sort, the reference's
own path.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch

from presto_tpu_torch.expr.compile import ExprCompiler
from presto_tpu_torch.expr.ir import Expr
from presto_tpu_torch.kernels import merge_sorted as k22
from presto_tpu_torch.page import Block, Page

_I64_MAX = (1 << 63) - 1
_I64_MIN = -(1 << 63)


def _float_order_bits(x: torch.Tensor) -> torch.Tensor:
    """IEEE-754 total-order map: float64 -> int64 with the same <.  The
    reference's bits: -0.0 maps below 0.0 and a positive NaN above
    +inf (the port's ``double_sort_key`` ties the zeros)."""
    i = x.to(torch.float64).view(torch.int64)
    return torch.where(i < 0, -1 ^ (i & _I64_MAX), i)


class _NoScalarKey(Exception):
    pass


def _raw_lane(page: Page, e: Expr, asc: bool):
    """Order-isomorphic int64 lane + validity, NULL/dead garbage NOT yet
    masked."""
    from presto_tpu_torch.ops.sort import _dict_rank

    d, v = ExprCompiler.for_page(page).compile(e)(page)
    if d.dim() > 1:
        raise _NoScalarKey()
    d = _dict_rank(page, e, d)
    lane = _float_order_bits(d) if d.is_floating_point() else d.to(torch.int64)
    if not asc:
        lane = torch.bitwise_not(lane)
    return lane, v


def merge_keys_for_pages(pages: Sequence[Page], sort_exprs: Sequence[Expr],
                         ascending: Sequence[bool],
                         nulls_first: Optional[Sequence[bool]] = None) -> List[torch.Tensor]:
    """One int64 total-order key per row for EVERY page jointly: lane
    ranges are global, so keys compare across producers.  Dead rows get
    INT64_MAX (the tail of each sorted page).  Raises _NoScalarKey when
    the combined lanes cannot pack into 62 bits.  The ranges are read
    from the device, one transfer a lane and page."""
    if nulls_first is None:
        nulls_first = [False] * len(sort_exprs)
    if len(sort_exprs) == 1:
        # single lane: the raw lane compares across pages unpacked;
        # NULLs pin to the extremes (a value at INT64_MIN+1 or MAX-1
        # ties them, the reference's documented edge)
        e, a, nf = sort_exprs[0], ascending[0], nulls_first[0]
        null_key = _I64_MIN + 1 if nf else _I64_MAX - 1
        keys = []
        for p in pages:
            lane, v = _raw_lane(p, e, a)
            keys.append(torch.where(p.row_mask, torch.where(v, lane, torch.full_like(
                lane, null_key)), torch.full_like(lane, _I64_MAX)))
        return keys

    per_lane = []  # [lane][page] = (packed lane code, valid)
    cards = []
    for e, a, nf in zip(sort_exprs, ascending, nulls_first):
        lanes = []
        lo, hi = None, None
        for p in pages:
            lane, v = _raw_lane(p, e, a)
            present = v & p.row_mask
            first = torch.argmax(present.to(torch.int8))
            neutral = torch.where(present.any(), lane[first], torch.zeros_like(lane[first]))
            lane = torch.where(present, lane, neutral)
            plo, phi = (int(x) for x in torch.stack([lane.min(), lane.max()]).cpu())
            lanes.append((lane, v))
            lo = plo if lo is None else min(lo, plo)
            hi = phi if hi is None else max(hi, phi)
        width = hi - lo + 1
        if width + 2 >= (1 << 62):
            raise _NoScalarKey()
        cards.append(width + 2)
        null_key = -1 if nf else width
        per_lane.append([(torch.where(v, lane - lo, torch.full_like(lane, null_key)) + 1)
                         for lane, v in lanes])
    total = 1
    for c in cards:
        total *= c
        if total >= (1 << 62):
            raise _NoScalarKey()
    keys = []
    for pi, p in enumerate(pages):
        key = torch.zeros(p.capacity, dtype=torch.int64, device=p.device)
        for li, card in enumerate(cards):
            key = key * card + per_lane[li][pi]
        keys.append(torch.where(p.row_mask, key, torch.full_like(key, _I64_MAX)))
    return keys


def merge_two_sorted(a: Page, b: Page, key_a: torch.Tensor,
                     key_b: torch.Tensor) -> Tuple[Page, torch.Tensor]:
    """Merge two sorted pages by per-row keys (dead rows at the tail
    with INT64_MAX keys), on K22."""
    cols, mask, key = k22.merge_sorted(
        ([(blk.data, blk.valid) for blk in a.blocks], a.row_mask, key_a),
        ([(blk.data, blk.valid) for blk in b.blocks], b.row_mask, key_b))
    blocks = tuple(Block(d, v, ba.type, ba.dictionary or bb.dictionary)
                   for (d, v), ba, bb in zip(cols, a.blocks, b.blocks))
    return Page(blocks, mask), key


def merge_sorted_pages(pages: Sequence[Page], sort_exprs: Sequence[Expr],
                       ascending: Sequence[bool],
                       nulls_first: Optional[Sequence[bool]] = None) -> Page:
    """k-way order-preserving merge of per-producer sorted pages; falls
    back to concatenate + sort when no exact scalar key exists."""
    from presto_tpu_torch.ops.sort import sort_page
    from presto_tpu_torch.page import concat_pages_device

    if len(pages) == 1:
        return pages[0]
    try:
        keys = merge_keys_for_pages(pages, sort_exprs, ascending, nulls_first)
    except _NoScalarKey:
        return sort_page(concat_pages_device(list(pages)), list(sort_exprs),
                         list(ascending), nulls_first)
    items = list(zip(pages, keys))
    while len(items) > 1:
        nxt = []
        for i in range(0, len(items) - 1, 2):
            (pa, ka), (pb, kb) = items[i], items[i + 1]
            nxt.append(merge_two_sorted(pa, pb, ka, kb))
        if len(items) % 2:
            nxt.append(items[-1])
        items = nxt
    return items[0][0]
