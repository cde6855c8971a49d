"""ORDER BY and top-N over Pages.

Counterpart of ``presto_tpu/ops/sort.py``: a multi-key ORDER BY is a
series of stable argsorts from the least-significant key up, each key
in two passes (values, then a null-rank pass), dead rows last.  Like
the reference, which leaves its argsorts to XLA's sort, this uses
``torch.sort``; TPC-H Q1 sorts at most a few dozen rows.  Top-N
(``topn_page``) does not sort up to K7's ``MAX_N`` rows: K7 ``topn``
picks the first ``n`` rows under the same order; past it the page is
sorted, as the reference's ``topn_page`` always does.  Dictionary
VARCHAR keys order by collation rank, not by code; double and REAL
keys by :func:`double_sort_key`; a raw VARCHAR key by its
``pack_lanes`` lanes (K17), whose order as signed int64 is the bytes'
order: K7 takes them as one key of k lanes, and a sort makes k stable
passes over them where the reference makes one a byte.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch

from presto_tpu_torch.expr.compile import ExprCompiler
from presto_tpu_torch.expr.ir import ColumnRef, Expr
from presto_tpu_torch.kernels import topn as k7
from presto_tpu_torch.kernels.topn import double_sort_key
from presto_tpu_torch.ops.rawstring import pack_lanes
from presto_tpu_torch.page import Block, Page


def _dict_rank(page: Page, e: Expr, d: torch.Tensor) -> torch.Tensor:
    """Dictionary-encoded varchar keys order by VALUE: codes map through
    the dictionary's collation-rank table; a raw varchar's bytes become
    their order-preserving lanes."""
    from presto_tpu_torch.ops.aggregate import _collation_luts

    if e.type.is_raw_string:
        return pack_lanes(d)
    if not isinstance(e, ColumnRef) or not e.type.is_string:
        return d
    dic = page.blocks[e.index].dictionary
    if dic is None:
        return d
    rank_lut, _ = _collation_luts(dic, d.device)
    codes = torch.clamp(d, 0, rank_lut.shape[0] - 1).to(torch.int64)
    return rank_lut[codes]


def _value_key(data: torch.Tensor, ascending: bool) -> torch.Tensor:
    """Exact sortable form of one integer key: a descending key is its
    bitwise complement (doubles take :func:`double_sort_key`)."""
    if data.dtype == torch.bool:
        data = data.to(torch.int32)
    return data if ascending else torch.bitwise_not(data)


def _stable_pass(perm: torch.Tensor, key: torch.Tensor) -> torch.Tensor:
    return perm[torch.argsort(key[perm], stable=True)]


def sort_perm(page: Page, sort_exprs: Sequence[Expr], ascending: Sequence[bool],
              nulls_first: Optional[Sequence[bool]] = None) -> torch.Tensor:
    """Permutation ordering live rows by the sort keys; dead rows go
    last."""
    c = ExprCompiler.for_page(page)
    if nulls_first is None:
        nulls_first = [False] * len(sort_exprs)
    perm = torch.arange(page.capacity, device=page.device)
    for e, asc, nf in list(zip(sort_exprs, ascending, nulls_first))[::-1]:
        d, v = c.compile(e)(page)
        d = _dict_rank(page, e, d)
        if d.dim() > 1:
            # limb decimals (canonical limb form is value order) and a raw
            # varchar's lanes: stable passes from the last lane to the first
            for j in range(d.shape[-1] - 1, -1, -1):
                perm = _stable_pass(perm, _value_key(d[:, j], asc))
        elif d.is_floating_point():
            perm = _stable_pass(perm, double_sort_key(d, asc))
        else:
            perm = _stable_pass(perm, _value_key(d, asc))
        null_rank = (~v if not nf else v).to(torch.int32)
        perm = _stable_pass(perm, null_rank)
    dead = (~page.row_mask).to(torch.int32)
    return _stable_pass(perm, dead)


def gather_page(page: Page, perm: torch.Tensor,
                live: Optional[torch.Tensor] = None) -> Page:
    blocks: List[Block] = []
    for b in page.blocks:
        blocks.append(Block(b.data[perm], b.valid[perm], b.type, b.dictionary))
    mask = page.row_mask[perm] if live is None else live
    return Page(tuple(blocks), mask)


def sort_page(page: Page, sort_exprs: Sequence[Expr], ascending: Sequence[bool],
              nulls_first: Optional[Sequence[bool]] = None) -> Page:
    return gather_page(page, sort_perm(page, sort_exprs, ascending, nulls_first))


def topn_keys(page: Page, sort_exprs: Sequence[Expr], ascending: Sequence[bool],
              nulls_first: Optional[Sequence[bool]] = None) -> List[k7.SortKey]:
    """The K7 sort keys of a page: each key's values (dictionary codes
    as collation ranks), valid bits and direction."""
    c = ExprCompiler.for_page(page)
    if nulls_first is None:
        nulls_first = [False] * len(sort_exprs)
    keys = []
    for e, asc, nf in zip(sort_exprs, ascending, nulls_first):
        d, v = c.compile(e)(page)
        keys.append((_dict_rank(page, e, d), v, bool(asc), bool(nf)))
    return keys


#: ``topn_page`` calls past K7's ``MAX_N`` on a card: the page sorted
#: (``torch.sort``), then its first n live rows
sorted_topn_runs = 0


def topn_page(page: Page, sort_exprs: Sequence[Expr], ascending: Sequence[bool], n: int,
              nulls_first: Optional[Sequence[bool]] = None) -> Page:
    """The first ``n`` live rows of ``page`` in ORDER BY order, as a page
    of capacity ``n`` (rows past the live count dead): K7 up to its
    ``MAX_N``; past it the reference's ``topn_page``, ``sort_page`` and
    then the first ``n`` rows (dead rows sort last)."""
    global sorted_topn_runs
    if n > k7.MAX_N:
        ids = sort_perm(page, sort_exprs, ascending, nulls_first)[:n]
        if ids.shape[0] < n:
            ids = torch.cat([ids, torch.zeros(n - ids.shape[0], dtype=ids.dtype,
                                              device=ids.device)])
        count = page.row_mask.sum()
        sorted_topn_runs += int(page.row_mask.is_cuda)
    else:
        ids, count = k7.topn(topn_keys(page, sort_exprs, ascending, nulls_first),
                             page.row_mask, n)
    live = torch.arange(n, device=page.device) < count
    return gather_page(page, ids.to(torch.int64), live)


def limit_page(page: Page, n: int) -> Page:
    """The first ``n`` live rows in page order (the reference's
    ``limit_page``): a running count of live rows and a mask."""
    seen = torch.cumsum(page.row_mask.to(torch.int32), 0)
    return Page(page.blocks, page.row_mask & (seen <= n))


def topn_compact_page(page: Page, sort_exprs: Sequence[Expr], ascending: Sequence[bool], n: int,
                      nulls_first: Optional[Sequence[bool]] = None) -> Page:
    """The top n rows compacted to an n-row page: the per-shard bound of
    a distributed TopN (CreatePartialTopN.java's role), so each shard
    ships n rows to the gather instead of its whole output.  Past the
    page's capacity, the sorted page itself (the reference's
    ``topn_compact_page``); else :func:`topn_page` (K7)."""
    if n >= page.capacity:
        return sort_page(page, sort_exprs, ascending, nulls_first)
    return topn_page(page, sort_exprs, ascending, n, nulls_first)


def limit_compact_page(page: Page, n: int) -> Page:
    """The first n live rows compacted to an n-row page (the per-shard
    bound of a distributed Limit): the live rows' positions by a stable
    sort of the dead flags, then a gather."""
    if n >= page.capacity:
        return limit_page(page, n)
    live = limit_page(page, n)
    order = torch.argsort((~live.row_mask).to(torch.int8), stable=True)[:n]
    return gather_page(live, order)
