"""ORDER BY and top-N over Pages.

Counterpart of ``presto_tpu/ops/sort.py``: a multi-key ORDER BY is a
series of stable argsorts from the least-significant key up, each key
in two passes (values, then a null-rank pass), dead rows last.  Like
the reference, which leaves its argsorts to XLA's sort, this uses
``torch.sort``; TPC-H Q1 sorts at most a few dozen rows.  Top-N
(``topn_page``) does not sort: K7 ``topn`` picks the first ``n`` rows
under the same order.  Dictionary VARCHAR keys order by collation
rank, not by code; double keys by :func:`double_sort_key`.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch

from presto_tpu_torch import NotPorted
from presto_tpu_torch.expr.compile import ExprCompiler
from presto_tpu_torch.expr.ir import ColumnRef, Expr
from presto_tpu_torch.kernels import topn as k7
from presto_tpu_torch.kernels.topn import double_sort_key
from presto_tpu_torch.page import Block, Page


def _dict_rank(page: Page, e: Expr, d: torch.Tensor) -> torch.Tensor:
    """Dictionary-encoded varchar keys order by VALUE: codes map through
    the dictionary's collation-rank table."""
    from presto_tpu_torch.ops.aggregate import _collation_luts

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
        if e.type.is_raw_string:
            raise NotPorted("ORDER BY raw strings")
        d = _dict_rank(page, e, d)
        if d.dim() > 1:
            # limb decimals: canonical limb form is value order, so
            # stable passes from the last limb to the first
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
        if e.type.is_raw_string or e.type.name == "real":
            raise NotPorted(f"top-n over {e.type} keys")
        d, v = c.compile(e)(page)
        keys.append((_dict_rank(page, e, d), v, bool(asc), bool(nf)))
    return keys


def topn_page(page: Page, sort_exprs: Sequence[Expr], ascending: Sequence[bool], n: int,
              nulls_first: Optional[Sequence[bool]] = None) -> Page:
    """The first ``n`` live rows of ``page`` in ORDER BY order, as a page
    of capacity ``n`` (rows past the live count dead)."""
    ids, count = k7.topn(topn_keys(page, sort_exprs, ascending, nulls_first),
                         page.row_mask, n)
    live = torch.arange(n, device=page.device) < count
    return gather_page(page, ids.to(torch.int64), live)


def limit_page(page: Page, n: int) -> Page:
    """The first ``n`` live rows in page order (the reference's
    ``limit_page``): a running count of live rows and a mask."""
    seen = torch.cumsum(page.row_mask.to(torch.int32), 0)
    return Page(page.blocks, page.row_mask & (seen <= n))
