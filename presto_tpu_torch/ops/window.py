"""Window functions over one page.

Counterpart of ``presto_tpu/ops/window.py``: one stable multi-key sort
of the whole page by (partition keys, order keys), dead rows last, then
every window function as position arithmetic and prefix sums over the
sorted rows, scattered back to the original row order.  The sort keeps
the reference's chain of stable passes exactly (``torch.sort``), since
``row_number`` and ``rank`` over ties depend on it: order keys from
the last to the first, each a pass over its value (a long decimal limb
by limb, a double by :func:`~presto_tpu_torch.ops.sort.double_sort_key`)
and then over its NULL rank (NULLs last); then the partition key,
packed exactly or hashed (``pack_or_hash_keys`` over canonical codes,
K9 for the hashed form); then the dead rows.  Everything after the
permutation is K10 ``window_eval``.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import torch

from presto_tpu_torch import NotPorted
from presto_tpu_torch.expr.compile import ExprCompiler
from presto_tpu_torch.expr.ir import Expr
from presto_tpu_torch.kernels import keys as kk
from presto_tpu_torch.kernels import window_eval as k10
from presto_tpu_torch.ops.rawstring import pack_lanes
from presto_tpu_torch.page import Block, Page
from presto_tpu_torch.types import BIGINT, DOUBLE, Type


@dataclasses.dataclass(frozen=True)
class WindowFunc:
    """One window function application.

    kind: row_number | rank | dense_rank | ntile | percent_rank |
          cume_dist | nth_value | sum | avg | min | max | count |
          count_star | lead | lag | first_value | last_value

    frame: None for the default frame (RANGE UNBOUNDED PRECEDING ..
    CURRENT ROW with ORDER BY, whole partition without — the same
    default as the reference, operator/window/WindowOperator.java);
    ("whole",) for the entire partition;
    ("rows", start, end) for a ROWS frame with signed row offsets
    relative to the current row (None = unbounded in that direction).
    """

    kind: str
    arg: Optional[Expr] = None
    offset: int = 1  # lead/lag offset; ntile buckets; nth_value n
    frame: Optional[tuple] = None
    # skip NULL argument values when stepping (lead/lag) or picking
    # (first/last/nth_value) — the reference's IGNORE NULLS treatment
    ignore_nulls: bool = False

    @property
    def type(self) -> Type:
        if self.kind in ("row_number", "rank", "dense_rank", "count", "count_star",
                         "ntile"):
            return BIGINT
        if self.kind in ("avg", "percent_rank", "cume_dist"):
            return DOUBLE
        if self.kind == "sum":
            return _window_sum_type(self.arg.type)
        return self.arg.type


def _window_sum_type(t: Type) -> Type:
    """Window-frame sum accumulator/output type.  Unlike the grouped
    aggregation tier (ops/aggregate._sum_type widens short p>15 args to
    limb state), frames accumulate via 1-D cumsum over at most one
    page of rows, so short decimals stay scaled int64 — the
    kernel-soundness analyzer treats window outputs as unbounded and
    the page-capacity row bound keeps the fold inside 2^63 for the
    corpus precisions."""
    if t.is_decimal and not t.is_long_decimal:
        from presto_tpu_torch.types import DecimalType

        return DecimalType(18, t.scale)
    from presto_tpu_torch.ops.aggregate import _sum_type

    return _sum_type(t)


def _func(f: WindowFunc, has_order: bool) -> k10.Func:
    """The kernel's descriptor of ``f``: its frame resolved as the
    reference's ``_compute_sorted`` resolves it."""
    kind = k10.KIND_NAMES.index(f.kind)
    if f.frame is not None and f.frame[0] == "rows":
        frame, start, end = k10.FRAME_ROWS, f.frame[1], f.frame[2]
    elif f.frame == ("whole",) or not has_order:
        frame, start, end = k10.FRAME_WHOLE, None, None
    else:
        frame, start, end = k10.FRAME_PEERS, None, None
    scale = None
    if f.kind == "avg":
        st = _window_sum_type(f.arg.type)
        scale = st.scale if st.is_decimal else None
    return k10.Func(kind, frame, start, end, f.offset, f.ignore_nulls, scale)


def _check_ported(f: WindowFunc) -> None:
    if f.arg is None:
        return
    t = f.arg.type
    if f.kind in ("sum", "avg", "min", "max") and t.is_long_decimal:
        raise NotPorted(f"window {f.kind} over {t}")
    if t.is_raw_string or t.value_shape not in ((), (2,)):
        raise NotPorted(f"window {f.kind} over {t}")


def _stable_pass(perm: torch.Tensor, key: torch.Tensor) -> torch.Tensor:
    return perm[torch.argsort(key[perm], stable=True)]


def _partition_key(page: Page, exprs: Sequence[Expr], domains) -> torch.Tensor:
    """The packed (exact domains) or hashed partition key of every row,
    I64_MAX on dead rows."""
    from presto_tpu_torch.ops.join import key_columns

    cols = key_columns(page, exprs, domains)
    if not page.row_mask.is_cuda:
        return kk.masked_plain(cols, page.row_mask, False)[0]
    return kk.pack(cols, page.row_mask, False, "window partition key")


def window_perm(page: Page, partition_exprs: Sequence[Expr], order_exprs: Sequence[Expr],
                ascending: Sequence[bool], partition_domains=None):
    """``(perm, partition key)``: the reference's sort chain of
    ``window_page``."""
    from presto_tpu_torch.ops.sort import _dict_rank, _value_key, double_sort_key

    c = ExprCompiler.for_page(page)
    perm = torch.arange(page.capacity, device=page.device)
    for e, asc in list(zip(order_exprs, ascending))[::-1]:
        d, v = c.compile(e)(page)
        d = _dict_rank(page, e, d)
        if d.dim() > 1:  # limb matrices and raw lanes: canonical form is value order
            for j in range(d.shape[-1] - 1, -1, -1):
                perm = _stable_pass(perm, _value_key(d[:, j], asc))
        elif d.is_floating_point():
            perm = _stable_pass(perm, double_sort_key(d, asc))
        else:
            perm = _stable_pass(perm, _value_key(d, asc))
        perm = _stable_pass(perm, (~v).to(torch.int32))  # NULLs last
    if partition_exprs:
        pkey = _partition_key(page, partition_exprs, partition_domains)
        perm = _stable_pass(perm, pkey)
    else:
        pkey = torch.zeros(page.capacity, dtype=torch.int64, device=page.device)
    perm = _stable_pass(perm, (~page.row_mask).to(torch.int32))
    return perm, pkey


def window_inputs(page: Page, partition_exprs: Sequence[Expr], order_exprs: Sequence[Expr],
                  ascending: Sequence[bool], funcs: Sequence[WindowFunc],
                  partition_domains=None):
    """Everything K10 takes for ``window_page``: ``(perm, row mask,
    partition key, order keys, descriptors, arguments)``."""
    for f in funcs:
        _check_ported(f)
    perm, pkey = window_perm(page, partition_exprs, order_exprs, ascending,
                             partition_domains)
    c = ExprCompiler.for_page(page)
    order_cols = []  # codes as they are, as the reference (only their equality matters)
    for e in order_exprs:
        d, v = c.compile(e)(page)
        order_cols.append((pack_lanes(d) if e.type.is_raw_string else d, v))
    descs = [_func(f, bool(order_exprs)) for f in funcs]
    args = [None if f.arg is None else c.compile(f.arg)(page) for f in funcs]
    return perm, page.row_mask, pkey, order_cols, descs, args


def window_page(
    page: Page,
    partition_exprs: Sequence[Expr],
    order_exprs: Sequence[Expr],
    ascending: Sequence[bool],
    funcs: Sequence[WindowFunc],
    partition_domains=None,
) -> Page:
    """Append one Block per window function to ``page`` (original row
    order preserved)."""
    outs = k10.window_eval(*window_inputs(page, partition_exprs, order_exprs, ascending,
                                          funcs, partition_domains))
    blocks: List[Block] = list(page.blocks)
    for f, (data, valid) in zip(funcs, outs):
        blocks.append(Block(data, valid, f.type))
    return Page(tuple(blocks), page.row_mask)
