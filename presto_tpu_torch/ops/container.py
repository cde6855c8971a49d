"""ARRAY, MAP and ROW values.

Counterpart of ``presto_tpu/ops/container.py``.  A container column is
a dense ``(capacity, 1 + slots)`` matrix in one storage dtype (int64
for integers, dates and dictionary codes, float64 for doubles, int32
for booleans): slot 0 holds the length (the entry count of a map), the
other slots the elements, padded with the null sentinel (INT_MIN or
NaN).  A map keeps its keys in slots ``1..m`` and its values in
``m+1..2m``; a ROW is ``(capacity, fields)`` with no length slot.

The host half (``encode_arrays`` ... ``decode_rows``) is a copy of the
reference's: pages are built from python values and results read back
through it.  The device half lives in the kernels: K12
``container_eval`` (``kernels/container_eval.py``) computes the per-row
slot functions, K13 ``unnest_expand`` the expansion of container rows
into rows, K14 ``group_collect`` array_agg's and map_agg's states.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np

from presto_tpu_torch.types import Type, null_sentinel


# ---------------------------------------------------------------------------
# host encode / decode (page construction and result materialization)
# ---------------------------------------------------------------------------

def encode_arrays(values: Sequence[Optional[list]], t: Type,
                  capacity: int) -> np.ndarray:
    """Encode python lists into the (capacity, 1+max) matrix.  ``None``
    rows encode as length 0 (row NULL-ness lives in Block.valid);
    ``None`` elements encode as the storage sentinel."""
    max_elems = t.max_elems
    storage = t.np_dtype
    sent = null_sentinel(storage)
    out = np.full((capacity, 1 + max_elems), sent, dtype=storage)
    out[:, 0] = 0
    elem = t.element
    for i, v in enumerate(values):
        if v is None:
            continue
        n = min(len(v), max_elems)
        if len(v) > max_elems:
            raise ValueError(
                f"array literal of {len(v)} elements exceeds the column's "
                f"static capacity {max_elems} (declare array(T, N) wider)")
        out[i, 0] = n
        for j, e in enumerate(v[:n]):
            out[i, 1 + j] = sent if e is None else _encode_scalar(e, elem)
    return out


def encode_maps(values: Sequence[Optional[dict]], t: Type,
                capacity: int) -> np.ndarray:
    max_elems = t.max_elems
    storage = t.np_dtype
    sent = null_sentinel(storage)
    out = np.full((capacity, 1 + 2 * max_elems), sent, dtype=storage)
    out[:, 0] = 0
    for i, v in enumerate(values):
        if v is None:
            continue
        items = list(v.items())
        if len(items) > max_elems:
            raise ValueError(
                f"map of {len(items)} entries exceeds static capacity {max_elems}")
        out[i, 0] = len(items)
        for j, (k, val) in enumerate(items):
            out[i, 1 + j] = _encode_scalar(k, t.key_element)
            out[i, 1 + max_elems + j] = sent if val is None else _encode_scalar(val, t.element)
    return out


def _encode_scalar(v, t: Type):
    if t.is_string:
        raise ValueError(
            "string container elements must be pre-coded to dictionary "
            "codes before encode (binder resolves literals)")
    if t.is_decimal:
        return int(round(float(v) * 10 ** (t.scale or 0)))
    if t.name == "boolean":
        return int(bool(v))
    return v


def _decode_scalar(v, t: Type, dictionary=None):
    if t.is_string:
        code = int(v)
        if dictionary is not None and 0 <= code < len(dictionary):
            return dictionary.values[code]
        return None
    if t.name in ("double", "real"):
        return float(v)
    if t.is_decimal:
        return float(v) / 10 ** (t.scale or 0)
    if t.name == "boolean":
        return bool(v)
    return int(v)


def _is_null_slot(x, storage: np.dtype) -> bool:
    if storage.kind == "f":
        return bool(np.isnan(x))
    return int(x) == np.iinfo(storage).min


def decode_arrays(data: np.ndarray, t: Type, dictionary=None) -> List[list]:
    """(n, 1+max) matrix -> python lists (row validity handled by caller)."""
    out = []
    storage = t.np_dtype
    for row in data:
        n = int(row[0]) if not _is_null_slot(row[0], storage) else 0
        out.append([
            None if _is_null_slot(x, storage) else _decode_scalar(x, t.element, dictionary)
            for x in row[1: 1 + n]
        ])
    return out


def decode_maps(data: np.ndarray, t: Type, dictionary=None) -> List[dict]:
    out = []
    storage = t.np_dtype
    m = t.max_elems
    if t.element is not None and t.element.is_array:
        # multimap layout: [count, keys(m), value-arrays(m x (1+av))]
        av = 1 + t.element.max_elems
        for row in data:
            n = int(row[0]) if not _is_null_slot(row[0], storage) else 0
            d = {}
            for j in range(n):
                k = _decode_scalar(row[1 + j], t.key_element, dictionary)
                vrow = row[1 + m + j * av: 1 + m + (j + 1) * av]
                d[k] = decode_arrays(vrow[None, :], t.element)[0]
            out.append(d)
        return out
    for row in data:
        n = int(row[0]) if not _is_null_slot(row[0], storage) else 0
        d = {}
        for j in range(n):
            k = _decode_scalar(row[1 + j], t.key_element, dictionary)
            v = row[1 + m + j]
            d[k] = None if _is_null_slot(v, storage) else _decode_scalar(v, t.element)
        out.append(d)
    return out


def decode_rows(data: np.ndarray, t: Type) -> List[tuple]:
    """(n, nfields) row matrix -> python tuples (row validity is the
    caller's; NULL fields decode as None)."""
    out = []
    storage = t.np_dtype
    for r in data:
        out.append(tuple(
            None if _is_null_slot(x, storage) else _decode_scalar(x, ft)
            for x, ft in zip(r, t.fields)))
    return out


def is_container(t: Type) -> bool:
    """Whether ``t`` is stored as a slot matrix: ARRAY, MAP or ROW (and
    the sketch types, whose functions stay with the reference)."""
    return t.is_array or t.is_map or t.name in ("row", "hll", "setdigest")


def unnest_page(page, exprs, ordinality: bool, channels, needed=None):
    """UNNEST over one page (the reference's ``unnest_expand``): each
    container of ``exprs`` evaluated (K12 / K1), then K13 expands the live
    rows into one row per element, the page's columns replicated, the
    elements (a map's keys and values) typed and coded as ``channels``
    says, and the 1-based ordinality last when asked for.  ``needed``:
    the output columns read downstream (None: all); a page column outside
    it is not replicated and stands as an empty ``(rows, 0)`` block."""
    import torch

    from presto_tpu_torch.expr.compile import ExprCompiler
    from presto_tpu_torch.kernels import unnest_expand as k13
    from presto_tpu_torch.page import Block, Page, _torch_dtype
    from presto_tpu_torch.types import BIGINT

    c = ExprCompiler.for_page(page)
    args = []
    for e in exprs:
        d, v = c.compile(e)(page)
        t = e.type
        m = t.max_elems
        halves = [(1, _torch_dtype(t.key_element)), (1 + m, _torch_dtype(t.element))] \
            if t.is_map else [(1, _torch_dtype(t.element))]
        args.append((d, v, m, halves))
    keep = [i for i in range(len(page.blocks)) if needed is None or i in needed]
    outer_out, elems, ordn, total, _ = k13.unnest_expand(
        page.row_mask, args, [(page.blocks[i].data, page.blocks[i].valid) for i in keep],
        ordinality)
    rows = max(total, 1)
    gathered = dict(zip(keep, outer_out))
    blocks = []
    for i, b in enumerate(page.blocks):
        d, v = gathered.get(i) or (
            torch.empty((rows, 0), dtype=b.data.dtype, device=page.device),
            torch.zeros(rows, dtype=torch.bool, device=page.device))
        blocks.append(Block(d, v, b.type, b.dictionary))
    for (d, v), ch in zip(elems, channels[len(page.blocks):]):
        blocks.append(Block(d, v, ch.type, ch.dictionary))
    mask = torch.ones(max(total, 1), dtype=torch.bool, device=page.device)
    if total == 0:
        mask[0] = False
    if ordinality:
        blocks.append(Block(ordn, mask.clone(), BIGINT))
    return Page(tuple(blocks), mask)
