"""Columnar device batches: Block and Page, on torch tensors.

Counterpart of ``presto_tpu/page.py``.  A Block is a dense tensor plus
a validity mask; a Page is a tuple of Blocks plus a row mask.  The two
masks keep their meaning: ``Block.valid`` is SQL NULL-ness per value,
``Page.row_mask`` is row liveness after filters, and operators ignore
rows whose ``row_mask`` is False.  VARCHAR columns hold int32 codes
into a host-side :class:`Dictionary`; ARRAY, MAP and ROW columns hold
``(capacity, slots)`` matrices (``ops/container.py``), an array of
strings its elements' dictionary.

Every tensor of a page lies on one device, which the page reports.
The executor glue of ``presto_tpu/exec/local.py`` (concat, pad, slice,
live extent) lives here as plain torch.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from presto_tpu_torch import NotPorted
from presto_tpu_torch.types import Type


class Dictionary:
    """Host-side immutable string dictionary for a VARCHAR column.

    Codes are indexes into ``values``; identity-hashed."""

    __slots__ = ("values", "_index")

    def __init__(self, values: Sequence[str]):
        self.values = list(values)
        self._index: Optional[Dict[str, int]] = None

    def code_of(self, s: str) -> int:
        if self._index is None:
            self._index = {v: i for i, v in enumerate(self.values)}
        return self._index.get(s, -1)

    def decode(self, codes: np.ndarray) -> np.ndarray:
        """The values of ``codes`` (None out of range), looked up one
        code at a time: a result decodes a few rows against
        dictionaries of up to millions of values."""
        values = self.values
        out = np.empty(codes.shape, dtype=object)
        in_range = (codes >= 0) & (codes < len(values))
        out[in_range] = [values[c] for c in codes[in_range].tolist()]
        out[~in_range] = None
        return out

    def __len__(self) -> int:
        return len(self.values)

    def __repr__(self) -> str:
        return f"Dictionary({len(self.values)} values)"


def _unsupported_storage(t: Type) -> bool:
    return t.is_raw_string


@dataclasses.dataclass
class Block:
    """One column: dense tensor + validity mask, both ``(capacity,...)``.

    On a host page (``Page.device_get``) the two arrays are numpy."""

    data: torch.Tensor
    valid: torch.Tensor
    type: Type
    dictionary: Optional[Dictionary] = None

    @classmethod
    def from_numpy(
        cls,
        values,
        type_: Type,
        valid: Optional[np.ndarray] = None,
        dictionary: Optional[Dictionary] = None,
        capacity: Optional[int] = None,
        device="cpu",
    ) -> "Block":
        n = len(values)
        cap = capacity if capacity is not None else n
        if _unsupported_storage(type_):
            raise NotPorted(f"{type_} columns")
        if type_.is_long_decimal and (
            not isinstance(values, np.ndarray) or values.ndim == 1
        ):
            from presto_tpu_torch.ops.decimal128 import encode_py

            data = encode_py(list(values), cap, limbs=type_.value_shape[0])
        elif (type_.is_array or type_.is_map) and (
            not isinstance(values, np.ndarray) or values.ndim == 1
        ):
            from presto_tpu_torch.ops.container import encode_arrays, encode_maps

            data = (encode_arrays if type_.is_array else encode_maps)(list(values), type_, cap)
        else:
            data = np.zeros((cap,) + type_.value_shape, dtype=type_.np_dtype)
            data[:n] = values
        v = np.zeros(cap, dtype=np.bool_)
        v[:n] = True if valid is None else valid
        return cls(torch.from_numpy(data).to(device),
                   torch.from_numpy(v).to(device), type_, dictionary)

    @property
    def capacity(self) -> int:
        return self.data.shape[0]

    def __repr__(self) -> str:
        return f"Block({self.type}, capacity={self.capacity})"


@dataclasses.dataclass
class Page:
    """A batch of rows: tuple of Blocks + row liveness mask."""

    blocks: Tuple[Block, ...]
    row_mask: torch.Tensor  # bool (capacity,)

    @classmethod
    def from_arrays(
        cls,
        columns: Sequence[np.ndarray],
        types: Sequence[Type],
        valids: Optional[Sequence[Optional[np.ndarray]]] = None,
        dictionaries: Optional[Sequence[Optional[Dictionary]]] = None,
        capacity: Optional[int] = None,
        device="cpu",
    ) -> "Page":
        n = len(columns[0]) if columns else 0
        cap = capacity if capacity is not None else max(n, 1)
        blocks = []
        for i, (col, t) in enumerate(zip(columns, types)):
            v = valids[i] if valids is not None else None
            d = dictionaries[i] if dictionaries is not None else None
            blocks.append(Block.from_numpy(col, t, valid=v, dictionary=d,
                                           capacity=cap, device=device))
        mask = torch.zeros(cap, dtype=torch.bool)
        mask[:n] = True
        return cls(tuple(blocks), mask.to(device))

    @classmethod
    def empty(cls, types: Sequence[Type], capacity: int, device) -> "Page":
        blocks = []
        for t in types:
            if _unsupported_storage(t):
                raise NotPorted(f"{t} columns")
            blocks.append(Block(
                torch.zeros((capacity,) + t.value_shape,
                            dtype=_torch_dtype(t), device=device),
                torch.zeros(capacity, dtype=torch.bool, device=device), t))
        return cls(tuple(blocks),
                   torch.zeros(capacity, dtype=torch.bool, device=device))

    @property
    def capacity(self) -> int:
        return self.row_mask.shape[0]

    @property
    def num_blocks(self) -> int:
        return len(self.blocks)

    @property
    def types(self) -> Tuple[Type, ...]:
        return tuple(b.type for b in self.blocks)

    @property
    def device(self) -> torch.device:
        return self.row_mask.device

    def num_rows(self) -> torch.Tensor:
        return self.row_mask.sum(dtype=torch.int64)

    def to(self, device) -> "Page":
        """The same page with every tensor on ``device``.  Copies onto a
        card are asynchronous; a copy to the CPU is not, since a host
        reader would otherwise see the bytes before they arrive."""
        device = torch.device(device)
        if self.row_mask.device == device:
            return self
        nb = device.type == "cuda"
        return Page(
            tuple(Block(b.data.to(device, non_blocking=nb),
                        b.valid.to(device, non_blocking=nb),
                        b.type, b.dictionary) for b in self.blocks),
            self.row_mask.to(device, non_blocking=nb))

    # -- host materialization ---------------------------------------------
    def device_get(self) -> "Page":
        """The page with numpy arrays in place of tensors: one
        device-to-host copy of the concatenated bytes would need a
        common dtype, so each tensor copies on its own after a single
        synchronisation."""
        if self.row_mask.is_cuda:
            torch.cuda.synchronize(self.row_mask.device)
        return Page(
            tuple(Block(b.data.cpu().numpy(), b.valid.cpu().numpy(),
                        b.type, b.dictionary) for b in self.blocks),
            self.row_mask.cpu().numpy())

    def to_pylist(self, decode_strings: bool = True) -> List[tuple]:
        """Compact live rows to host python tuples (None for NULLs)."""
        if isinstance(self.row_mask, torch.Tensor):
            return self.device_get().to_pylist(decode_strings)
        mask = np.asarray(self.row_mask)
        rows_idx = np.nonzero(mask)[0]
        cols = []
        for b in self.blocks:
            data = np.asarray(b.data)[rows_idx]
            valid = np.asarray(b.valid)[rows_idx]
            if b.type.is_string and b.dictionary is not None and decode_strings:
                vals = b.dictionary.decode(data)
            elif _unsupported_storage(b.type):
                raise NotPorted(f"{b.type} output")
            elif b.type.is_array or b.type.is_map or b.type.name == "row":
                from presto_tpu_torch.ops.container import decode_arrays, decode_maps, \
                    decode_rows

                vals = np.empty(len(data), dtype=object)
                vals[:] = (decode_rows(data, b.type) if b.type.name == "row" else
                           (decode_arrays if b.type.is_array else decode_maps)(
                               data, b.type, b.dictionary))
            elif b.type.is_long_decimal:
                import decimal

                from presto_tpu_torch.ops.decimal128 import decode_py

                vals = np.empty(len(data), dtype=object)
                with decimal.localcontext() as ctx:
                    ctx.prec = 50  # scaleb must not round 38-digit values
                    vals[:] = [decimal.Decimal(v).scaleb(-(b.type.scale or 0))
                               for v in decode_py(data)]
            elif b.type.is_decimal:
                import decimal

                sc = b.type.scale or 0
                vals = np.empty(len(data), dtype=object)
                vals[:] = [decimal.Decimal(int(v)).scaleb(-sc) for v in data]
            else:
                vals = data
            col = [None if not v else _to_py(vals[i], b.type) for i, v in enumerate(valid)]
            cols.append(col)
        return [tuple(c[i] for c in cols) for i in range(len(rows_idx))]

    def compact_host(self) -> "Page":
        """Host-side compaction: gather live rows to a prefix (numpy)."""
        p = self.device_get() if isinstance(self.row_mask, torch.Tensor) else self
        mask = np.asarray(p.row_mask)
        idx = np.nonzero(mask)[0]
        n = len(idx)
        blocks = []
        for b in p.blocks:
            data = np.asarray(b.data)[idx]
            valid = np.asarray(b.valid)[idx]
            if n == 0:
                data = np.zeros((1,) + data.shape[1:], dtype=data.dtype)
                valid = np.zeros(1, dtype=np.bool_)
            blocks.append(Block(data, valid, b.type, b.dictionary))
        mask_out = np.zeros(max(n, 1), dtype=np.bool_)
        mask_out[:n] = True
        return Page(tuple(blocks), mask_out)

    def __repr__(self) -> str:
        return f"Page({self.num_blocks} blocks, capacity={self.capacity})"


def _torch_dtype(t: Type) -> torch.dtype:
    return torch.from_numpy(np.zeros(0, dtype=t.np_dtype)).dtype


def _to_py(v, t: Type):
    if t.name == "decimal":
        return v  # already decimal.Decimal (exact)
    if t.name == "double":
        return float(v)
    if t.name == "boolean":
        return bool(v)
    if t.name == "timestamp":
        import datetime

        return datetime.datetime(1970, 1, 1) + datetime.timedelta(microseconds=int(v))
    if t.name == "interval day to second":
        import datetime

        return datetime.timedelta(microseconds=int(v))
    if t.name == "interval year to month":
        return int(v)
    if t.is_string:
        return v  # already decoded (str) or raw code
    if isinstance(v, (np.integer,)):
        return int(v)
    return v


def page_from_numpy(columns: Sequence[np.ndarray],
                    valids: Sequence[np.ndarray],
                    row_mask: np.ndarray,
                    types: Sequence[str],
                    dictionary_values: Sequence[Optional[Sequence[str]]],
                    device="cpu") -> Page:
    """A port Page holding exactly the given state: column arrays (limb
    matrices for long decimals), valid masks, row mask, type strings
    and the dictionary values of string columns.  The tests hand the
    same numpy state to both packages through this."""
    from presto_tpu_torch.types import parse_type

    blocks = []
    for data, valid, ts, dv in zip(columns, valids, types, dictionary_values):
        t = parse_type(ts)
        if _unsupported_storage(t):
            raise NotPorted(f"{t} columns")
        blocks.append(Block(
            torch.from_numpy(np.array(data, dtype=t.np_dtype)).to(device),
            torch.from_numpy(np.array(valid, dtype=np.bool_)).to(device),
            t, Dictionary(dv) if dv is not None else None))
    mask = torch.from_numpy(np.array(row_mask, dtype=np.bool_))
    return Page(tuple(blocks), mask.to(device))


# -- executor glue (presto_tpu/exec/local.py), plain torch ---------------------

def cross_append_single(q: Page, r: Page) -> Page:
    """Append a one-row relation's columns to every row of ``q`` (the
    reference's ``cross_append_single``, EnforceSingleRow + a
    nested-loop join's one-row case).  ``r``'s row is its first live
    row, found on the device (no host read of its value); each of its
    blocks broadcasts to ``q``'s capacity, valid where the value is
    valid and the row is live (a relation with no live row gives
    NULLs)."""
    first = torch.argmax(r.row_mask.to(torch.int8)).reshape(1)
    live = r.row_mask[first]
    blocks = list(q.blocks)
    for b in r.blocks:
        data = b.data[first].expand((q.capacity,) + tuple(b.data.shape[1:])).contiguous()
        valid = (b.valid[first] & live).expand(q.capacity).contiguous()
        blocks.append(Block(data, valid, b.type, b.dictionary))
    return Page(tuple(blocks), q.row_mask)


def remap_union_leg_page(page: Page, offs: Sequence[int], channels) -> Page:
    """One UNION ALL leg's page in the union's terms (the reference's
    ``remap_union_leg_page``): each varchar column's codes move by the
    leg's offset into the merged dictionary, and every block takes the
    union channel's type and dictionary."""
    blocks = []
    for b, off, ch in zip(page.blocks, offs, channels):
        data = b.data + off if off else b.data
        blocks.append(Block(data, b.valid, ch.type, ch.dictionary))
    return Page(tuple(blocks), page.row_mask)


def concat_pages_device(pages: Sequence[Page]) -> Page:
    """Concatenate pages column-wise on device (capacities may differ)."""
    if len(pages) == 1:
        return pages[0]
    blocks = []
    for i in range(pages[0].num_blocks):
        data = torch.cat([p.blocks[i].data for p in pages])
        valid = torch.cat([p.blocks[i].valid for p in pages])
        b0 = pages[0].blocks[i]
        blocks.append(Block(data, valid, b0.type, b0.dictionary))
    mask = torch.cat([p.row_mask for p in pages])
    return Page(tuple(blocks), mask)


def pad_page_to(page: Page, tgt: int) -> Page:
    """Pad a page with dead rows up to capacity ``tgt`` (no-op when
    already at least that large)."""
    cap = page.capacity
    if tgt <= cap or cap == 0:
        return page
    pad = tgt - cap

    def padded(a):
        return torch.cat([a, torch.zeros((pad,) + tuple(a.shape[1:]),
                                         dtype=a.dtype, device=a.device)])

    return Page(tuple(Block(padded(b.data), padded(b.valid), b.type, b.dictionary)
                      for b in page.blocks), padded(page.row_mask))


def slice_page(page: Page, n: int) -> Page:
    """First n physical rows (used after sorts that compact live rows
    to the front)."""
    blocks = tuple(
        Block(b.data[:n], b.valid[:n], b.type, b.dictionary) for b in page.blocks
    )
    return Page(blocks, page.row_mask[:n])


def _extent_live(mask: torch.Tensor) -> torch.Tensor:
    """(highest live index + 1, live count) of a row mask, as one
    2-element tensor so the host pays a single transfer."""
    idx = torch.arange(mask.shape[0], dtype=torch.int32, device=mask.device)
    extent = torch.where(mask, idx, torch.full_like(idx, -1)).max() + 1
    return torch.stack([extent, mask.sum(dtype=torch.int32)])
