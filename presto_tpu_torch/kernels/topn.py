"""K7 ``topn``: the first ``n`` live rows under an ORDER BY.

:func:`topn` returns the row ids of the first ``n`` live rows in the
reference's order (``presto_tpu/ops/sort.py`` ``sort_perm``): key by
key, the NULL rank then the value (a long or wide decimal limb by
limb, most significant first, a raw varchar's ``pack_lanes`` lanes lane
by lane; a descending key reversed), then the row position, which
is how the reference's stable sorts break ties; a double (or a REAL,
as its exact double) orders by :func:`double_sort_key`.  Dead rows
never qualify.  CUDA tensors launch ``csrc/topn.cu``; CPU tensors run
:func:`topn_plain`, which composes the reference's stable argsorts.

The kernel compares rows by an adaptive 64-bit prefix of that order:
:func:`order_words_plain` and :func:`prefix_plain` are its encoding in
plain torch (the tests sort by them and hold the order against
:func:`topn_plain`).
"""

from __future__ import annotations

import ctypes
from typing import Sequence, Tuple

import torch

from presto_tpu_torch.kernels import build

MAX_N = 100  # csrc/topn.cu K7_MAX_N
MAX_KEYS = 16
FIELDS = 16  # csrc/topn.cu K7_FIELDS: the fields a prefix may take bits from
_KINDS = {torch.bool: 0, torch.int32: 1, torch.int64: 2, torch.float64: 4, torch.int16: 5,
          torch.int8: 6, torch.float32: 7}
KIND_LANES = 3  # (rows, k) int64 lanes: decimal limbs or a raw varchar's lanes
MAX_LANES = 128  # csrc/topn.cu K7_MAX_LANES
_FLOAT_KINDS = (_KINDS[torch.float64], _KINDS[torch.float32])
_I64_MAX = (1 << 63) - 1
_I64_MIN = -(1 << 63)

launches = 0
#: launches with n above 32
wide_launches = 0
#: launches with a double (or REAL) key, and with a REAL key
double_launches = 0
real_launches = 0
#: launches with a key of five int64 lanes (a wide decimal's limbs, or a
#: raw varchar of 33 to 40 bytes), and with any key of several lanes
d38_launches = 0
lanes_launches = 0

# (data (n,) integers or doubles, (n, 2) or (n, 5) int64 limbs, or (n, k) int64
# lanes of a raw varchar, valid, ascending, nulls_first)
SortKey = Tuple[torch.Tensor, torch.Tensor, bool, bool]


def _value_key(data: torch.Tensor, ascending: bool) -> torch.Tensor:
    if data.dtype == torch.bool:
        data = data.to(torch.int32)
    return data if ascending else torch.bitwise_not(data)


def double_sort_key(data: torch.Tensor, ascending: bool) -> torch.Tensor:
    """An int64 whose ascending order is the reference's order of a
    double key: it negates a descending key, and XLA's sort then orders
    floats with -0.0 equal to 0.0 and every NaN after +inf (so NaN stays
    last either way), ties kept in place by the stable passes.  The
    bits of a negative double flip below zero; the kernel computes the
    same key from each double it reads.  A REAL (float32) key orders
    as its exact double."""
    data = data.to(torch.float64)
    x = data if ascending else -data
    bits = x.contiguous().view(torch.int64)
    bits = torch.where(x == 0, torch.zeros_like(bits), bits)
    bits = torch.where(torch.isnan(x), torch.full_like(bits, _I64_MAX), bits)
    return torch.where(bits < 0, bits ^ _I64_MAX, bits)


def order_words_plain(keys: Sequence[SortKey], rows: int) -> torch.Tensor:
    """``(rows, fields)`` int64: each row's comparison tuple, one field a
    column, as ``csrc/topn.cu`` ``field`` computes it with the sign bit
    flipped (so signed order is the fields' unsigned order): per key its
    null rank (0 first), then its lanes (a value, its complement when
    descending, a double's :func:`double_sort_key`); last the row
    position.  Rows sorted by the columns in turn are in
    :func:`topn_plain`'s order."""
    cols = []
    for data, valid, asc, nf in keys:
        cols.append((valid if nf else ~valid).to(torch.int64) + _I64_MIN)
        lanes = [data[:, j] for j in range(data.shape[1])] if data.dim() > 1 else [data]
        cols += [double_sort_key(x, asc) if x.is_floating_point()
                 else _value_key(x, asc).to(torch.int64) for x in lanes]
    cols.append(torch.arange(rows, dtype=torch.int64, device=cols[0].device) + _I64_MIN)
    return torch.stack(cols, 1)


def _srl(x: torch.Tensor, s: int) -> torch.Tensor:
    return (x >> s) & ((1 << (64 - s)) - 1)


def prefix_plain(words: torch.Tensor, live: torch.Tensor) -> Tuple[torch.Tensor, int]:
    """``(prefix, q)``: each row's 64-bit prefix (its bits as int64) as
    ``k7_range`` lays it out over the live rows, and the first field not
    wholly in it.  Field after field (the first :data:`FIELDS`), each
    takes the bits its span over the live rows needs, as ``value -
    least``, until 64 are full (the last cut to its high bits); a
    constant field takes none.  Live rows ordered by the prefix (as
    unsigned), then by the fields from ``q`` on, are in
    :func:`topn_plain`'s order."""
    prefix = torch.zeros(words.shape[0], dtype=torch.int64, device=words.device)
    ranged = min(words.shape[1], FIELDS)
    q, left = ranged, 64
    if not bool(live.any()):
        return prefix, q
    for f in range(ranged):
        col = words[live, f]
        lo, hi = int(col.min()), int(col.max())
        if hi == lo:
            continue
        width = (hi - lo).bit_length()
        d = words[:, f] - lo  # the unsigned difference's bits (it wraps)
        if width > left:
            prefix |= _srl(d, width - left)
            q = f
            break
        left -= width
        prefix |= d << left
        if left == 0:
            q = f + 1
            break
    return prefix, q


def _stable_pass(perm: torch.Tensor, key: torch.Tensor) -> torch.Tensor:
    return perm[torch.argsort(key[perm], stable=True)]


def topn_plain(keys: Sequence[SortKey], row_mask: torch.Tensor, n: int):
    """``(row ids (n,) int32, count)``: the first ``count <= n`` entries
    are the top rows in order, the rest 0; the plain version."""
    perm = torch.arange(row_mask.shape[0], device=row_mask.device)
    for data, valid, asc, nf in list(keys)[::-1]:
        lanes = [data[:, j] for j in range(data.shape[1])] if data.dim() > 1 else [data]
        for lane in lanes[::-1]:
            perm = _stable_pass(perm, double_sort_key(lane, asc) if lane.is_floating_point()
                                else _value_key(lane, asc))
        perm = _stable_pass(perm, (~valid if not nf else valid).to(torch.int32))
    perm = _stable_pass(perm, (~row_mask).to(torch.int32))
    count = torch.clamp(row_mask.sum(dtype=torch.int32), max=n)
    ids = torch.zeros(n, dtype=torch.int32, device=row_mask.device)
    top = perm[:n].to(torch.int32)
    ids[:top.shape[0]] = top
    ids = torch.where(torch.arange(n, device=row_mask.device) < count, ids,
                      torch.zeros_like(ids))
    return ids, count.reshape(1)


def topn(keys: Sequence[SortKey], row_mask: torch.Tensor, n: int):
    """Row ids of the first ``n`` live rows of ``row_mask`` under
    ``keys`` and their count (a device int32 of shape (1,)).  A (rows,
    k) int64 key compares its lanes as signed int64, lane 0 first: a
    decimal's canonical limbs and a raw varchar's ``pack_lanes`` alike.
    CPU tensors take the plain version; CUDA tensors launch the kernel.
    ``n`` above :data:`MAX_N` raises (``ops/sort.py`` ``topn_page`` sorts
    the page past it)."""
    if n > MAX_N:
        raise ValueError(f"topn: n = {n} > {MAX_N}")
    if len(keys) > MAX_KEYS:  # the kernel's limit, held on every device
        raise ValueError(f"topn: more than {MAX_KEYS} keys")
    if not row_mask.is_cuda:
        return topn_plain(keys, row_mask, n)
    global launches, wide_launches, double_launches, real_launches, d38_launches, \
        lanes_launches
    rows = row_mask.shape[0]
    if row_mask.dtype != torch.bool or row_mask.dim() != 1 or rows >= (1 << 31):
        raise ValueError("topn: row_mask must be (rows,) bool")
    if not keys or len(keys) > MAX_KEYS or n < 1:
        raise ValueError("topn: 1 to 8 keys and n >= 1")
    tensors = [row_mask]
    kinds, widths = [], []
    for data, valid, _, _ in keys:
        if data.dim() == 2 and data.shape[0] == rows and 1 <= data.shape[1] <= MAX_LANES \
                and data.dtype == torch.int64 and data.is_contiguous():
            kinds.append(KIND_LANES)
            widths.append(data.shape[1])
        elif data.dim() == 1 and data.shape == (rows,) and data.dtype in _KINDS:
            kinds.append(_KINDS[data.dtype])
            widths.append(1)
        else:
            raise ValueError("topn: keys must be (rows,) integers, doubles or REALs, or "
                             f"contiguous (rows, k <= {MAX_LANES}) int64 limbs or lanes")
        if valid.dtype != torch.bool or valid.shape != (rows,):
            raise ValueError("topn: key validity must be (rows,) bool")
        tensors += [data, valid]
    build.require_cuda(tensors, "topn")
    dev = row_mask.device
    lib = build.library()
    size = lib.k7_scratch_bytes
    size.restype = ctypes.c_longlong
    size.argtypes = [ctypes.c_longlong]
    scratch = torch.empty(size(rows), dtype=torch.uint8, device=dev)
    ids = torch.empty(n, dtype=torch.int32, device=dev)
    count = torch.empty(1, dtype=torch.int32, device=dev)
    fn = lib.k7_topn
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_longlong, ctypes.c_void_p, ctypes.c_int] + \
        [ctypes.c_void_p] * 6 + [ctypes.c_int] + [ctypes.c_void_p] * 4
    err = fn(rows, row_mask.data_ptr(), len(keys),
             build.ptrs(d.data_ptr() for d, _, _, _ in keys),
             build.ptrs(v.data_ptr() for _, v, _, _ in keys),
             build.ints(kinds), build.ints(widths), build.ints(int(a) for _, _, a, _ in keys),
             build.ints(int(nf) for _, _, _, nf in keys), n, scratch.data_ptr(),
             ids.data_ptr(), count.data_ptr(), build.stream_of(row_mask))
    build.check(err, "topn")
    launches += 1
    wide_launches += int(n > 32)
    double_launches += int(any(k in _FLOAT_KINDS for k in kinds))
    real_launches += int(_KINDS[torch.float32] in kinds)
    d38_launches += int(5 in widths)
    lanes_launches += int(max(widths) > 1)
    return ids, count
