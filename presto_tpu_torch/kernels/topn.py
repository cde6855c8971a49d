"""K7 ``topn``: the first ``n`` live rows under an ORDER BY.

:func:`topn` returns the row ids of the first ``n`` live rows in the
reference's order (``presto_tpu/ops/sort.py`` ``sort_perm``): key by
key, the NULL rank then the value (a long decimal limb by limb, high
limb first; a descending key reversed), then the row position, which
is how the reference's stable sorts break ties; a double orders by
:func:`double_sort_key`.  Dead rows never qualify.  CUDA tensors
launch ``csrc/topn.cu``; CPU tensors run :func:`topn_plain`, which
composes the reference's stable argsorts.
"""

from __future__ import annotations

import ctypes
from typing import Sequence, Tuple

import torch

from presto_tpu_torch import NotPorted
from presto_tpu_torch.kernels import build

MAX_N = 100  # csrc/topn.cu K7_MAX_N
MAX_KEYS = 16
THREADS = 64  # csrc/topn.cu K7_THREADS
_KINDS = {torch.bool: 0, torch.int32: 1, torch.int64: 2, torch.float64: 4}
KIND_D128 = 3
_I64_MAX = (1 << 63) - 1

launches = 0
#: launches with n above 32
wide_launches = 0
#: launches with a double key
double_launches = 0

# (data (n,) integers or doubles or (n, 2) int64 limbs, valid, ascending,
# nulls_first)
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
    same key from each double it reads."""
    x = data if ascending else -data
    bits = x.contiguous().view(torch.int64)
    bits = torch.where(x == 0, torch.zeros_like(bits), bits)
    bits = torch.where(torch.isnan(x), torch.full_like(bits, _I64_MAX), bits)
    return torch.where(bits < 0, bits ^ _I64_MAX, bits)


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
    ``keys`` and their count (a device int32 of shape (1,)).  CPU
    tensors take the plain version; CUDA tensors launch the kernel.
    ``n`` above :data:`MAX_N` raises :class:`NotPorted`."""
    if n > MAX_N:
        raise NotPorted(f"top-n with n = {n} > {MAX_N}")
    if len(keys) > MAX_KEYS:  # the kernel's limit, held on every device
        raise ValueError(f"topn: more than {MAX_KEYS} keys")
    if not row_mask.is_cuda:
        return topn_plain(keys, row_mask, n)
    global launches, wide_launches, double_launches
    rows = row_mask.shape[0]
    if row_mask.dtype != torch.bool or row_mask.dim() != 1 or rows >= (1 << 31):
        raise ValueError("topn: row_mask must be (rows,) bool")
    if not keys or len(keys) > MAX_KEYS or n < 1:
        raise ValueError("topn: 1 to 8 keys and n >= 1")
    tensors = [row_mask]
    kinds = []
    for data, valid, _, _ in keys:
        if data.dim() == 2 and data.shape == (rows, 2) and data.dtype == torch.int64:
            kinds.append(KIND_D128)
        elif data.dim() == 1 and data.shape == (rows,) and data.dtype in _KINDS:
            kinds.append(_KINDS[data.dtype])
        else:
            raise ValueError("topn: keys must be (rows,) integers or doubles, or (rows, 2) "
                             "int64 limbs")
        if valid.dtype != torch.bool or valid.shape != (rows,):
            raise ValueError("topn: key validity must be (rows,) bool")
        tensors += [data, valid]
    build.require_cuda(tensors, "topn")
    dev = row_mask.device
    blocks = max(1, min(-(-rows // THREADS), 132 * 4))
    cand = torch.empty(blocks * n, dtype=torch.int32, device=dev)
    cand_cnt = torch.empty(blocks, dtype=torch.int32, device=dev)
    ids = torch.empty(n, dtype=torch.int32, device=dev)
    count = torch.empty(1, dtype=torch.int32, device=dev)
    fn = build.library().k7_topn
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_longlong, ctypes.c_void_p, ctypes.c_int] + \
        [ctypes.c_void_p] * 5 + [ctypes.c_int, ctypes.c_int] + [ctypes.c_void_p] * 5
    err = fn(rows, row_mask.data_ptr(), len(keys),
             build.ptrs(d.data_ptr() for d, _, _, _ in keys),
             build.ptrs(v.data_ptr() for _, v, _, _ in keys),
             build.ints(kinds), build.ints(int(a) for _, _, a, _ in keys),
             build.ints(int(nf) for _, _, _, nf in keys), n, blocks,
             cand.data_ptr(), cand_cnt.data_ptr(), ids.data_ptr(), count.data_ptr(),
             build.stream_of(row_mask))
    build.check(err, "topn")
    launches += 1
    wide_launches += int(n > 32)
    double_launches += int(_KINDS[torch.float64] in kinds)
    return ids, count
