"""Exact packed keys shared by the join build and probe (K4, K5) and
the sorted-group aggregation (K6): the exact branch of the reference's
``pack_or_hash_keys`` (``presto_tpu/ops/aggregate.py``), here as the
plain torch version and as the C descriptor of ``csrc/keys.cuh``."""

from __future__ import annotations

import ctypes
from typing import Sequence, Tuple

import torch

from presto_tpu_torch.kernels import build

MAX_KEYS = 8
I64_MAX = (1 << 63) - 1
_KINDS = {torch.bool: 0, torch.int32: 1, torch.int64: 2}

# a key column: (data, valid, lo, card), card = hi - lo + 2 (code 0 is NULL)
Key = Tuple[torch.Tensor, torch.Tensor, int, int]


def pack_plain(keys: Sequence[Key], n: int, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """(packed int64 key, every key column valid) per row."""
    key = torch.zeros(n, dtype=torch.int64, device=device)
    ok = torch.ones(n, dtype=torch.bool, device=device)
    for data, valid, lo, card in keys:
        code = torch.where(valid, data.to(torch.int64) - lo + 1, torch.zeros_like(key))
        key = key * card + code
        ok = ok & valid
    return key, ok


def check(keys: Sequence[Key], n: int, what: str) -> list:
    """Validate key columns for a launch; returns their tensors."""
    if not keys or len(keys) > MAX_KEYS:
        raise ValueError(f"{what}: 1 to {MAX_KEYS} key columns")
    tensors = []
    for data, valid, _, _ in keys:
        if data.dim() != 1 or data.shape[0] != n or data.dtype not in _KINDS:
            raise ValueError(f"{what}: key columns must be (n,) int32/int64/bool")
        if valid.dtype != torch.bool or valid.shape != (n,):
            raise ValueError(f"{what}: key validity must be (n,) bool")
        tensors += [data, valid]
    return tensors


def c_args(keys: Sequence[Key]) -> list:
    """The C arguments ``n_keys, data, valid, kind, lo, card``; the
    arrays must stay referenced until the call returns."""
    return [len(keys), build.ptrs(d.data_ptr() for d, _, _, _ in keys),
            build.ptrs(v.data_ptr() for _, v, _, _ in keys),
            build.ints(_KINDS[d.dtype] for d, _, _, _ in keys),
            build.ptrs(lo for _, _, lo, _ in keys),
            build.ptrs(card for _, _, _, card in keys)]


# ctypes types of c_args
C_ARGTYPES = [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
              ctypes.c_void_p, ctypes.c_void_p]


def pack(entry: str, keys: Sequence[Key], row_mask: torch.Tensor, what: str) -> torch.Tensor:
    """The masked packed keys of every row, by ``csrc/keys.cuh``'s pack
    kernel behind the C entry point ``entry`` (K4's sets NULL keys to
    the sentinel, K6's keeps them as code 0)."""
    n = row_mask.shape[0]
    out = torch.empty(n, dtype=torch.int64, device=row_mask.device)
    fn = getattr(build.library(), entry)
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_longlong, ctypes.c_void_p] + C_ARGTYPES + \
        [ctypes.c_void_p, ctypes.c_void_p]
    err = fn(n, row_mask.data_ptr(), *c_args(keys), out.data_ptr(),
             build.stream_of(row_mask))
    build.check(err, what)
    return out
