"""Group and join keys shared by the join build and probes (K4, K5,
K8) and the sorted-group aggregation (K6): the reference's
``pack_or_hash_keys`` (``presto_tpu/ops/aggregate.py``), its exact
branch and its hash branch (K9 ``hash_keys``), here as the plain torch
versions and as the C descriptor of ``csrc/keys.cuh``.

A key column is ``(data, valid, lo, card)``: ``card = hi - lo + 2`` in
the exact branch (code 0 is NULL), or ``card = 0`` for every column of
a key without an exact domain, which hashes.  A double key hashes its
value truncated to int64, as the reference's ``d.astype(jnp.int64)``
does (so two doubles with one integer part share a hash lane)."""

from __future__ import annotations

import ctypes
from typing import Optional, Sequence, Tuple

import torch

from presto_tpu_torch.kernels import build

MAX_KEYS = 16
I64_MAX = (1 << 63) - 1
_KINDS = {torch.bool: 0, torch.int32: 1, torch.int64: 2, torch.float64: 3}

# splitmix64's finalizer constants and the NULL-flag weight, as signed
# int64 (the plain version multiplies in wrapping int64)
_M1 = 0xBF58476D1CE4E5B9 - (1 << 64)
_M2 = 0x94D049BB133111EB - (1 << 64)
_NULL_WEIGHT = 0x9E37

# a key column: (data, valid, lo, card), card = hi - lo + 2 (code 0 is
# NULL), or 0 when the key hashes
Key = Tuple[torch.Tensor, torch.Tensor, int, int]

#: K9 launches (the hash branch's pack kernel), and those hashing a
#: double key column
launches = 0
double_launches = 0


def hashed(keys: Sequence[Key]) -> bool:
    """True when ``keys`` take the hash branch (every card is 0)."""
    return bool(keys) and keys[0][3] == 0


def _srl(x: torch.Tensor, s: int) -> torch.Tensor:
    """Logical right shift of int64 lanes (torch has no uint64 shift on
    the CPU): the arithmetic shift with the sign's copies masked off."""
    return (x >> s) & ((1 << (64 - s)) - 1)


def _mix64(x: torch.Tensor) -> torch.Tensor:
    x = (x ^ _srl(x, 30)) * _M1
    x = (x ^ _srl(x, 27)) * _M2
    return x ^ _srl(x, 31)


def pack_plain(keys: Sequence[Key], n: int, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """(int64 key, every key column valid) per row, exact or hashed."""
    if len(keys) > MAX_KEYS:  # the kernels' limit, held on every device
        raise ValueError(f"keys: more than {MAX_KEYS} key columns")
    ok = torch.ones(n, dtype=torch.bool, device=device)
    key = torch.zeros(n, dtype=torch.int64, device=device)
    if hashed(keys):
        for data, valid, _, _ in keys:
            v = valid.to(torch.int64)
            lane = torch.where(valid, data.to(torch.int64), torch.zeros_like(key))
            key = _mix64(key ^ _mix64(lane + _NULL_WEIGHT * v))
            ok = ok & valid
        return key & I64_MAX, ok
    for data, valid, lo, card in keys:
        code = torch.where(valid, data.to(torch.int64) - lo + 1, torch.zeros_like(key))
        key = key * card + code
        ok = ok & valid
    return key, ok


def masked_plain(keys: Sequence[Key], row_mask: torch.Tensor,
                 null_as_sentinel: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain version of :func:`pack`: ``(keys, flags)``."""
    key, ok = pack_plain(keys, row_mask.shape[0], row_mask.device)
    keep = row_mask & ok if null_as_sentinel else row_mask
    flags = torch.stack([torch.any(row_mask & ~ok), torch.any(row_mask)]).to(torch.int32)
    return torch.where(keep, key, torch.full_like(key, I64_MAX)), flags


def check(keys: Sequence[Key], n: int, what: str) -> list:
    """Validate key columns for a launch; returns their tensors."""
    if not keys or len(keys) > MAX_KEYS:
        raise ValueError(f"{what}: 1 to {MAX_KEYS} key columns")
    if len({card == 0 for _, _, _, card in keys}) != 1:
        raise ValueError(f"{what}: a key is either exact or hashed in every column")
    tensors = []
    for data, valid, _, card in keys:
        if data.dim() != 1 or data.shape[0] != n or data.dtype not in _KINDS \
                or (data.dtype == torch.float64 and card != 0):
            raise ValueError(f"{what}: key columns must be (n,) int32/int64/bool "
                             "(float64 only when hashed)")
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


def pack(keys: Sequence[Key], row_mask: torch.Tensor, null_as_sentinel: bool, what: str,
         flags: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The masked key of every row of a CUDA page, by ``csrc/keys.cu``:
    I64_MAX where the row is dead, and where a key is NULL if
    ``null_as_sentinel`` (a join key matches nothing; a grouping key
    keeps NULL).  Exact keys take the pack kernel, hashed keys K9.
    ``flags`` (two int32) receives the build's has-NULL-key and nonempty
    bits."""
    global launches, double_launches
    n = row_mask.shape[0]
    build.require_cuda([row_mask] + check(keys, n, what), what)
    out = torch.empty(n, dtype=torch.int64, device=row_mask.device)
    is_hashed = hashed(keys)
    fn = getattr(build.library(), "k9_hash_keys" if is_hashed else "pk_pack_keys")
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_longlong, ctypes.c_void_p, ctypes.c_int] + C_ARGTYPES + \
        [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
    err = fn(n, row_mask.data_ptr(), int(null_as_sentinel), *c_args(keys), out.data_ptr(),
             flags.data_ptr() if flags is not None else None, build.stream_of(row_mask))
    build.check(err, what)
    if is_hashed:
        launches += 1
        double_launches += int(any(d.dtype == torch.float64 for d, _, _, _ in keys))
    return out


def hash_keys(keys: Sequence[Key], row_mask: torch.Tensor,
              null_as_sentinel: bool = False) -> torch.Tensor:
    """K9 on its own: the masked hashed keys of a page (CPU tensors take
    the plain version)."""
    if not hashed(keys):
        raise ValueError("hash_keys: every key column's card must be 0")
    if not row_mask.is_cuda:
        return masked_plain(keys, row_mask, null_as_sentinel)[0]
    return pack(keys, row_mask, null_as_sentinel, "hash_keys")
