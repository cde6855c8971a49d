"""Long-decimal limb arithmetic, the subset TPC-H Q1, Q6, Q14 and Q3 use.

Counterpart of ``presto_tpu/ops/decimal128.py``.  A decimal(p <= 36)
value is two base-10^18 int64 limbs, ``value = hi * 10^18 + lo`` with
``0 <= lo < 10^18`` (the sign rides on ``hi``).  Sums fold as four
base-10^9 limbs so that no int64 lane wraps.  The five-limb
decimal(37..38) layout is not ported.
"""

from __future__ import annotations

import numpy as np
import torch

from presto_tpu_torch import NotPorted

BASE = 10 ** 18
_B9 = 10 ** 9


def _check_width(d: torch.Tensor, w: int) -> None:
    if d.shape[-1] != w:
        raise NotPorted(f"decimal limb width {d.shape[-1]}")


# -- host-side encode/decode --------------------------------------------------

def encode_py(values, capacity: int, limbs: int = 2) -> np.ndarray:
    """Python ints (arbitrary precision) -> (capacity, 2) limbs."""
    if limbs != 2:
        raise NotPorted("decimal(37..38) limbs")
    out = np.zeros((capacity, 2), dtype=np.int64)
    for i, v in enumerate(values):
        if v is None:
            continue
        hi, lo = divmod(int(v), BASE)
        out[i, 0] = hi
        out[i, 1] = lo
    return out


def decode_py(limbs: np.ndarray):
    """(n, 2) limbs -> list of python ints."""
    arr = np.asarray(limbs, dtype=np.int64)
    if arr.shape[-1] != 2:
        raise NotPorted("decimal(37..38) limbs")
    return [int(h) * BASE + int(lo) for h, lo in arr]


# -- normalization and arithmetic ---------------------------------------------

def normalize(hi: torch.Tensor, lo: torch.Tensor) -> torch.Tensor:
    """Restore the 0 <= lo < BASE invariant; returns stacked (..., 2)."""
    carry = torch.div(lo, BASE, rounding_mode="floor")
    lo = lo - carry * BASE
    hi = hi + carry
    return torch.stack([hi, lo], dim=-1)


def split(d: torch.Tensor):
    return d[..., 0], d[..., 1]


def add(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    _check_width(a, 2)
    return normalize(a[..., 0] + b[..., 0], a[..., 1] + b[..., 1])


def sub(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    _check_width(a, 2)
    return normalize(a[..., 0] - b[..., 0], a[..., 1] - b[..., 1])


def neg(a: torch.Tensor) -> torch.Tensor:
    _check_width(a, 2)
    return normalize(-a[..., 0], -a[..., 1])


def from_int64(x: torch.Tensor) -> torch.Tensor:
    """Short (int64) value -> two limbs."""
    return normalize(torch.zeros_like(x), x)


def _fdiv(a: torch.Tensor, b: int) -> torch.Tensor:
    return torch.div(a, b, rounding_mode="floor")


def mul_int64(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Full product of two int64 scaled values (|a|, |b| < 10^18) ->
    limbs: schoolbook over base-10^9 halves, every partial < 10^18."""
    a1, a0 = _fdiv(a, _B9), torch.remainder(a, _B9)
    b1, b0 = _fdiv(b, _B9), torch.remainder(b, _B9)
    cross = a1 * b0 + a0 * b1
    c_hi = _fdiv(cross, _B9)
    c_lo = cross - c_hi * _B9
    return normalize(a1 * b1 + c_hi, c_lo * _B9 + a0 * b0)


def mul_long_short(a: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """Long limbs x int64 scaled value: ``(hi*B + lo)*k = (hi*k)*B +
    lo*k``, ``lo*k`` through the full int64 multiplier.  Exact whenever
    the result fits p <= 36."""
    _check_width(a, 2)
    ah, al = split(a)
    lh, ll = split(mul_int64(al, k))
    return normalize(ah * k + lh, ll)


def mul_small(a: torch.Tensor, k: int) -> torch.Tensor:
    """Limbs times a small int64 (|k| <= ~4*10^9, a power of ten of an
    up-scale): ``lo`` splits into base-10^9 halves so every partial
    product fits int64; ``hi * k`` wraps as the reference's does."""
    _check_width(a, 2)
    ah, al = split(a)
    l1, l0 = _fdiv(al, _B9), torch.remainder(al, _B9)
    p0, p1 = l0 * k, l1 * k
    c1 = _fdiv(p1, _B9)
    return normalize(ah * k + c1, (p1 - c1 * _B9) * _B9 + p0)


def upscale(a: torch.Tensor, k: int) -> torch.Tensor:
    """``a * 10^k`` in steps of at most 10^9 (the reference's
    ``rescale`` up; a result past 36 digits wraps, as there)."""
    while k > 0:
        step = min(k, 9)
        a = mul_small(a, 10 ** step)
        k -= step
    return a


def compare(a: torch.Tensor, b: torch.Tensor):
    """``(lt, eq)`` of two limb columns: canonical limbs (high limb
    first, low limb in [0, 10^18)) order as their values do."""
    _check_width(a, 2)
    lt = (a[..., 0] < b[..., 0]) | ((a[..., 0] == b[..., 0]) & (a[..., 1] < b[..., 1]))
    return lt, (a[..., 0] == b[..., 0]) & (a[..., 1] == b[..., 1])


def to_double(a: torch.Tensor, scale: int) -> torch.Tensor:
    """``(hi * 10^18 + lo) / 10^scale`` in float64, one rounding per
    operation (the CUDA interpreter uses the same _rn operations)."""
    _check_width(a, 2)
    ah, al = split(a)
    return div_exact(ah.to(torch.float64) * float(BASE) + al.to(torch.float64),
                     10.0 ** scale)


def div_exact(x: torch.Tensor, d: float) -> torch.Tensor:
    """``x / d`` correctly rounded on every device: PyTorch divides a
    CUDA tensor by a Python number as a multiplication by its
    reciprocal, which can differ in the last bit, so the divisor goes
    in as a tensor."""
    return x / torch.tensor(d, dtype=x.dtype, device=x.device)


def to_sum_limbs(a: torch.Tensor) -> torch.Tensor:
    """(n, 2) base-10^18 -> (n, 4) base-10^9 limbs, safe to sum over
    ~9*10^9 rows without int64 overflow."""
    _check_width(a, 2)
    ah, al = a[..., 0], a[..., 1]
    return torch.stack([
        torch.div(ah, _B9, rounding_mode="floor"), torch.remainder(ah, _B9),
        torch.div(al, _B9, rounding_mode="floor"), torch.remainder(al, _B9),
    ], dim=-1)


def from_sum_limbs(s: torch.Tensor) -> torch.Tensor:
    """Summed base-10^9 limbs (n, 4) -> normalized (n, 2)."""
    _check_width(s, 4)
    h1, h0, l1, l0 = s[..., 0], s[..., 1], s[..., 2], s[..., 3]
    c = torch.div(l0, _B9, rounding_mode="floor")
    l0 = l0 - c * _B9
    l1 = l1 + c
    c = torch.div(l1, _B9, rounding_mode="floor")
    l1 = l1 - c * _B9
    hi_extra = c
    lo = l1 * _B9 + l0
    c = torch.div(h0, _B9, rounding_mode="floor")
    h0 = h0 - c * _B9
    h1 = h1 + c
    hi = h1 * _B9 + h0 + hi_extra
    return normalize(hi, lo)
