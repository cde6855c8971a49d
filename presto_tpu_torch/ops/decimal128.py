"""Long-decimal limb arithmetic (p <= 38).

Counterpart of ``presto_tpu/ops/decimal128.py``.  Two layouts, picked
by precision (the functions dispatch on the trailing dimension, as the
reference's do):

- decimal(19..36): two base-10^18 int64 limbs, ``value = hi * 10^18 +
  lo`` with ``0 <= lo < 10^18`` (the sign rides on ``hi``);
- decimal(37..38), the "wide" layout: five base-10^9 limbs, most
  significant first; limbs 1-4 lie in ``[0, 10^9)`` and limb 0 carries
  the sign, so the limbs order lexicographically as the values do.

Sums fold as base-10^9 limbs (four for the two-limb layout, the five
limbs as they are for the wide one) so that no int64 lane wraps.  The
five limbs hold 45 digits: an up-scale or a wide product past them
drops the top carry (``_shift_digits_wide``, ``mul_wide_small``), so
the wide layout wraps where a short decimal's overflow gives NULL, as
the reference's does.
"""

from __future__ import annotations

import numpy as np
import torch

BASE = 10 ** 18
_B9 = 10 ** 9
#: limb count of the wide (p in (36, 38]) layout
WIDE_LIMBS = 5


def width(d: torch.Tensor) -> int:
    """Limb count of a decimal tensor (2 = base-10^18, 5 = base-10^9)."""
    return int(d.shape[-1])


def _fdiv(a, b):
    return torch.div(a, b, rounding_mode="floor")


def _norm_wide(limbs: torch.Tensor) -> torch.Tensor:
    """Restore the canonical form of a (..., 5) base-10^9 vector: each
    lower limb's floor-division carry moves up; limb 0 keeps the rest."""
    outs = []
    carry = torch.zeros_like(limbs[..., 0])
    for i in range(WIDE_LIMBS - 1, 0, -1):
        cur = limbs[..., i] + carry
        carry = _fdiv(cur, _B9)
        outs.append(cur - carry * _B9)
    outs.append(limbs[..., 0] + carry)
    return torch.stack(outs[::-1], dim=-1)


# -- host-side encode/decode --------------------------------------------------

def encode_py(values, capacity: int, limbs: int = 2) -> np.ndarray:
    """Python ints (arbitrary precision) -> (capacity, limbs) limbs."""
    out = np.zeros((capacity, limbs), dtype=np.int64)
    base = BASE if limbs == 2 else _B9
    for i, v in enumerate(values):
        if v is None:
            continue
        rest = int(v)
        for j in range(limbs - 1, 0, -1):
            rest, lo = divmod(rest, base)
            out[i, j] = lo
        out[i, 0] = rest
    return out


def decode_py(limbs: np.ndarray):
    """(n, L) limbs -> list of python ints."""
    arr = np.asarray(limbs, dtype=np.int64)
    base = BASE if arr.shape[-1] == 2 else _B9
    out = []
    for row in arr:
        v = int(row[0])
        for x in row[1:]:
            v = v * base + int(x)
        out.append(v)
    return out


# -- normalization and arithmetic ---------------------------------------------

def normalize(hi: torch.Tensor, lo: torch.Tensor) -> torch.Tensor:
    """Restore the 0 <= lo < BASE invariant; returns stacked (..., 2)."""
    carry = _fdiv(lo, BASE)
    lo = lo - carry * BASE
    hi = hi + carry
    return torch.stack([hi, lo], dim=-1)


def split(d: torch.Tensor):
    return d[..., 0], d[..., 1]


def add(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    if width(a) != 2:
        return _norm_wide(a + b)  # limb sums < 2 * 10^9: no overflow
    return normalize(a[..., 0] + b[..., 0], a[..., 1] + b[..., 1])


def sub(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    if width(a) != 2:
        return _norm_wide(a - b)
    return normalize(a[..., 0] - b[..., 0], a[..., 1] - b[..., 1])


def neg(a: torch.Tensor) -> torch.Tensor:
    if width(a) != 2:
        return _norm_wide(-a)
    return normalize(-a[..., 0], -a[..., 1])


def widen(a: torch.Tensor) -> torch.Tensor:
    """(n, 2) base-10^18 -> (n, 5) base-10^9 (the decimal(38)
    coercion)."""
    ah, al = split(a)
    z = torch.zeros_like(ah)
    h1, h0 = _fdiv(ah, _B9), torch.remainder(ah, _B9)
    l1, l0 = _fdiv(al, _B9), torch.remainder(al, _B9)
    return _norm_wide(torch.stack([z, h1, h0, l1, l0], dim=-1))


def narrow_long(a: torch.Tensor) -> torch.Tensor:
    """(n, 5) wide -> (n, 2) base-10^18: ``hi = l0 * 10^18 + l1 * 10^9
    + l2``, ``lo = l3 * 10^9 + l4`` (canonical; ``hi`` wraps past the
    two-limb range, a narrowing cast's overflow)."""
    hi = (a[..., 0] * _B9 + a[..., 1]) * _B9 + a[..., 2]
    return torch.stack([hi, a[..., 3] * _B9 + a[..., 4]], dim=-1)


def to_int64(a: torch.Tensor) -> torch.Tensor:
    """Wide limbs collapsed to one int64 by Horner's rule, wrapping (the
    reference's ``_narrow_to_int64``: exact where the value fits)."""
    acc = a[..., 0]
    for i in range(1, WIDE_LIMBS):
        acc = acc * _B9 + a[..., i]
    return acc


def from_int64(x: torch.Tensor, limbs: int = 2) -> torch.Tensor:
    """Short (int64) value -> limbs."""
    if limbs != 2:
        cols = [torch.zeros_like(x)] * (limbs - 1) + [x]
        return _norm_wide(torch.stack(cols, dim=-1))
    return normalize(torch.zeros_like(x), x)


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
    ah, al = split(a)
    lh, ll = split(mul_int64(al, k))
    return normalize(ah * k + lh, ll)


def mul_wide_small(a: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """Wide limbs x int64 scaled value (|k| < 10^18) -> wide limbs, over
    a column of ``k`` as over one value: on magnitudes, ``k`` split into
    base-10^9 halves so every limb product stays below 10^18, the high
    half's product shifted up one limb.  Exact while the product fits
    the limbs' 45 digits; past them the high half's top limb drops (the
    wrap ``_shift_digits_wide`` documents).  The reference's version
    broadcasts ``(n, 5)`` limbs against an ``(n,)`` column and raises for
    a column (ROADMAP queue C); this one computes what it documents."""
    neg_a = a[..., 0] < 0
    a_abs = torch.where(neg_a[..., None], _norm_wide(-a), a)
    k = torch.as_tensor(k, dtype=torch.int64, device=a.device)
    neg_k = k < 0
    k_abs = torch.where(neg_k, -k, k)
    k1 = _fdiv(k_abs, _B9)
    k0 = k_abs - k1 * _B9
    lo = _norm_wide(a_abs * k0[..., None])  # limb < 10^9, k0 < 10^9: fits int64
    hi = _norm_wide(a_abs * k1[..., None])
    hi_shift = torch.cat([hi[..., 1:], torch.zeros_like(hi[..., :1])], dim=-1)  # * 10^9
    res = add(hi_shift, lo)
    flip = neg_a ^ neg_k
    return torch.where(flip[..., None], _norm_wide(-res), res)


def mul_small(a: torch.Tensor, k: int) -> torch.Tensor:
    """Two limbs times a small int64 (|k| <= ~4*10^9, a power of ten of
    an up-scale): ``lo`` splits into base-10^9 halves so every partial
    product fits int64; ``hi * k`` wraps as the reference's does."""
    ah, al = split(a)
    l1, l0 = _fdiv(al, _B9), torch.remainder(al, _B9)
    p0, p1 = l0 * k, l1 * k
    c1 = _fdiv(p1, _B9)
    return normalize(ah * k + c1, (p1 - c1 * _B9) * _B9 + p0)


def _shift_digits_wide(a: torch.Tensor, k: int) -> torch.Tensor:
    """A wide vector times 10^k for k in [0, 9), on its magnitude: each
    limb splits at 10^(9-k), the high part carries into the next limb
    up, and the sign comes back at the end.  The most significant limb's
    carry-out drops: past the limbs' 45 digits the magnitude wraps
    modulo 10^45, as the reference's does for a positive value.  The
    reference shifts the signed limbs, so its top carry of a negative
    value is the sign's floor carry and every negative up-scale comes
    out as 10^45 - |a| * 10^k (ROADMAP queue C); this one keeps the
    value its docstring promises."""
    if k == 0:
        return a
    neg_a = a[..., 0] < 0
    a = torch.where(neg_a[..., None], _norm_wide(-a), a)
    m = 10 ** (9 - k)
    high = _fdiv(a, m)
    low = a - high * m
    carried = torch.cat([high[..., 1:], torch.zeros_like(high[..., :1])], dim=-1)
    out = _norm_wide(low * 10 ** k + carried)
    return torch.where(neg_a[..., None], _norm_wide(-out), out)


def _downscale_wide(a: torch.Tensor, k: int) -> torch.Tensor:
    """Floor-divide a wide vector by 10^k (k <= 9): a remainder chain
    over the limbs, most significant first (r < 10^k <= 10^9, so r *
    10^9 + limb < 10^18)."""
    d = 10 ** k
    outs = []
    r = torch.zeros_like(a[..., 0])
    for i in range(WIDE_LIMBS):
        cur = r * _B9 + a[..., i]
        q = _fdiv(cur, d)
        r = cur - q * d
        outs.append(q)
    return _norm_wide(torch.stack(outs, dim=-1))


def upscale(a: torch.Tensor, k: int) -> torch.Tensor:
    """``a * 10^k``: two limbs in steps of at most 10^9 (a result past 36
    digits wraps), wide limbs in steps of at most 10^8 (past 45 digits
    the top carry drops), the reference's ``rescale`` up."""
    if width(a) != 2:
        while k > 0:
            step = min(k, 8)
            a = _shift_digits_wide(a, step)
            k -= step
        return a
    while k > 0:
        step = min(k, 9)
        a = mul_small(a, 10 ** step)
        k -= step
    return a


def downscale_wide(a: torch.Tensor, k: int) -> torch.Tensor:
    """Floor of a wide vector over 10^k, in steps of at most 10^9 (the
    reference's wide ``rescale`` down)."""
    while k > 0:
        step = min(k, 9)
        a = _downscale_wide(a, step)
        k -= step
    return a


def compare(a: torch.Tensor, b: torch.Tensor):
    """``(lt, eq)`` of two limb columns of one width: canonical limbs
    (most significant first, the lower ones non-negative) order as their
    values do."""
    lt = torch.zeros(a.shape[:-1], dtype=torch.bool, device=a.device)
    eq = torch.ones(a.shape[:-1], dtype=torch.bool, device=a.device)
    for i in range(width(a)):
        ai, bi = a[..., i], b[..., i]
        lt = lt | (eq & (ai < bi))
        eq = eq & (ai == bi)
    return lt, eq


def to_double(a: torch.Tensor, scale: int) -> torch.Tensor:
    """The value over 10^scale in float64, one rounding per operation
    (the CUDA interpreter uses the same _rn operations): two limbs as
    ``hi * 10^18 + lo``, wide ones by Horner's rule from limb 0, then one
    true division."""
    if width(a) != 2:
        acc = a[..., 0].to(torch.float64)
        for i in range(1, WIDE_LIMBS):
            acc = acc * float(_B9) + a[..., i].to(torch.float64)
        return div_exact(acc, 10.0 ** scale)
    ah, al = split(a)
    return div_exact(ah.to(torch.float64) * float(BASE) + al.to(torch.float64),
                     10.0 ** scale)


def div_exact(x: torch.Tensor, d: float) -> torch.Tensor:
    """``x / d`` correctly rounded on every device: PyTorch divides a
    CUDA tensor by a Python number as a multiplication by its
    reciprocal, which can differ in the last bit, so the divisor goes
    in as a tensor."""
    return x / torch.tensor(d, dtype=x.dtype, device=x.device)


# -- aggregation support -------------------------------------------------------

def to_sum_limbs(a: torch.Tensor) -> torch.Tensor:
    """(n, 2) base-10^18 -> (n, 4) base-10^9 limbs, safe to sum over
    ~9*10^9 rows without int64 overflow; wide (n, 5) limbs are base
    10^9 already and sum as they are."""
    if width(a) != 2:
        return a
    ah, al = a[..., 0], a[..., 1]
    return torch.stack([_fdiv(ah, _B9), torch.remainder(ah, _B9),
                        _fdiv(al, _B9), torch.remainder(al, _B9)], dim=-1)


def from_sum_limbs(s: torch.Tensor) -> torch.Tensor:
    """Summed base-10^9 limbs normalized: (n, 4) -> (n, 2), or (n, 5)
    -> (n, 5) (``_norm_wide``)."""
    if s.shape[-1] == WIDE_LIMBS:
        return _norm_wide(s)
    h1, h0, l1, l0 = s[..., 0], s[..., 1], s[..., 2], s[..., 3]
    c = _fdiv(l0, _B9)
    l0 = l0 - c * _B9
    l1 = l1 + c
    c = _fdiv(l1, _B9)
    l1 = l1 - c * _B9
    hi_extra = c
    lo = l1 * _B9 + l0
    c = _fdiv(h0, _B9)
    h0 = h0 - c * _B9
    h1 = h1 + c
    hi = h1 * _B9 + h0 + hi_extra
    return normalize(hi, lo)


def avg_wide(s: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    """A wide sum over an int64 count, HALF_UP, by long division over the
    base-10^9 limbs on the magnitude (the reference's
    ``_avg_decimal128`` wide branch: sound for counts below 2^33)."""
    neg_s = s[..., 0] < 0
    a = torch.where(neg_s[..., None], neg(s), s)
    r = torch.zeros_like(n)
    qs = []
    for i in range(WIDE_LIMBS):
        cur = r * _B9 + a[..., i]
        qs.append(_fdiv(cur, n))
        r = cur - qs[-1] * n
    qs[-1] = qs[-1] + (2 * r >= n).to(torch.int64)
    q = _norm_wide(torch.stack(qs, dim=-1))
    return torch.where(neg_s[..., None], neg(q), q)
