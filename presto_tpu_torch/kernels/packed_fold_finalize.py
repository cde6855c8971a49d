"""K3 ``packed_fold_finalize``: fold and finalize packed state tables.

:func:`packed_fold` combines two packed partial tables slot by slot
(the reference's ``combine_packed_states``); :func:`packed_finalize`
turns a folded table into output columns (``finalize_packed`` with the
count/sum/avg/min/max parts of ``_finalize`` and ``_avg_decimal128``;
an integer's avg as a double, ``float64(sum) / float64(count)``; sum0,
never NULL; a long sum collapsed to one int64; a double sum or avg;
the variance finalizes; checksum's sum, never NULL; skewness and
kurtosis; covar_pop, covar_samp, corr, regr_slope and regr_intercept;
a wide decimal's sum, min/max and HALF_UP avg).
The fold adds double sums and merges variance states by Chan's pairwise
update, the central moments by the merge's shift form (as K6's), and
min_by / max_by states by their ``y`` extreme and the greatest ``x``
tied at it.  Both
launch the one kernel of ``csrc/packed_fold_finalize.cu`` on CUDA
tensors and share its launch count; CPU tensors take the plain
versions.
"""

from __future__ import annotations

import ctypes
from typing import Sequence, Tuple

import torch

from presto_tpu_torch.kernels import build
from presto_tpu_torch.ops import decimal128 as d128

MODE_FOLD, MODE_FINALIZE = 0, 1
# fold column kinds: keep in step with csrc/packed_fold_finalize.cu.
# COL_I64 / COL_D128 add; the MIN / MAX kinds keep the lesser or
# greater slot (int64, int32 or two limbs)
COL_I64, COL_D128, COL_MIN_I64, COL_MAX_I64, COL_MIN_I32, COL_MAX_I32, COL_MIN_D128, \
    COL_MAX_D128, COL_F64, COL_VAR_M2, COL_MIN_F64, COL_MAX_F64, COL_MIN_BOOL, COL_MAX_BOOL, \
    COL_BAND, COL_BOR, COL_MOM_M2, COL_MOM_M3, COL_MOM_M4, COL_BY_X, COL_BY_XV, COL_BY_Y_MIN, \
    COL_BY_Y_MAX, COL_D38, COL_MIN_D38, COL_MAX_D38 = range(26)
# COL_D38 adds two wide (five base-10^9 limbs) sums and normalises them
# (``_norm_wide``); COL_MIN_D38 / COL_MAX_D38 keep the lesser or greater
# wide value, limb by limb
# the central moments' state (s, m2, m3, m4, cnt): s COL_F64, then
# COL_MOM_M2, COL_MOM_M3, COL_MOM_M4 (each folded from the whole state,
# the columns either side of it), cnt COL_I64; min_by / max_by's (x, x
# flag, y, count): COL_BY_X, COL_BY_XV, COL_BY_Y_MIN or COL_BY_Y_MAX,
# COL_I64, x and y in their storage (int64, int32, double or bool)
_MOM_COLS = (COL_MOM_M2, COL_MOM_M3, COL_MOM_M4)
_BY_COLS = (COL_BY_X, COL_BY_XV, COL_BY_Y_MIN, COL_BY_Y_MAX)
# COL_MIN_F64 / COL_MAX_F64 keep the lesser or greater double (-0.0
# below 0.0, NaN winning); the BOOL kinds and / or two booleans; BAND /
# BOR and / or two bitwise folds
# COL_F64 adds doubles; COL_VAR_M2 is a variance state's m2 column,
# merged by Chan's pairwise update from its own column, the s column
# just before it and the count column just after it (the state's
# order: s, m2, cnt)
_COL_MIN = (COL_MIN_I64, COL_MIN_I32, COL_MIN_D128, COL_MIN_D38)
_COL_WIDE = (COL_D128, COL_MIN_D128, COL_MAX_D128)
_COL_D38 = (COL_D38, COL_MIN_D38, COL_MAX_D38)
_COL_I32 = (COL_MIN_I32, COL_MAX_I32)
# finalize kinds; a min/max finalizes as FIN_SUM (int64), FIN_SUM_D128
# (limbs) or FIN_VALUE_I32 (int32): its value, NULL where its count is 0
FIN_COUNT, FIN_SUM, FIN_SUM_D128, FIN_AVG_SHORT, FIN_AVG_D128, FIN_AVG_D128_NARROW, \
    FIN_VALUE_I32, FIN_AVG_DOUBLE, FIN_SUM0, FIN_SUM0_D128, FIN_SUM_COLLAPSE, \
    FIN_SUM0_COLLAPSE, FIN_SUM_F64, FIN_AVG_F64, FIN_VAR_POP, FIN_VAR_SAMP, \
    FIN_STDDEV_POP, FIN_STDDEV_SAMP, FIN_VALUE_BOOL, FIN_BOOL_AND, FIN_BOOL_OR, \
    FIN_HLL, FIN_SKEWNESS, FIN_KURTOSIS, FIN_COVAR_POP, FIN_COVAR_SAMP, FIN_CORR, \
    FIN_REGR_SLOPE, FIN_REGR_INTERCEPT, FIN_VALUE, FIN_SUM_D38, FIN_AVG_D38 = range(32)
# FIN_SUM_D38: a wide sum (or min/max), NULL where its count is 0;
# FIN_AVG_D38: a wide sum over its count, HALF_UP (the reference's
# ``_avg_decimal128`` wide branch: long division over the limbs)
_D38_FIN = (FIN_SUM_D38, FIN_AVG_D38)
# FIN_VALUE: a SMALLINT, TINYINT or REAL min/max, its value in its own
# storage (int16, int8, float32)
# the moments' finalizes take (m2, m3, m4) stacked as a (G, 3) double
# column, the covariance family's (sx, sy, sxy, sxx, syy) as (G, 5);
# each with its count
MOMENT_KINDS = (FIN_SKEWNESS, FIN_KURTOSIS)
COVAR_KINDS = (FIN_COVAR_POP, FIN_COVAR_SAMP, FIN_CORR, FIN_REGR_SLOPE, FIN_REGR_INTERCEPT)
STACKED = {**{k: 3 for k in MOMENT_KINDS}, **{k: 5 for k in COVAR_KINDS}}
# FIN_VALUE_BOOL: a boolean min/max; FIN_BOOL_AND / FIN_BOOL_OR take
# (count of true, count); FIN_HLL (sum of 2^-rho, present buckets): the
# HLL estimate of m = HLL_M buckets, never NULL
HLL_M = 4096
_BOOL_OUT = (FIN_VALUE_BOOL, FIN_BOOL_AND, FIN_BOOL_OR)
# FIN_SUM0 / FIN_SUM0_D128: a sum that is 0, never NULL, on an empty
# group; the COLLAPSE kinds narrow a two-limb sum to hi * 10^18 + lo in
# int64 (wrapping); FIN_SUM_F64 / FIN_AVG_F64 take a double sum; the
# variance kinds take (m2, cnt)
_WIDE_IN = (FIN_SUM_D128, FIN_AVG_D128, FIN_AVG_D128_NARROW, FIN_SUM0_D128,
            FIN_SUM_COLLAPSE, FIN_SUM0_COLLAPSE)
_WIDE_OUT = (FIN_SUM_D128, FIN_AVG_D128, FIN_SUM0_D128)
_F64_IN = (FIN_SUM_F64, FIN_AVG_F64, FIN_VAR_POP, FIN_VAR_SAMP, FIN_STDDEV_POP,
           FIN_STDDEV_SAMP, FIN_HLL) + MOMENT_KINDS + COVAR_KINDS
_F64_OUT = tuple(k for k in _F64_IN if k != FIN_HLL) + (FIN_AVG_DOUBLE,)
VARIANCE_KINDS = (FIN_VAR_POP, FIN_VAR_SAMP, FIN_STDDEV_POP, FIN_STDDEV_SAMP)
MAX_ITEMS = 64

launches = 0
#: finalize launches with an avg producing a double
double_avg_launches = 0
#: launches by new kind: folds with a Chan update, finalizes with a
#: sum0, a collapsed long sum, a variance
chan_fold_launches = 0
#: launches holding the eighth slice's kinds, by name ("min_double",
#: "bool", "bitwise", "hll"), and those holding a SMALLINT, TINYINT or
#: REAL column ("narrow")
kind_launches: dict = {}
_KIND_NAMES = {COL_MIN_F64: "min_double", COL_MAX_F64: "min_double",
               COL_MIN_BOOL: "bool", COL_MAX_BOOL: "bool", COL_BAND: "bitwise",
               COL_BOR: "bitwise", COL_MOM_M2: "moments_fold", COL_BY_X: "min_by_fold",
               COL_D38: "d38", COL_MIN_D38: "d38", COL_MAX_D38: "d38"}
_FIN_NAMES = {FIN_VALUE_BOOL: "bool", FIN_BOOL_AND: "bool", FIN_BOOL_OR: "bool",
              FIN_HLL: "hll", FIN_SKEWNESS: "moments", FIN_KURTOSIS: "moments",
              FIN_COVAR_POP: "covariance", FIN_COVAR_SAMP: "covariance",
              FIN_CORR: "covariance", FIN_REGR_SLOPE: "covariance",
              FIN_REGR_INTERCEPT: "covariance", FIN_SUM_D38: "d38", FIN_AVG_D38: "d38"}
# a column's storage, for the kinds that take more than one
# (csrc/packed_fold_finalize.cu ELEM_*)
_ELEM = {torch.int64: 0, torch.int32: 1, torch.float64: 2, torch.bool: 3, torch.int16: 4,
         torch.int8: 5, torch.float32: 6}
# the storages a SMALLINT, TINYINT or REAL min/max state keeps: COL_MIN_I64
# / COL_MAX_I64 take the integer ones, COL_MIN_F64 / COL_MAX_F64 float32
_NARROW_INT = (torch.int16, torch.int8)
sum0_launches = 0
collapse_launches = 0
variance_launches = 0

Column = Tuple[int, torch.Tensor, torch.Tensor]  # (kind, data, valid)


# -- plain versions ------------------------------------------------------------

def chan_m2(s_a, m2a, n_a, s_b, m2b, n_b):
    """Chan's pairwise update of two variance states' m2 (the
    reference's ``combine_packed_states``)."""
    naf, nbf = n_a.to(torch.float64), n_b.to(torch.float64)
    one = torch.ones_like(naf)
    nf = torch.maximum(naf + nbf, one)
    delta = s_b / torch.maximum(nbf, one) - s_a / torch.maximum(naf, one)
    chan = m2a + m2b + delta * delta * naf * nbf / nf
    return torch.where(n_a == 0, m2b, torch.where(n_b == 0, m2a, chan))


_I64_MIN, _I64_MAX = -(1 << 63), (1 << 63) - 1


def moments_fold(sa, m2a, m3a, m4a, n_a, sb, m2b, m3b, m4b, n_b):
    """Two central-moment states (s, m2, m3, m4, cnt) folded: each
    side's ``moment_terms`` about the folded mean, added (the merge's
    form; the reference folds no such pair: its
    ``combine_packed_states`` raises on them)."""
    from presto_tpu_torch.kernels.packed_group_agg import moment_terms

    mu = (sa + sb) / torch.clamp(n_a + n_b, min=1).to(torch.float64)
    ta = moment_terms(sa, m2a, m3a, m4a, n_a, mu)
    tb = moment_terms(sb, m2b, m3b, m4b, n_b, mu)
    return tuple(x + y for x, y in zip(ta, tb))


def by_fold(xa, fa, ya, ca, xb, fb, yb, cb, y_min: bool):
    """Two min_by / max_by states (x, x flag, y, count) folded: the
    extreme of the ``y`` that have rows, then the greatest ``x`` among
    the sides whose ``y`` equals it (as values) with a valid ``x``."""
    from presto_tpu_torch.kernels.packed_group_agg import by_key, by_value

    ident = _I64_MAX if y_min else _I64_MIN
    ka = torch.where(ca > 0, by_key(ya, y_min), ident)
    kb = torch.where(cb > 0, by_key(yb, y_min), ident)
    y = by_value(torch.minimum(ka, kb) if y_min else torch.maximum(ka, kb), y_min, ya.dtype)
    ta = (ca > 0) & (ya == y) & (fa > 0)
    tb = (cb > 0) & (yb == y) & (fb > 0)
    kx = torch.maximum(torch.where(ta, by_key(xa, False), _I64_MIN),
                       torch.where(tb, by_key(xb, False), _I64_MIN))
    return by_value(kx, False, xa.dtype), (ta | tb).to(torch.int64), y, ca + cb


def sqrt_rn(x: torch.Tensor) -> torch.Tensor:
    """The correctly rounded square root, as the kernel's __dsqrt_rn:
    PyTorch's CPU sqrt over large double tensors is not (it may differ
    in the last bit), numpy's is, and so is PyTorch's on a card."""
    if x.is_cuda:
        return torch.sqrt(x)
    import numpy as np

    return torch.from_numpy(np.sqrt(x.numpy()))


def packed_fold_plain(a: Sequence[Column], b: Sequence[Column], mask_a, mask_b):
    out = []
    for c, ((kind, da, va), (_, db, vb)) in enumerate(zip(a, b)):
        if kind in _MOM_COLS:
            first = c - 1 - _MOM_COLS.index(kind)  # the state's s column
            cols_a = [x[1] for x in a[first:first + 5]]
            cols_b = [x[1] for x in b[first:first + 5]]
            data = moments_fold(*cols_a, *cols_b)[_MOM_COLS.index(kind)]
        elif kind in _BY_COLS:
            first = c - _BY_COLS.index(min(kind, COL_BY_Y_MIN))  # the state's x column
            cols_a = [x[1] for x in a[first:first + 4]]
            cols_b = [x[1] for x in b[first:first + 4]]
            folded = by_fold(*cols_a, *cols_b, a[first + 2][0] == COL_BY_Y_MIN)
            data = folded[c - first]
        elif kind == COL_VAR_M2:
            data = chan_m2(a[c - 1][1], da, a[c + 1][1], b[c - 1][1], db, b[c + 1][1])
        elif kind in (COL_D128, COL_D38):
            data = d128.add(da, db)
        elif kind in (COL_MIN_D128, COL_MAX_D128, COL_MIN_D38, COL_MAX_D38):
            a_less, _ = d128.compare(da, db)
            data = torch.where((a_less == (kind in _COL_MIN))[:, None], da, db)
        elif kind in (COL_I64, COL_F64):
            data = da + db
        elif kind in (COL_MIN_F64, COL_MAX_F64):  # a REAL through its exact double
            from presto_tpu_torch.kernels.packed_group_agg import minmax_key, minmax_value

            is_min = kind == COL_MIN_F64
            ka = minmax_key(da.to(torch.float64), is_min)
            kb = minmax_key(db.to(torch.float64), is_min)
            data = minmax_value(torch.minimum(ka, kb) if is_min else torch.maximum(ka, kb),
                                is_min).to(da.dtype)
        elif kind in (COL_MIN_BOOL, COL_BAND):
            data = da & db
        elif kind in (COL_MAX_BOOL, COL_BOR):
            data = da | db
        else:
            data = torch.minimum(da, db) if kind in _COL_MIN else torch.maximum(da, db)
        out.append((data, va | vb))
    return out, mask_a | mask_b


def _avg_decimal128(s: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    """Exact two-limb sum / count with HALF_UP rounding, by long
    division over base-10^6 digits (the reference's algorithm)."""
    neg = s[..., 0] < 0
    a = torch.where(neg[..., None], d128.neg(s), s)
    hi, lo = a[..., 0], a[..., 1]
    m = 1_000_000

    def fdiv(x, y):
        return torch.div(x, y, rounding_mode="floor")

    digits = [fdiv(hi, m * m), torch.remainder(fdiv(hi, m), m), torch.remainder(hi, m),
              fdiv(lo, m * m), torch.remainder(fdiv(lo, m), m), torch.remainder(lo, m)]
    r = torch.zeros_like(n)
    qs = []
    for d in digits:
        cur = r * m + d
        qs.append(fdiv(cur, n))
        r = torch.remainder(cur, n)
    q_hi = (qs[0] * m + qs[1]) * m + qs[2]
    q_lo = (qs[3] * m + qs[4]) * m + qs[5]
    q_lo = q_lo + (2 * r >= n).to(torch.int64)  # HALF_UP
    q = d128.normalize(q_hi, q_lo)
    return torch.where(neg[..., None], d128.neg(q), q)


def packed_finalize_plain(items: Sequence[Tuple[int, torch.Tensor, torch.Tensor]],
                          mask: torch.Tensor):
    out = []
    for kind, s, cnt in items:
        if kind == FIN_COUNT:
            out.append((s.clone(), mask.clone()))
            continue
        valid = (cnt > 0) & mask
        n = torch.clamp(cnt, min=1)
        if kind in MOMENT_KINDS or kind in COVAR_KINDS:
            data, ok = (moments_finalize if kind in MOMENT_KINDS else covar_finalize)(
                kind, s, cnt)
            out.append((data, ok & mask))
            continue
        if kind == FIN_HLL:
            out.append((hll_estimate(s, cnt), mask.clone()))
            continue
        if kind in (FIN_BOOL_AND, FIN_BOOL_OR):
            out.append((s == cnt if kind == FIN_BOOL_AND else s > 0, valid))
            continue
        if kind in (FIN_SUM0, FIN_SUM0_D128, FIN_SUM0_COLLAPSE):
            valid = mask.clone()
        if kind in (FIN_SUM_COLLAPSE, FIN_SUM0_COLLAPSE):
            data = s[..., 0] * (10 ** 18) + s[..., 1]
        elif kind in VARIANCE_KINDS:  # (m2, cnt): max(m2 / n, 0), then the sample form
            nf = n.to(torch.float64)
            pop = m2_over_n = s / nf
            pop = torch.where(m2_over_n > 0, m2_over_n, torch.where(
                torch.isnan(m2_over_n), m2_over_n, torch.zeros_like(m2_over_n)))
            if kind in (FIN_VAR_SAMP, FIN_STDDEV_SAMP):
                one = torch.ones_like(nf)
                data = pop * nf / torch.maximum(nf - one, one)
                valid = (cnt > 1) & mask
            else:
                data = pop
            if kind in (FIN_STDDEV_POP, FIN_STDDEV_SAMP):
                data = sqrt_rn(data)
        elif kind == FIN_AVG_F64:
            data = s / n.to(torch.float64)
        elif kind in (FIN_SUM, FIN_SUM_D128, FIN_VALUE_I32, FIN_SUM0, FIN_SUM0_D128,
                      FIN_SUM_F64, FIN_VALUE_BOOL, FIN_VALUE, FIN_SUM_D38):
            data = s.clone()
        elif kind == FIN_AVG_D38:
            data = d128.avg_wide(s, n)
        elif kind == FIN_AVG_DOUBLE:  # tensor by tensor: a true division on every device
            data = s.to(torch.float64) / n.to(torch.float64)
        elif kind == FIN_AVG_SHORT:
            av = torch.abs(s)
            sign = torch.where(s < 0, -1, 1)
            q = torch.div(av, n, rounding_mode="floor")
            q = q + (2 * (av - q * n) >= n).to(torch.int64)
            data = sign * q
        else:
            data = _avg_decimal128(s, n)
            if kind == FIN_AVG_D128_NARROW:
                data = data[..., 0] * (10 ** 18) + data[..., 1]
        out.append((data, valid))
    return out


def _nan_max0(x: torch.Tensor) -> torch.Tensor:
    """max(x, 0.0) that keeps a NaN (jnp.maximum's rule)."""
    return torch.where((x > 0) | torch.isnan(x), x, torch.zeros_like(x))


def moments_finalize(kind: int, s: torch.Tensor, cnt: torch.Tensor):
    """skewness (sqrt(n) M3 / M2^1.5, valid from 3 rows) or the unbiased
    excess kurtosis (valid from 4 rows), NULL where M2 is 0 (the
    reference's ``_finalize`` :1480), from (m2, m3, m4) and the count."""
    m2, m3, m4 = s[:, 0], s[:, 1], s[:, 2]
    nf = torch.clamp(cnt, min=1).to(torch.float64)
    one = torch.ones_like(nf)
    safe = torch.where(m2 == 0, one, m2)
    if kind == FIN_SKEWNESS:
        return sqrt_rn(nf) * m3 / torch.pow(safe, 1.5), (cnt >= 3) & (m2 > 0)
    d1 = nf - one
    d2 = torch.maximum(nf - 2.0, one)
    d3 = torch.maximum(nf - 3.0, one)
    three = torch.full_like(nf, 3.0)
    v = nf * (nf + one) * d1 / (d2 * d3) * (m4 / (safe * safe)) - three * d1 * d1 / (d2 * d3)
    return v, (cnt >= 4) & (m2 > 0)


def covar_finalize(kind: int, s: torch.Tensor, cnt: torch.Tensor):
    """The covariance family from (sx, sy, sxy, sxx, syy) and the count
    (the reference's ``_finalize`` :1447), each division by a tensor."""
    sx, sy, sxy, sxx, syy = s.unbind(1)
    nf = torch.clamp(cnt, min=1).to(torch.float64)
    one = torch.ones_like(nf)
    mx, my = sx / nf, sy / nf
    cov = sxy / nf - mx * my
    varx = _nan_max0(sxx / nf - mx * mx)
    vary = _nan_max0(syy / nf - my * my)
    if kind == FIN_COVAR_POP:
        return cov, cnt > 0
    if kind == FIN_COVAR_SAMP:
        return cov * nf / torch.maximum(nf - one, one), cnt > 1
    if kind == FIN_CORR:
        denom = sqrt_rn(varx * vary)
        return cov / torch.where(denom == 0, one, denom), (cnt > 1) & (denom > 0)
    slope = cov / torch.where(varx == 0, one, varx)
    ok = (cnt > 1) & (varx > 0)
    if kind == FIN_REGR_SLOPE:
        return slope, ok
    return my - slope * mx, ok


def hll_estimate(s: torch.Tensor, present: torch.Tensor) -> torch.Tensor:
    """hll_merge's estimator over (sum of 2^-rho, present buckets): the
    raw HLL estimate, or linear counting below 2.5 m while a bucket is
    empty; rounded half to even (the reference's ``_finalize``).  Each
    step multiplies or divides two tensors, as the kernel's _rn
    intrinsics do."""
    m = float(HLL_M)
    alpha = 0.7213 / (1.0 + 1.079 / m)
    mt = torch.full_like(s, m)
    zeros = mt - present.to(torch.float64)
    s_full = s + zeros
    raw = (torch.full_like(s, alpha) * mt) * mt / torch.clamp(s_full, min=1e-12)
    lc = mt * torch.log(mt / torch.clamp(zeros, min=1.0))
    est = torch.where((raw <= 2.5 * m) & (zeros > 0), lc, raw)
    return torch.round(est).to(torch.int64)


# -- dispatch ------------------------------------------------------------------

def packed_fold(a: Sequence[Column], b: Sequence[Column], mask_a: torch.Tensor,
                mask_b: torch.Tensor):
    """Fold two packed tables: ``([(data, valid)...], mask)``."""
    if not mask_a.is_cuda:
        return packed_fold_plain(a, b, mask_a, mask_b)
    g = mask_a.shape[0]
    tensors = [mask_a, mask_b]
    outs = []
    kinds = [k for k, _, _ in a]
    for c, kind in enumerate(kinds):  # the moments' and min_by's column runs
        if kind == COL_MOM_M2 and kinds[c - 1:c + 4] != [COL_F64, COL_MOM_M2, COL_MOM_M3,
                                                         COL_MOM_M4, COL_I64] or \
                kind == COL_BY_X and (kinds[c + 1:c + 2] != [COL_BY_XV] or kinds[c + 2:c + 4]
                                      not in ([COL_BY_Y_MIN, COL_I64], [COL_BY_Y_MAX, COL_I64])):
            raise ValueError("packed_fold: a moments or min_by state's columns are out of order")
        if kind in (COL_MOM_M3, COL_MOM_M4) and kinds[c - 1] != kind - 1 or \
                kind == COL_BY_XV and kinds[c - 1:c] != [COL_BY_X] or \
                kind in (COL_BY_Y_MIN, COL_BY_Y_MAX) and kinds[c - 2:c - 1] != [COL_BY_X]:
            raise ValueError("packed_fold: a moments or min_by state's columns are out of order")
    for c, ((kind, da, va), (kb, db, vb)) in enumerate(zip(a, b)):
        if not COL_I64 <= kind <= COL_MAX_D38:
            raise ValueError(f"packed_fold: column kind {kind}")
        shape = (g, 2) if kind in _COL_WIDE else (g, 5) if kind in _COL_D38 else (g,)
        dtype = torch.int32 if kind in _COL_I32 else torch.float64 \
            if kind in (COL_F64, COL_VAR_M2, COL_MIN_F64, COL_MAX_F64) + _MOM_COLS \
            else torch.bool if kind in (COL_MIN_BOOL, COL_MAX_BOOL) else da.dtype \
            if kind in (COL_BY_X, COL_BY_Y_MIN, COL_BY_Y_MAX) else torch.int64
        if kind in (COL_MIN_F64, COL_MAX_F64) and da.dtype == torch.float32 or \
                kind in (COL_MIN_I64, COL_MAX_I64) and da.dtype in _NARROW_INT:
            dtype = da.dtype  # a REAL, SMALLINT or TINYINT extreme
        if kind == COL_VAR_M2 and not (0 < c < len(a) - 1 and a[c - 1][0] == COL_F64
                                       and a[c + 1][0] == COL_I64):
            raise ValueError("packed_fold: a variance m2 column needs its s and count "
                             "columns beside it")
        if kb != kind or da.shape != shape or db.shape != shape \
                or da.dtype != dtype or db.dtype != dtype \
                or kind in _COL_D38 and not (da.is_contiguous() and db.is_contiguous()):
            raise ValueError("packed_fold: mismatched state columns")
        tensors += [da, db, va, vb]
        outs.append((torch.empty(shape, dtype=dtype, device=da.device),
                     torch.empty(g, dtype=torch.bool, device=da.device)))
    mask_out = torch.empty(g, dtype=torch.bool, device=mask_a.device)
    _launch(MODE_FOLD, g, [c[0] for c in a], [c[1] for c in a], [c[1] for c in b],
            [c[2] for c in a], [c[2] for c in b], outs, mask_a, mask_b, mask_out, tensors,
            [_ELEM.get(c[1].dtype, 0) for c in a])
    global chan_fold_launches
    chan_fold_launches += int(any(c[0] == COL_VAR_M2 for c in a))
    _count_kinds(_KIND_NAMES, [c[0] for c in a])
    _count_narrow([c[1] for c in a])
    return outs, mask_out


def _count_kinds(names, kinds) -> None:
    for name in {names[k] for k in kinds if k in names}:
        kind_launches[name] = kind_launches.get(name, 0) + 1


def _count_narrow(columns) -> None:
    """Count a launch holding a SMALLINT, TINYINT or REAL column."""
    if any(c.dtype in _NARROW_INT + (torch.float32,) for c in columns):
        kind_launches["narrow"] = kind_launches.get("narrow", 0) + 1


def packed_finalize(items: Sequence[Tuple[int, torch.Tensor, torch.Tensor]],
                    mask: torch.Tensor):
    """Finalize aggregates ``(kind, sum or count, count)`` of a packed
    table with row mask ``mask``: ``[(data, valid)...]``."""
    if not mask.is_cuda:
        return packed_finalize_plain(items, mask)
    g = mask.shape[0]
    tensors = [mask]
    outs = []
    for kind, s, cnt in items:
        if not FIN_COUNT <= kind <= FIN_AVG_D38:
            raise ValueError(f"packed_finalize: kind {kind}")
        in_shape = (g, 2) if kind in _WIDE_IN else (g, 5) if kind in _D38_FIN else \
            (g, STACKED[kind]) if kind in STACKED else (g,)
        dtype = torch.int32 if kind == FIN_VALUE_I32 else torch.float64 \
            if kind in _F64_IN else torch.bool if kind == FIN_VALUE_BOOL else torch.int64
        if kind == FIN_VALUE:
            dtype = s.dtype if s.dtype in _NARROW_INT + (torch.float32,) else None
        if s.shape != in_shape or cnt.shape != (g,) or not s.is_contiguous() \
                or s.dtype != dtype or cnt.dtype != torch.int64:
            raise ValueError("packed_finalize: mismatched state columns")
        tensors += [s, cnt]
        out_shape = (g, 2) if kind in _WIDE_OUT else (g, 5) if kind in _D38_FIN else (g,)
        out_dtype = torch.float64 if kind in _F64_OUT else \
            torch.int32 if kind == FIN_VALUE_I32 else torch.bool if kind in _BOOL_OUT \
            else s.dtype if kind == FIN_VALUE else torch.int64
        outs.append((torch.empty(out_shape, dtype=out_dtype, device=mask.device),
                     torch.empty(g, dtype=torch.bool, device=mask.device)))
    _launch(MODE_FINALIZE, g, [k for k, _, _ in items], [s for _, s, _ in items],
            [c for _, _, c in items], None, None, outs, mask, None, None, tensors,
            [_ELEM.get(s.dtype, 0) for _, s, _ in items])
    global double_avg_launches, sum0_launches, collapse_launches, variance_launches
    kinds = {k for k, _, _ in items}
    double_avg_launches += int(FIN_AVG_DOUBLE in kinds)
    sum0_launches += int(bool(kinds & {FIN_SUM0, FIN_SUM0_D128, FIN_SUM0_COLLAPSE}))
    collapse_launches += int(bool(kinds & {FIN_SUM_COLLAPSE, FIN_SUM0_COLLAPSE}))
    variance_launches += int(bool(kinds & set(VARIANCE_KINDS)))
    _count_kinds(_FIN_NAMES, kinds)
    _count_narrow([s for _, s, _ in items])
    return outs


def _launch(mode, g, kinds, in0, in1, in2, in3, outs, mask_a, mask_b, mask_out, tensors,
            elems=None):
    global launches
    if len(kinds) > MAX_ITEMS:
        raise ValueError("packed_fold_finalize: too many columns")
    build.require_cuda(tensors, "packed_fold_finalize")

    def p(ts):
        return build.ptrs(t.data_ptr() for t in ts) if ts is not None \
            else build.ptrs([0] * len(kinds))

    c_kind = build.ints(kinds)
    c_in0, c_in1, c_in2, c_in3 = p(in0), p(in1), p(in2), p(in3)
    c_out0, c_out1 = p([o[0] for o in outs]), p([o[1] for o in outs])
    c_elem = build.ints(elems if elems is not None else [0] * len(kinds))
    fn = build.library().k3_packed_fold_finalize
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_int, ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
    err = fn(mode, g, len(kinds), c_kind, c_in0, c_in1, c_in2, c_in3, c_out0, c_out1, c_elem,
             mask_a.data_ptr(), mask_b.data_ptr() if mask_b is not None else None,
             mask_out.data_ptr() if mask_out is not None else None,
             build.stream_of(mask_a))
    build.check(err, "packed_fold_finalize")
    launches += 1
