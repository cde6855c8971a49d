"""K3 ``packed_fold_finalize``: fold and finalize packed state tables.

:func:`packed_fold` combines two packed partial tables slot by slot
(the reference's ``combine_packed_states``); :func:`packed_finalize`
turns a folded table into output columns (``finalize_packed`` with the
count/sum/avg/min/max parts of ``_finalize`` and ``_avg_decimal128``;
an integer's avg as a double, ``float64(sum) / float64(count)``; sum0,
never NULL; a long sum collapsed to one int64; a double sum or avg;
the variance finalizes).  The fold adds double sums and merges
variance states by Chan's pairwise update.  Both
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
    COL_MAX_D128, COL_F64, COL_VAR_M2 = range(10)
# COL_F64 adds doubles; COL_VAR_M2 is a variance state's m2 column,
# merged by Chan's pairwise update from its own column, the s column
# just before it and the count column just after it (the state's
# order: s, m2, cnt)
_COL_MIN = (COL_MIN_I64, COL_MIN_I32, COL_MIN_D128)
_COL_WIDE = (COL_D128, COL_MIN_D128, COL_MAX_D128)
_COL_I32 = (COL_MIN_I32, COL_MAX_I32)
# finalize kinds; a min/max finalizes as FIN_SUM (int64), FIN_SUM_D128
# (limbs) or FIN_VALUE_I32 (int32): its value, NULL where its count is 0
FIN_COUNT, FIN_SUM, FIN_SUM_D128, FIN_AVG_SHORT, FIN_AVG_D128, FIN_AVG_D128_NARROW, \
    FIN_VALUE_I32, FIN_AVG_DOUBLE, FIN_SUM0, FIN_SUM0_D128, FIN_SUM_COLLAPSE, \
    FIN_SUM0_COLLAPSE, FIN_SUM_F64, FIN_AVG_F64, FIN_VAR_POP, FIN_VAR_SAMP, \
    FIN_STDDEV_POP, FIN_STDDEV_SAMP = range(18)
# FIN_SUM0 / FIN_SUM0_D128: a sum that is 0, never NULL, on an empty
# group; the COLLAPSE kinds narrow a two-limb sum to hi * 10^18 + lo in
# int64 (wrapping); FIN_SUM_F64 / FIN_AVG_F64 take a double sum; the
# variance kinds take (m2, cnt)
_WIDE_IN = (FIN_SUM_D128, FIN_AVG_D128, FIN_AVG_D128_NARROW, FIN_SUM0_D128,
            FIN_SUM_COLLAPSE, FIN_SUM0_COLLAPSE)
_WIDE_OUT = (FIN_SUM_D128, FIN_AVG_D128, FIN_SUM0_D128)
_F64_IN = (FIN_SUM_F64, FIN_AVG_F64, FIN_VAR_POP, FIN_VAR_SAMP, FIN_STDDEV_POP,
           FIN_STDDEV_SAMP)
_F64_OUT = _F64_IN + (FIN_AVG_DOUBLE,)
VARIANCE_KINDS = (FIN_VAR_POP, FIN_VAR_SAMP, FIN_STDDEV_POP, FIN_STDDEV_SAMP)
MAX_ITEMS = 64

launches = 0
#: finalize launches with an avg producing a double
double_avg_launches = 0
#: launches by new kind: folds with a Chan update, finalizes with a
#: sum0, a collapsed long sum, a variance
chan_fold_launches = 0
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
        if kind == COL_VAR_M2:
            data = chan_m2(a[c - 1][1], da, a[c + 1][1], b[c - 1][1], db, b[c + 1][1])
        elif kind == COL_D128:
            data = d128.add(da, db)
        elif kind in (COL_MIN_D128, COL_MAX_D128):
            a_less, _ = d128.compare(da, db)
            data = torch.where((a_less == (kind == COL_MIN_D128))[:, None], da, db)
        elif kind in (COL_I64, COL_F64):
            data = da + db
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
                      FIN_SUM_F64):
            data = s.clone()
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


# -- dispatch ------------------------------------------------------------------

def packed_fold(a: Sequence[Column], b: Sequence[Column], mask_a: torch.Tensor,
                mask_b: torch.Tensor):
    """Fold two packed tables: ``([(data, valid)...], mask)``."""
    if not mask_a.is_cuda:
        return packed_fold_plain(a, b, mask_a, mask_b)
    g = mask_a.shape[0]
    tensors = [mask_a, mask_b]
    outs = []
    for c, ((kind, da, va), (kb, db, vb)) in enumerate(zip(a, b)):
        shape = (g, 2) if kind in _COL_WIDE else (g,)
        dtype = torch.int32 if kind in _COL_I32 else torch.float64 \
            if kind in (COL_F64, COL_VAR_M2) else torch.int64
        if kind == COL_VAR_M2 and not (0 < c < len(a) - 1 and a[c - 1][0] == COL_F64
                                       and a[c + 1][0] == COL_I64):
            raise ValueError("packed_fold: a variance m2 column needs its s and count "
                             "columns beside it")
        if kb != kind or da.shape != shape or db.shape != shape \
                or da.dtype != dtype or db.dtype != dtype:
            raise ValueError("packed_fold: mismatched state columns")
        tensors += [da, db, va, vb]
        outs.append((torch.empty(shape, dtype=dtype, device=da.device),
                     torch.empty(g, dtype=torch.bool, device=da.device)))
    mask_out = torch.empty(g, dtype=torch.bool, device=mask_a.device)
    _launch(MODE_FOLD, g, [c[0] for c in a], [c[1] for c in a], [c[1] for c in b],
            [c[2] for c in a], [c[2] for c in b], outs, mask_a, mask_b, mask_out, tensors)
    global chan_fold_launches
    chan_fold_launches += int(any(c[0] == COL_VAR_M2 for c in a))
    return outs, mask_out


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
        if not FIN_COUNT <= kind <= FIN_STDDEV_SAMP:
            raise ValueError(f"packed_finalize: kind {kind}")
        wide_in = kind in _WIDE_IN
        dtype = torch.int32 if kind == FIN_VALUE_I32 else torch.float64 \
            if kind in _F64_IN else torch.int64
        if s.shape != ((g, 2) if wide_in else (g,)) or cnt.shape != (g,) \
                or s.dtype != dtype or cnt.dtype != torch.int64:
            raise ValueError("packed_finalize: mismatched state columns")
        tensors += [s, cnt]
        wide_out = kind in _WIDE_OUT
        out_dtype = torch.float64 if kind in _F64_OUT else \
            torch.int32 if kind == FIN_VALUE_I32 else torch.int64
        outs.append((torch.empty((g, 2) if wide_out else (g,), dtype=out_dtype,
                                 device=mask.device),
                     torch.empty(g, dtype=torch.bool, device=mask.device)))
    _launch(MODE_FINALIZE, g, [k for k, _, _ in items], [s for _, s, _ in items],
            [c for _, _, c in items], None, None, outs, mask, None, None, tensors)
    global double_avg_launches, sum0_launches, collapse_launches, variance_launches
    kinds = {k for k, _, _ in items}
    double_avg_launches += int(FIN_AVG_DOUBLE in kinds)
    sum0_launches += int(bool(kinds & {FIN_SUM0, FIN_SUM0_D128, FIN_SUM0_COLLAPSE}))
    collapse_launches += int(bool(kinds & {FIN_SUM_COLLAPSE, FIN_SUM0_COLLAPSE}))
    variance_launches += int(bool(kinds & set(VARIANCE_KINDS)))
    return outs


def _launch(mode, g, kinds, in0, in1, in2, in3, outs, mask_a, mask_b, mask_out, tensors):
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
    fn = build.library().k3_packed_fold_finalize
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_int, ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
    err = fn(mode, g, len(kinds), c_kind, c_in0, c_in1, c_in2, c_in3, c_out0, c_out1,
             mask_a.data_ptr(), mask_b.data_ptr() if mask_b is not None else None,
             mask_out.data_ptr() if mask_out is not None else None,
             build.stream_of(mask_a))
    build.check(err, "packed_fold_finalize")
    launches += 1
