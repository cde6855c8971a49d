"""Grouped aggregation: the global, packed-direct and sort paths.

Counterpart of ``presto_tpu/ops/aggregate.py``.  The type-level helpers
(``state_types``, ``output_type``, ``_sum_type``, ``_agg_dict``) are
copies the binder and planner use.  The device work runs on three
kernels: K2 ``packed_group_agg`` computes the partial states of a page
(global, or grouped by an exact packed key whose domain product fits
``DIRECT_GROUP_LIMIT``); K3 ``packed_fold_finalize`` folds two partial
tables slot by slot and finalizes states; K6 ``sorted_group_agg``
groups by an exact packed key too large for a direct table, or by a
key hashed by K9 when a key column has no exact domain (the sort
path), and merges partial states (``merge_aggregate``, which hashes
the partials' key columns again, so equal groups from different splits
meet).  The sort path emits every group it sees, in key order (packed
or hashed, as the reference's), whatever ``max_groups`` says; a
presorted (streaming) grouping runs K6 in page order with no sort and
emits groups in first-appearance order.  count, sum, sum0, avg, min and
max (over int32/int64 lanes and long decimals) are ported, avg of an
integer producing a double (K3's finalize), sum and avg over doubles,
a long sum collapsed to a short decimal (the outer half of the
mixed-DISTINCT rewrite), and the variance family (stddev, stddev_samp,
stddev_pop, variance, var_samp, var_pop) over the state ``(s, m2,
cnt)``.  Double states add in one fixed order, the same on the card
and on the CPU (see K2's and K6's twins); K2 adds them only for the
global aggregate, and a keyed grouping with a double state takes the
sort path (``takes_sort_path``).  min/max over doubles and varchar,
DISTINCT and FILTER raise :class:`NotPorted`.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from presto_tpu_torch import NotPorted
from presto_tpu_torch.expr.compile import ExprCompiler, expr_dictionary
from presto_tpu_torch.expr.ir import AggCall, Call, ColumnRef, Expr
from presto_tpu_torch.kernels import packed_fold_finalize as k3
from presto_tpu_torch.kernels import packed_group_agg as k2
from presto_tpu_torch.kernels import sorted_group_agg as k6
from presto_tpu_torch.page import Block, Page, _torch_dtype
from presto_tpu_torch.types import BIGINT, DOUBLE, VARCHAR, DecimalType, Type

AggSpec = AggCall  # public alias

DIRECT_GROUP_LIMIT = 1 << 14

# static per-group element capacity of array_agg and the class-count
# cap of learn_classifier: the state types below name them
ARRAY_AGG_CAP = 64
ML_MAX_CLASSES = 8


# ---------------------------------------------------------------------------
# agg state machinery
# ---------------------------------------------------------------------------

# max short-decimal argument precision whose sum may accumulate in a
# plain int64 lane: 10^15 * ~9.2e3 max rows-per-... — conservatively,
# |addend| <= 10^15 leaves four orders of magnitude of headroom below
# 2^63 (~9.2e18), i.e. the fold stays exact past 9000x the largest
# tier-1 table; p=16..18 addends (every decimal arith product types as
# p=18) can cross 2^63 at realistic SF100 row counts and widen to
# two-limb decimal128 accumulation instead
SUM_SHORT_SAFE_PRECISION = 15


def _sum_type(t: Type) -> Type:
    if t.is_decimal:
        if (t.precision or 0) > 36:
            return DecimalType(38, t.scale)
        if t.is_long_decimal or (t.precision or 0) > SUM_SHORT_SAFE_PRECISION:
            return DecimalType(36, t.scale)
        return DecimalType(18, t.scale)
    if t.name.startswith("interval"):
        return t  # interval sums stay interval (Interval*SumAggregation)
    if t.name in ("double", "real"):
        return DOUBLE  # REAL accumulates in double (reference parity)
    return BIGINT  # tinyint/smallint/integer/bigint widen to bigint


VARIANCE_FNS = ("stddev", "stddev_samp", "stddev_pop", "variance", "var_samp", "var_pop")
# higher central moments (CentralMomentsAggregation: skewness/kurtosis)
MOMENT_FNS = ("skewness", "kurtosis")
# bitwise folds (BitwiseAndAggregation / BitwiseOrAggregation)
BITWISE_FNS = ("bitwise_and_agg", "bitwise_or_agg")

# two-argument moment statistics (AggregationUtils covariance/corr/
# regression states): fn(y, x) with state (sx, sy, sxy, sxx, syy, n)
COVAR_FNS = ("covar_pop", "covar_samp", "corr", "regr_slope", "regr_intercept")


def state_types(agg: AggCall) -> List[Type]:
    """Column types of this aggregate's partial state."""
    if agg.fn == "count_star" or agg.fn == "count":
        return [BIGINT]
    t = agg.arg.type
    if agg.fn in ("sum", "sum0"):
        return [_sum_type(t), BIGINT]
    if agg.fn == "avg":
        return [_sum_type(t), BIGINT]
    if agg.fn in ("min", "max"):
        return [t, BIGINT]
    if agg.fn in VARIANCE_FNS:
        return [DOUBLE, DOUBLE, BIGINT]  # sum, M2 (Σ(x-mean)²), count
    if agg.fn in MOMENT_FNS:
        return [DOUBLE, DOUBLE, DOUBLE, DOUBLE, BIGINT]  # s, M2, M3, M4, n
    if agg.fn in BITWISE_FNS:
        return [BIGINT, BIGINT]  # folded value, count of non-null
    if agg.fn in ("bool_and", "bool_or", "every"):
        return [BIGINT, BIGINT]  # count of true, count of non-null
    if agg.fn in COVAR_FNS:
        return [DOUBLE, DOUBLE, DOUBLE, DOUBLE, DOUBLE, BIGINT]
    if agg.fn == "checksum":
        return [BIGINT]
    if agg.fn in ("min_by", "max_by"):
        # x-at-extreme, x-non-null flag, extreme key, count of valid keys
        return [t, BIGINT, agg.arg2.type, BIGINT]
    if agg.fn == "hll_merge":
        # HyperLogLog register fold: Σ 2^-M over present buckets, count
        # of present buckets (input rows are one-per-(group, bucket))
        return [DOUBLE, BIGINT]
    if agg.fn == "array_agg":
        from presto_tpu_torch.types import ArrayType

        return [ArrayType(t, ARRAY_AGG_CAP), BIGINT]
    if agg.fn in ("map_agg", "multimap_agg"):
        from presto_tpu_torch.types import MapType

        return [MapType(t, agg.arg2.type, ARRAY_AGG_CAP), BIGINT]
    if agg.fn == "map_union":
        from presto_tpu_torch.types import MapType

        return [MapType(t.key_element, t.element, ARRAY_AGG_CAP), BIGINT]
    if agg.fn in ("max_n", "min_n"):
        from presto_tpu_torch.types import ArrayType

        return [ArrayType(t, int(agg.arg2.value)), BIGINT]
    if agg.fn in ("max_by_n", "min_by_n"):
        # two value halves sharing one storage dtype: the map state
        # geometry [len, xs.., ys..] with ys = the ordering keys, so
        # partial states merge exactly (top-n is a semilattice)
        from presto_tpu_torch.types import MapType

        return [MapType(t, agg.arg2.type, int(agg.arg3.value)), BIGINT]
    if agg.fn == "hll_sketch":
        from presto_tpu_torch.types import HllType

        return [HllType(), BIGINT]
    if agg.fn in ("make_set_digest", "merge_set_digest"):
        from presto_tpu_torch.types import SetDigestType

        return [SetDigestType(), BIGINT]
    if agg.fn == "learn_regressor":
        # normal-equation sufficient statistics: flattened upper
        # triangle-free full XtX (dim*dim) + Xty (dim), dim = k+1 bias
        from presto_tpu_torch.types import ArrayType

        dim = agg.arg2.type.max_elems + 1
        return [ArrayType(DOUBLE, dim * dim + dim), BIGINT]
    if agg.fn == "learn_classifier":
        # per class: count, sum x_j, sum x_j^2  (Gaussian NB stats)
        from presto_tpu_torch.types import ArrayType

        k = agg.arg2.type.max_elems
        return [ArrayType(DOUBLE, ML_MAX_CLASSES * (1 + 2 * k)), BIGINT]
    if agg.fn == "evaluate_classifier_predictions":
        # per class: [tp, fp, fn] counts (presto-ml
        # EvaluateClassifierPredictionsAggregation state maps)
        from presto_tpu_torch.types import ArrayType

        return [ArrayType(BIGINT, 3 * ML_MAX_CLASSES), BIGINT]
    raise KeyError(f"unknown aggregate {agg.fn}")


def output_type(agg: AggCall) -> Type:
    if agg.fn in ("count", "count_star", "hll_merge", "approx_distinct"):
        return BIGINT
    if agg.fn == "approx_set":
        from presto_tpu_torch.types import HllType

        return HllType()  # rewritten to the two-level sketch pipeline
    if agg.fn == "merge":
        return agg.arg.type  # hll in, hll out (rewritten before exec)
    if agg.fn == "array_agg":
        from presto_tpu_torch.types import ArrayType

        return ArrayType(agg.arg.type, ARRAY_AGG_CAP)
    if agg.fn == "map_agg":
        from presto_tpu_torch.types import MapType

        return MapType(agg.arg.type, agg.arg2.type, ARRAY_AGG_CAP)
    if agg.fn == "hll_sketch":
        from presto_tpu_torch.types import HllType

        return HllType()
    if agg.fn in ("make_set_digest", "merge_set_digest"):
        from presto_tpu_torch.types import SetDigestType

        return SetDigestType()
    if agg.fn == "evaluate_classifier_predictions":
        # VARCHAR summary; the numeric state travels through the jitted
        # pipeline and LocalRunner formats it host-side at the end
        return VARCHAR
    if agg.fn == "multimap_agg":
        from presto_tpu_torch.types import ArrayType, MapType

        vt = agg.arg2.type
        if not vt.is_array:  # pre-rewrite: second arg is the scalar v
            vt = ArrayType(vt, ARRAY_AGG_CAP)
        return MapType(agg.arg.type, vt, ARRAY_AGG_CAP)
    if agg.fn == "map_union":
        from presto_tpu_torch.types import MapType

        t = agg.arg.type
        return MapType(t.key_element, t.element, ARRAY_AGG_CAP)
    if agg.fn in ("max_n", "min_n"):
        from presto_tpu_torch.types import ArrayType

        return ArrayType(agg.arg.type, int(agg.arg2.value))
    if agg.fn in ("max_by_n", "min_by_n"):
        from presto_tpu_torch.types import ArrayType

        return ArrayType(agg.arg.type, int(agg.arg3.value))
    if agg.fn == "histogram":
        # rewritten to inner count + outer map_agg before execution
        from presto_tpu_torch.types import MapType

        return MapType(agg.arg.type, BIGINT, ARRAY_AGG_CAP)
    if agg.fn == "numeric_histogram":
        # rewritten to window-span bins + map_agg before execution;
        # the map width is the shared container cap so the rewrite's
        # map_agg state layout and this declared type agree
        from presto_tpu_torch.types import MapType

        return MapType(DOUBLE, DOUBLE, ARRAY_AGG_CAP)
    if agg.fn == "learn_regressor":
        from presto_tpu_torch.types import ArrayType

        return ArrayType(DOUBLE, agg.arg2.type.max_elems + 1)
    if agg.fn == "learn_classifier":
        from presto_tpu_torch.types import ArrayType

        k = agg.arg2.type.max_elems
        return ArrayType(DOUBLE, 1 + ML_MAX_CLASSES * (1 + 2 * k))
    if agg.fn in ("sum", "sum0"):
        return _sum_type(agg.arg.type)
    if agg.fn == "avg":
        if agg.arg.type.is_decimal:
            # reference parity: avg(decimal(p,s)) keeps the input type,
            # rounded HALF_UP at scale s (DecimalAverageAggregation)
            return agg.arg.type
        if agg.arg.type.name.startswith("interval"):
            return agg.arg.type  # Interval*AverageAggregation
        return DOUBLE
    if agg.fn in VARIANCE_FNS or agg.fn in COVAR_FNS or agg.fn in MOMENT_FNS:
        return DOUBLE
    if agg.fn in BITWISE_FNS:
        return BIGINT
    if agg.fn == "checksum":
        return BIGINT
    if agg.fn in ("bool_and", "bool_or", "every"):
        from presto_tpu_torch.types import BOOLEAN

        return BOOLEAN
    return agg.arg.type  # min/max/min_by/max_by/approx_percentile: x's type



def _agg_dict(agg: AggCall, dictionaries) -> Optional[object]:
    """Dictionary carried through value-preserving aggregates
    (min/max/min_by/max_by of a VARCHAR argument)."""
    if agg.fn not in ("min", "max", "min_by", "max_by", "array_agg"):
        return None
    if agg.arg is None or not agg.arg.type.is_string:
        return None
    from presto_tpu_torch.expr.compile import expr_dictionary

    return expr_dictionary(agg.arg, dictionaries)



def _has_double_state(aggs) -> bool:
    return any(a.fn in VARIANCE_FNS or (a.fn in ("sum", "sum0", "avg") and a.arg is not None
                                        and _sum_type(a.arg.type).name == "double")
               for a in aggs)


def packed_direct_layout(group_exprs, key_domains, max_groups: int) -> bool:
    """The packed-direct layout's key condition (part of
    :func:`takes_sort_path`): exact scalar key domains whose product
    fits the direct-address budget.  Raw
    byte-matrix and multi-dim keys pack inexactly (pack_or_hash_keys
    returns exact=False for them), so they are excluded here too."""
    if not group_exprs or not key_domains \
            or any(d is None for d in key_domains):
        return False
    for e in group_exprs:
        t = getattr(e, "type", None)
        if t is None or t.is_raw_string or t.is_binary \
                or t.value_shape != ():
            return False
    prod = 1
    for lo, hi in key_domains:
        prod *= hi - lo + 2
    return prod <= min(max_groups, DIRECT_GROUP_LIMIT)


def takes_sort_path(group_exprs, key_domains, max_groups: int, aggs,
                    presorted: bool = False) -> bool:
    """Whether a grouping runs on the sort path (K6) rather than in K2's
    packed-direct slots: presorted input, keys past the packed-direct
    layout, or a double state (sum, avg or variance of a double), which
    K2 adds only for the global aggregate, so that every keyed double
    sum has one order, K6's."""
    return bool(group_exprs) and (presorted or _has_double_state(aggs) or not
                                  packed_direct_layout(group_exprs, key_domains, max_groups))


# ---------------------------------------------------------------------------
# host tables
# ---------------------------------------------------------------------------

# id(dict) -> (dict, rank list, inv list); host lists, turned into
# tensors on the device that asks (kept per device in _COLLATION_LUTS)
_COLLATION_CACHE: dict = {}
# (id(dict), device) -> (dict, rank tensor, inv tensor)
_COLLATION_LUTS: dict = {}


def _collation_lists(d):
    cached = _COLLATION_CACHE.get(id(d))
    if cached is None:
        values = list(d.values)
        order = sorted(range(len(values)), key=lambda i: values[i])
        rank = [0] * len(values)
        inv = [0] * len(values)
        prev = None
        r = 0
        for pos, i in enumerate(order):
            if values[i] != prev:
                r = pos
                prev = values[i]
                inv[r] = i
            rank[i] = r
        cached = (d, rank, inv)
        _COLLATION_CACHE[id(d)] = cached
    return cached


def _collation_luts(d, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """(code -> collation rank, rank -> representative code) LUTs: codes
    are assignment-ordered, so string order goes through ranks.  Built
    once per dictionary and device (a derived dictionary can hold
    millions of values)."""
    key = (id(d), str(device))
    hit = _COLLATION_LUTS.get(key)
    if hit is None:
        _, rank, inv = _collation_lists(d)
        hit = _COLLATION_LUTS[key] = (d, torch.tensor(rank, dtype=torch.int32, device=device),
                                      torch.tensor(inv, dtype=torch.int32, device=device))
    return hit[1], hit[2]


def expr_key_dicts(page: Page, exprs) -> list:
    """Dictionary provenance per key expression (None for non-string)."""
    dicts = [b.dictionary for b in page.blocks]
    return [expr_dictionary(e, dicts) if e.type.is_string else None for e in exprs]


# ---------------------------------------------------------------------------
# kernel descriptors
# ---------------------------------------------------------------------------

def _state_kind(agg: AggCall) -> int:
    """K2 kind of an aggregate's partial state."""
    if agg.distinct or agg.filter is not None:
        raise NotPorted("DISTINCT and FILTER aggregates")
    if agg.fn == "count_star":
        return k2.COUNT_STAR
    if agg.fn == "count":
        return k2.COUNT
    if agg.fn in ("sum", "sum0", "avg"):
        t = agg.arg.type
        st = _sum_type(t)
        if t.name == "double":
            return k2.SUM_DOUBLE
        if t.is_long_decimal and t.value_shape == (2,):
            return k2.SUM_LONG_ARG
        if t.is_long_decimal or t.value_shape != () or st.name in ("double", "real"):
            raise NotPorted(f"{agg.fn} over {t}")
        return k2.SUM_LONG if st.is_long_decimal else k2.SUM_SHORT
    if agg.fn in VARIANCE_FNS:
        t = agg.arg.type
        if t.value_shape != () and not (t.is_long_decimal and t.value_shape == (2,)) \
                or t.is_string or t.name in ("real", "boolean"):
            raise NotPorted(f"{agg.fn} over {t}")
        return k2.VARIANCE
    if agg.fn in ("min", "max"):
        t = agg.arg.type
        if t.is_long_decimal and t.value_shape == (2,):
            return k2.MIN_LONG if agg.fn == "min" else k2.MAX_LONG
        if t.is_string or t.value_shape != () or t.name in ("double", "real", "boolean") \
                or np.dtype(t.np_dtype) not in (np.dtype(np.int32), np.dtype(np.int64)):
            raise NotPorted(f"{agg.fn} over {t}")
        return k2.MIN_SHORT if agg.fn == "min" else k2.MAX_SHORT
    raise NotPorted(f"aggregate {agg.fn}")


def _finalize_kind(agg: AggCall) -> int:
    """K3 finalize kind of an aggregate (after :func:`_state_kind`)."""
    if agg.fn in ("count", "count_star"):
        return k3.FIN_COUNT
    if agg.fn in ("min", "max"):  # the state's value, NULL where its count is 0
        t = agg.arg.type
        if t.is_long_decimal:
            return k3.FIN_SUM_D128
        return k3.FIN_VALUE_I32 if np.dtype(t.np_dtype) == np.dtype(np.int32) else k3.FIN_SUM
    if agg.fn in VARIANCE_FNS:
        return _VARIANCE_FIN[agg.fn]
    st = _sum_type(agg.arg.type)
    t = output_type(agg)
    if agg.fn in ("sum", "sum0"):
        zero = agg.fn == "sum0"
        if st.name == "double":
            if zero:
                raise NotPorted("sum0 over double")
            return k3.FIN_SUM_F64
        if st.is_long_decimal and agg.type.is_decimal and not agg.type.is_long_decimal:
            # the outer half of a decomposed sum: limbs back to one int64
            return k3.FIN_SUM0_COLLAPSE if zero else k3.FIN_SUM_COLLAPSE
        if st.is_long_decimal:
            return k3.FIN_SUM0_D128 if zero else k3.FIN_SUM_D128
        return k3.FIN_SUM0 if zero else k3.FIN_SUM
    if st.name == "double":
        return k3.FIN_AVG_F64
    if t.is_decimal and st.is_long_decimal:
        return k3.FIN_AVG_D128 if t.is_long_decimal else k3.FIN_AVG_D128_NARROW
    if t.is_decimal or t.name.startswith("interval"):
        return k3.FIN_AVG_SHORT
    if t.name == "double" and st.name == "bigint":  # an integer's mean
        return k3.FIN_AVG_DOUBLE
    raise NotPorted(f"avg producing {t}")


_VARIANCE_FIN = {"stddev": k3.FIN_STDDEV_SAMP, "stddev_samp": k3.FIN_STDDEV_SAMP,
                 "stddev_pop": k3.FIN_STDDEV_POP, "variance": k3.FIN_VAR_SAMP,
                 "var_samp": k3.FIN_VAR_SAMP, "var_pop": k3.FIN_VAR_POP}


def _check_ported(aggs: Sequence[AggCall], mode: str) -> List[int]:
    kinds = [_state_kind(a) for a in aggs]
    if mode == "single":
        for a in aggs:
            _finalize_kind(a)
    return kinds


# ---------------------------------------------------------------------------
# grouped aggregation
# ---------------------------------------------------------------------------

def grouped_aggregate(
    page: Page,
    group_exprs: Sequence[Expr],
    aggs: Sequence[AggCall],
    max_groups: int,
    key_domains: Optional[Sequence[Optional[Tuple[int, int]]]] = None,
    mode: str = "single",
    presorted: bool = False,
) -> Page:
    """Aggregate ``page`` by ``group_exprs``: the reference's global
    branch (no keys: one group), streaming branch (``presorted``: equal
    keys arrive together; one row per run of equal keys, in page
    order), packed-direct branch (group id == packed key, output
    capacity ``max_groups``) and sort path (one row per group the page
    holds, in key order, however many ``max_groups`` expects).
    mode='single' emits finalized values, 'partial' the state
    columns."""
    _check_ported(aggs, mode)
    if takes_sort_path(group_exprs, key_domains, max_groups, aggs, presorted):
        return _sorted_aggregate(page, group_exprs, aggs, key_domains, mode, presorted)
    keys, args = kernel_inputs(page, group_exprs, aggs, key_domains)
    agg_dicts = [_agg_dict(a, [b.dictionary for b in page.blocks]) for a in aggs]
    n = page.capacity
    if not group_exprs:
        states, _ = k2.packed_group_agg(n, page.row_mask, [], args, 1)
        out_mask = torch.ones(1, dtype=torch.bool, device=page.device)
        return _emit([], states, aggs, out_mask, mode, agg_dicts)
    states, present = k2.packed_group_agg(n, page.row_mask, keys, args, max_groups)
    cards = [card for _, _, _, card in keys]
    key_blocks = _unpack_key_blocks(cards, key_domains, group_exprs,
                                    expr_key_dicts(page, group_exprs), int(np.prod(cards)),
                                    max_groups, page.device)
    return _emit(key_blocks, states, aggs, present, mode, agg_dicts)


def kernel_inputs(page: Page, group_exprs: Sequence[Expr], aggs: Sequence[AggCall],
                  key_domains) -> Tuple[List[k2.Key], List[k2.Agg]]:
    """The K2 inputs of a page: packed-key columns ``(data, valid, lo,
    card)`` and aggregate arguments ``(kind, data, valid)``, evaluated
    by K1 where they are expressions."""
    c = ExprCompiler.for_page(page)
    args = []
    for agg in aggs:
        kind = _state_kind(agg)
        if kind == k2.COUNT_STAR:
            args.append((kind, None, None))
        else:
            arg = agg.arg
            if kind == k2.VARIANCE and arg.type.name != "double":
                arg = Call(type=DOUBLE, fn="cast_double", args=(arg,))  # _to_double
            d, v = c.compile(arg)(page)
            args.append((kind, d, v))
    from presto_tpu_torch.ops.join import key_columns

    return key_columns(page, group_exprs, key_domains), args


def _states_out(groups: int, key_blocks, state_cols, per_agg, aggs, mode, agg_dicts,
                device) -> Page:
    """The page of a sort-path grouping: ``per_agg`` slices the flat
    K6 state columns back into each aggregate's ``[sum, count]`` or
    ``[count]``."""
    states, pos = [], 0
    for k in per_agg:
        states.append(state_cols[pos:pos + k])
        pos += k
    mask = torch.ones(groups, dtype=torch.bool, device=device)
    return _emit(key_blocks, states, aggs, mask, mode, agg_dicts)


def sorted_inputs(page: Page, group_exprs, aggs, key_domains):
    """The K6 inputs of a sort-path grouping: key columns (exact, or
    hashed without exact domains), the flat state list, and how many
    states each aggregate has."""
    keys, args = kernel_inputs(page, group_exprs, aggs, key_domains)
    states, per_agg = [], []
    for kind, data, valid in args:
        if kind == k2.COUNT_STAR:
            states.append((k6.S_ONE, None, None))
        elif kind == k2.COUNT:
            states.append((k6.S_VALID, None, valid))
        elif kind in k2.EXTREMES:
            states.append((_K6_EXTREME[kind], data, valid))
            states.append((k6.S_VALID, None, valid))
        elif kind == k2.VARIANCE:  # (s, m2, cnt)
            states.append((k6.S_VAR, data, valid))
        else:
            states.append((_K6_SUM[kind], data, valid))
            states.append((k6.S_VALID, None, valid))
        per_agg.append(1 if kind in (k2.COUNT_STAR, k2.COUNT) else
                       3 if kind == k2.VARIANCE else 2)
    return keys, states, per_agg


_K6_SUM = {k2.SUM_SHORT: k6.S_SUM, k2.SUM_LONG: k6.S_LIMBS_SHORT,
           k2.SUM_LONG_ARG: k6.S_LIMBS_LONG, k2.SUM_DOUBLE: k6.S_DSUM}
_K6_EXTREME = {k2.MIN_SHORT: k6.S_MIN, k2.MAX_SHORT: k6.S_MAX, k2.MIN_LONG: k6.S_MIN_LONG,
               k2.MAX_LONG: k6.S_MAX_LONG}


def _sorted_aggregate(page: Page, group_exprs, aggs, key_domains, mode,
                      presorted: bool = False) -> Page:
    """The reference's sort path over K6: every group the page holds,
    in packed-key order; or its streaming branch (``presorted``), in
    page order."""
    keys, states, per_agg = sorted_inputs(page, group_exprs, aggs, key_domains)
    key_out, cols, groups = k6.sorted_group_agg(keys, page.row_mask, states, presorted)
    if groups == 0:
        return _empty_groups(group_exprs, aggs, mode, page.device,
                             expr_key_dicts(page, group_exprs))
    agg_dicts = [_agg_dict(a, [b.dictionary for b in page.blocks]) for a in aggs]
    key_blocks = [Block(d, v, e.type, dic) for (d, v), e, dic in
                  zip(key_out, group_exprs, expr_key_dicts(page, group_exprs))]
    return _states_out(groups, key_blocks, cols, per_agg, aggs, mode, agg_dicts,
                       page.device)


def _empty_groups(group_exprs, aggs, mode, device, key_dicts) -> Page:
    """A page of no group that keeps the key columns' dictionaries, so
    a concatenation of partials whose first split had no live row
    still decodes its keys."""
    types = [e.type for e in group_exprs]
    for a in aggs:
        types += state_types(a) if mode == "partial" else [output_type(a)]
    page = Page.empty(types, 1, device)
    blocks = [Block(b.data, b.valid, b.type, d) for b, d in zip(page.blocks, key_dicts)]
    return Page(tuple(blocks) + page.blocks[len(blocks):], page.row_mask)


def merge_inputs(partial: Page, num_keys: int, aggs, key_domains):
    """The K6 inputs of merging partial states: packed-key columns,
    the flat state list (the reference's ``_merge_states`` for count,
    sum, avg, min, max and the variance family: counts and sums add over
    live rows, a long sum only where its count is positive, a min/max
    reduces the states whose count is positive, variance states merge
    by Chan's form), and states per aggregate."""
    from presto_tpu_torch.ops.join import key_tuples

    if num_keys == 0:
        raise NotPorted("merging global partial states")
    key_blocks = partial.blocks[:num_keys]  # codes already canonical
    keys = key_tuples([(b.data, b.valid) for b in key_blocks],
                      [b.type for b in key_blocks], key_domains)
    live = partial.row_mask
    states, per_agg = [], []
    for agg, cols in zip(aggs, _slice_state_cols(partial, num_keys, aggs)):
        if agg.fn in ("count", "count_star"):
            states.append((k6.S_SUM, cols[0].data, live))
        elif agg.fn in ("min", "max"):
            states.append((_K6_EXTREME[_state_kind(agg)], cols[0].data, cols[1].data > 0))
            states.append((k6.S_SUM, cols[1].data, live))
        elif agg.fn in VARIANCE_FNS:  # Chan's form over k partials
            states.append((k6.S_VAR_MERGE, tuple(c.data for c in cols), live))
        elif cols[0].type.name == "double":
            states.append((k6.S_DSUM, cols[0].data, live))
            states.append((k6.S_SUM, cols[1].data, live))
        elif cols[0].type.is_long_decimal:
            states.append((k6.S_LIMBS_LONG, cols[0].data, cols[1].data > 0))
            states.append((k6.S_SUM, cols[1].data, live))
        else:
            states.append((k6.S_SUM, cols[0].data, live))
            states.append((k6.S_SUM, cols[1].data, live))
        per_agg.append(len(cols))
    return keys, states, per_agg


def merge_aggregate(partial: Page, num_keys: int, aggs: Sequence[AggCall], max_groups: int,
                    key_domains: Optional[Sequence[Optional[Tuple[int, int]]]] = None,
                    mode: str = "single") -> Page:
    """Final aggregation over a page of partial states (group keys in
    the first ``num_keys`` blocks, then state columns in
    ``state_types`` order), on K6.  Every group is emitted, in
    packed-key order."""
    _check_ported(aggs, mode)
    keys, states, per_agg = merge_inputs(partial, num_keys, aggs, key_domains)
    key_out, cols, groups = k6.sorted_group_agg(keys, partial.row_mask, states)
    key_blocks_in = partial.blocks[:num_keys]
    if groups == 0:
        return _empty_groups([ColumnRef(type=b.type, index=i)
                              for i, b in enumerate(key_blocks_in)], aggs, mode,
                             partial.device, [b.dictionary for b in key_blocks_in])
    agg_dicts = [c[0].dictionary for c in _slice_state_cols(partial, num_keys, aggs)]
    key_blocks = [Block(d, v, b.type, b.dictionary)
                  for (d, v), b in zip(key_out, key_blocks_in)]
    return _states_out(groups, key_blocks, cols, per_agg, aggs, mode, agg_dicts,
                       partial.device)


def _unpack_key_blocks(cards, domains, group_exprs, key_dicts, prod, capacity,
                       device) -> List[Block]:
    gids = torch.arange(capacity, dtype=torch.int64, device=device)
    in_range = gids < prod
    blocks = []
    stride = prod
    for card, (lo, _), e, dic in zip(cards, domains, group_exprs, key_dicts):
        stride //= card
        code = torch.remainder(torch.div(gids, stride, rounding_mode="floor"), card)
        data = (code - 1 + lo).to(_torch_dtype(e.type))
        blocks.append(Block(data, (code > 0) & in_range, e.type, dic))
    return blocks


def _emit(key_blocks, states, aggs, out_mask, mode, agg_dicts) -> Page:
    if mode == "partial":
        blocks = list(key_blocks)
        for agg, cols, adict in zip(aggs, states, agg_dicts):
            for j, (t, col) in enumerate(zip(state_types(agg), cols)):
                blocks.append(Block(col, out_mask, t, adict if j == 0 else None))
        return Page(tuple(blocks), out_mask)
    return Page(tuple(key_blocks) + tuple(_finalize(states, aggs, agg_dicts, out_mask)),
                out_mask)


def _slice_state_cols(page: Page, num_keys: int, aggs):
    """State blocks per aggregate, in ``state_types`` order."""
    cols: List[List[Block]] = []
    pos = num_keys
    for agg in aggs:
        k = len(state_types(agg))
        cols.append(list(page.blocks[pos:pos + k]))
        pos += k
    return cols


def _finalize(states, aggs, agg_dicts, mask) -> List[Block]:
    items = []
    for agg, cols in zip(aggs, states):
        kind = _finalize_kind(agg)
        # a variance finalizes from (m2, cnt); every other from (state, cnt)
        items.append((kind, cols[1] if kind in k3.VARIANCE_KINDS else cols[0], cols[-1]))
    out = k3.packed_finalize(items, mask)
    # a collapsed long sum keeps the plan's short type, as the reference
    return [Block(d, v, agg.type if kind in (k3.FIN_SUM_COLLAPSE, k3.FIN_SUM0_COLLAPSE)
                  else output_type(agg), adict)
            for (d, v), agg, adict, (kind, _, _) in zip(out, aggs, agg_dicts, items)]


def combine_packed_states(a: Page, b: Page, num_keys: int,
                          aggs: Sequence[AggCall]) -> Page:
    """Fold two packed-direct partial pages slot by slot (K3)."""
    _check_ported(aggs, "partial")
    sa = [blk for cols in _slice_state_cols(a, num_keys, aggs) for blk in cols]
    sb = [blk for cols in _slice_state_cols(b, num_keys, aggs) for blk in cols]
    kinds = []
    for agg in aggs:
        for j, t in enumerate(state_types(agg)):
            if agg.fn in VARIANCE_FNS:
                kinds.append((k3.COL_F64, k3.COL_VAR_M2, k3.COL_I64)[j])
            elif t.name == "double":
                kinds.append(k3.COL_F64)
            elif agg.fn in ("min", "max") and j == 0:
                wide = "d128" if t.is_long_decimal else (
                    "i32" if np.dtype(t.np_dtype) == np.dtype(np.int32) else "i64")
                kinds.append(_K3_EXTREME[agg.fn, wide])
            else:
                kinds.append(k3.COL_D128 if t.is_long_decimal else k3.COL_I64)

    outs, mask = k3.packed_fold([(k, x.data, x.valid) for k, x in zip(kinds, sa)],
                                [(k, x.data, x.valid) for k, x in zip(kinds, sb)],
                                a.row_mask, b.row_mask)
    blocks = list(a.blocks[:num_keys])
    for blk, (data, valid) in zip(sa, outs):
        blocks.append(Block(data, valid, blk.type, blk.dictionary))
    return Page(tuple(blocks), mask)


_K3_EXTREME = {("min", "i64"): k3.COL_MIN_I64, ("max", "i64"): k3.COL_MAX_I64,
               ("min", "i32"): k3.COL_MIN_I32, ("max", "i32"): k3.COL_MAX_I32,
               ("min", "d128"): k3.COL_MIN_D128, ("max", "d128"): k3.COL_MAX_D128}


def finalize_packed(acc: Page, num_keys: int, aggs: Sequence[AggCall]) -> Page:
    """mode='single' finalize of a packed-direct accumulator: slots
    already hold one group each (K3)."""
    _check_ported(aggs, "single")
    states = [[b.data for b in cols] for cols in _slice_state_cols(acc, num_keys, aggs)]
    agg_dicts = [cols[0].dictionary for cols in _slice_state_cols(acc, num_keys, aggs)]
    agg_blocks = _finalize(states, aggs, agg_dicts, acc.row_mask)
    return Page(tuple(acc.blocks[:num_keys]) + tuple(agg_blocks), acc.row_mask)
