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
sort path (``takes_sort_path``).  The eighth slice adds min/max (and
``arbitrary``, which the binder maps to max) over doubles (an order key:
-0.0 below 0.0, NaN winning), booleans and dictionary varchar (over the
argument dictionary's collation ranks, mapped back to a code of that
dictionary at finalize by K1's CANON), bool_and / bool_or / every,
bitwise_and_agg / bitwise_or_agg, and hll_merge (approx_distinct's outer
level, a double state like a double sum); and an aggregate's FILTER
(``count_if``): K1 evaluates the filter beside the argument into one
lane, the argument NULL where the filter is not true, so the kernels'
per-aggregate validity lane is the selection lane.  DISTINCT aggregates
(which the binder rewrites) raise :class:`NotPorted`.

The coupled and statistical aggregates: ``checksum`` (K1 hashes each
row by splitmix64, a double by its bits, a NULL to the reference's
constant; the kernels add the hashes, wrapping), ``skewness`` and
``kurtosis`` (the central moments ``(s, m2, m3, m4, cnt)``, two-pass
per partial, Chan's form across partials), the covariance family
(``covar_pop``, ``covar_samp``, ``corr``, ``regr_slope``,
``regr_intercept``: K1 computes the lanes ``x``, ``y``, ``x*y``, ``x*x``
and ``y*y`` over the rows where both are valid, and the kernels take
their fixed-order double sums beside one count) and ``min_by`` /
``max_by`` (the extreme of ``y``, a varchar by its collation rank, then
the greatest ``x`` among the rows tied at it; a varchar ``x`` stays a
code of its dictionary).  Moments and covariance are double states, so
a keyed grouping with one takes the sort path.

array_agg and map_agg (the tenth slice) keep a ``(groups, 1 + 64)`` or
``(groups, 1 + 2 * 64)`` state matrix beside a count: K14
``group_collect`` writes each group's rows in their order along K6's
stable runs (or the page's one run for the global aggregate), NULL
values as the sentinel, map_agg's NULL keys left out; partials merge at
running offsets in split order (K14's merge, over K6's runs of the
partial keys, or the global fold's two rows), capped at 64.  A keyed
grouping with one takes the sort path.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from presto_tpu_torch import NotPorted
from presto_tpu_torch.expr.compile import ExprCompiler, _Lowering, _lane, _out_kind, \
    expr_dictionary
from presto_tpu_torch.expr.ir import AggCall, Call, ColumnRef, Expr, Literal
from presto_tpu_torch.kernels import expr_eval as k1
from presto_tpu_torch.kernels import group_collect as k14
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

# the element-collecting aggregates (K14 group_collect): array_agg keeps
# every row, NULL values as the sentinel; map_agg the rows whose key is
# not NULL
COLLECT_FNS = ("array_agg", "map_agg")

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
    return any(a.fn in VARIANCE_FNS or a.fn in MOMENT_FNS or a.fn in COVAR_FNS
               or a.fn == "hll_merge"
               or (a.fn in ("sum", "sum0", "avg") and a.arg is not None
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
    layout, a double state (sum, avg or variance of a double), which
    K2 adds only for the global aggregate, so that every keyed double
    sum has one order, K6's; or array_agg / map_agg, whose elements K14
    collects along K6's runs."""
    return bool(group_exprs) and (presorted or _has_double_state(aggs) or _collects(aggs)
                                  or not packed_direct_layout(group_exprs, key_domains,
                                                              max_groups))


def _collects(aggs) -> bool:
    return any(a.fn in COLLECT_FNS for a in aggs)


# ---------------------------------------------------------------------------
# host tables
# ---------------------------------------------------------------------------

# id(dict) -> (dict, rank list, inv list); host lists, turned into K1
# tables (each with its copy per device) by rank_luts
_COLLATION_CACHE: dict = {}


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


# id(dict) -> (dict, rank Lut, inv Lut): K1's CANON tables of a
# dictionary's collation (code -> rank, rank -> representative code)
_RANK_LUTS: dict = {}


def rank_luts(d) -> Tuple[k1.Lut, k1.Lut]:
    """K1 tables of ``d``'s collation: code -> rank (min/max over varchar
    reduce ranks, the reference's ``rank_lut``) and rank -> a code of
    that value (the finalize's ``inv_lut``)."""
    hit = _RANK_LUTS.get(id(d))
    if hit is None:
        _, rank, inv = _collation_lists(d)
        hit = _RANK_LUTS[id(d)] = (d, k1.Lut(rank, torch.int32, "collation"),
                                   k1.Lut(inv, torch.int32, "collation"))
    return hit[1], hit[2]


def _collation_luts(d, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """(code -> collation rank, rank -> representative code) LUTs: codes
    are assignment-ordered, so string order goes through ranks.  Built
    once per dictionary and device (a derived dictionary can hold
    millions of values)."""
    rank, inv = rank_luts(d)
    return rank.on(device), inv.on(device)


def expr_key_dicts(page: Page, exprs) -> list:
    """Dictionary provenance per key expression (None for non-string)."""
    dicts = [b.dictionary for b in page.blocks]
    return [expr_dictionary(e, dicts) if e.type.is_string else None for e in exprs]


# ---------------------------------------------------------------------------
# kernel descriptors
# ---------------------------------------------------------------------------

def _state_kind(agg: AggCall) -> int:
    """K2 kind of an aggregate's partial state.  A filtered count_star
    counts the rows its filter selects (COUNT over the filter lane)."""
    if agg.distinct:
        raise NotPorted("DISTINCT aggregates")
    if agg.filter is not None and agg.arg is not None and not agg.arg.type.is_string \
            and _lane(agg.arg.type) == "long":
        raise NotPorted(f"FILTER over {agg.arg.type}")
    if agg.fn == "count_star":
        return k2.COUNT_STAR if agg.filter is None else k2.COUNT
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
        is_min = agg.fn == "min"
        if t.is_long_decimal and t.value_shape == (2,):
            return k2.MIN_LONG if is_min else k2.MAX_LONG
        if t.name == "double":
            return k2.MIN_DOUBLE if is_min else k2.MAX_DOUBLE
        if t.is_raw_string or t.value_shape != () or t.name == "real" or not (
                t.is_string or t.name == "boolean"
                or np.dtype(t.np_dtype) in (np.dtype(np.int32), np.dtype(np.int64))):
            raise NotPorted(f"{agg.fn} over {t}")
        return k2.MIN_SHORT if is_min else k2.MAX_SHORT  # varchar: over collation ranks
    if agg.fn in ("bool_and", "bool_or", "every"):
        return k2.BOOL_COUNT
    if agg.fn in BITWISE_FNS:
        t = agg.arg.type
        if t.is_decimal or t.value_shape != () or t.is_string or t.name in ("double", "real"):
            raise NotPorted(f"{agg.fn} over {t}")
        return k2.BIT_AND if agg.fn == "bitwise_and_agg" else k2.BIT_OR
    if agg.fn == "hll_merge":
        return k2.HLL_SUM
    if agg.fn == "checksum":
        t = agg.arg.type
        if t.value_shape != () or t.is_raw_string or t.is_long_decimal:
            raise NotPorted(f"checksum over {t}")
        return k2.CHECKSUM
    if agg.fn in MOMENT_FNS or agg.fn in COVAR_FNS:
        for t in (agg.arg.type, agg.arg2.type if agg.fn in COVAR_FNS else agg.arg.type):
            if t.value_shape != () and not (t.is_long_decimal and t.value_shape == (2,)) \
                    or t.is_string or t.name in ("real", "boolean", "date", "timestamp"):
                raise NotPorted(f"{agg.fn} over {t}")
        return k2.MOMENTS if agg.fn in MOMENT_FNS else k2.SUM_DOUBLE
    if agg.fn in ("min_by", "max_by"):
        for t in (agg.arg.type, agg.arg2.type):
            if t.value_shape != () or t.is_raw_string or t.name == "real":
                raise NotPorted(f"{agg.fn} over {t}")
        return k2.BY_X
    if agg.fn in COLLECT_FNS:
        if agg.filter is not None:
            raise NotPorted(f"FILTER over {agg.fn}")
        for t in (agg.arg.type,) + ((agg.arg2.type,) if agg.fn == "map_agg" else ()):
            if t.value_shape != () or t.is_raw_string:
                raise NotPorted(f"{agg.fn} over {t}")
        # the state's count: every row (array_agg) or the non-NULL keys
        return k2.COUNT_STAR if agg.fn == "array_agg" else k2.COUNT
    raise NotPorted(f"aggregate {agg.fn}")


def _finalize_kind(agg: AggCall) -> int:
    """K3 finalize kind of an aggregate (after :func:`_state_kind`); a
    collecting aggregate's count finalizes as a sum, whose validity
    (``count > 0``) is its state matrix's."""
    if agg.fn in COLLECT_FNS:
        return k3.FIN_SUM
    if agg.fn in ("count", "count_star"):
        return k3.FIN_COUNT
    if agg.fn in ("min", "max"):  # the state's value, NULL where its count is 0
        t = agg.arg.type
        if t.is_long_decimal:
            return k3.FIN_SUM_D128
        if t.name == "double":
            return k3.FIN_SUM_F64
        if t.name == "boolean":
            return k3.FIN_VALUE_BOOL
        if t.is_string:  # collation ranks (int32), mapped back to codes in _finalize
            return k3.FIN_VALUE_I32
        return k3.FIN_VALUE_I32 if np.dtype(t.np_dtype) == np.dtype(np.int32) else k3.FIN_SUM
    if agg.fn in ("bool_and", "every"):
        return k3.FIN_BOOL_AND
    if agg.fn == "bool_or":
        return k3.FIN_BOOL_OR
    if agg.fn in BITWISE_FNS:  # the fold, NULL where no row was valid
        return k3.FIN_SUM
    if agg.fn == "hll_merge":
        return k3.FIN_HLL
    if agg.fn in VARIANCE_FNS:
        return _VARIANCE_FIN[agg.fn]
    if agg.fn == "checksum":  # the sum, never NULL
        return k3.FIN_COUNT
    if agg.fn in MOMENT_FNS or agg.fn in COVAR_FNS:
        return _TAIL_FIN[agg.fn]
    if agg.fn in ("min_by", "max_by"):  # x, NULL where no valid x tied the extreme
        t = agg.arg.type
        if t.name == "double":
            return k3.FIN_SUM_F64
        if t.name == "boolean":
            return k3.FIN_VALUE_BOOL
        return k3.FIN_VALUE_I32 if np.dtype(t.np_dtype) == np.dtype(np.int32) else k3.FIN_SUM
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


_TAIL_FIN = {"skewness": k3.FIN_SKEWNESS, "kurtosis": k3.FIN_KURTOSIS,
             "covar_pop": k3.FIN_COVAR_POP, "covar_samp": k3.FIN_COVAR_SAMP,
             "corr": k3.FIN_CORR, "regr_slope": k3.FIN_REGR_SLOPE,
             "regr_intercept": k3.FIN_REGR_INTERCEPT}
# checksum's hash of a NULL row (the reference's 0x9E3779B97F4A7C15 as
# a signed int64)
CHECKSUM_NULL = 0x9E3779B97F4A7C15 - (1 << 64)

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
        states = _agg_states(aggs, states)
        if _collects(aggs):  # the page's one run, in page order
            starts = torch.tensor([0, n], dtype=torch.int64, device=page.device)
            _add_collected(states, aggs, page, None, starts)
        return _emit([], states, aggs, out_mask, mode, agg_dicts)
    states, present = k2.packed_group_agg(n, page.row_mask, keys, args, max_groups)
    states = _agg_states(aggs, states)
    cards = [card for _, _, _, card in keys]
    key_blocks = _unpack_key_blocks(cards, key_domains, group_exprs,
                                    expr_key_dicts(page, group_exprs), int(np.prod(cards)),
                                    max_groups, page.device)
    return _emit(key_blocks, states, aggs, present, mode, agg_dicts)


def kernel_inputs(page: Page, group_exprs: Sequence[Expr], aggs: Sequence[AggCall],
                  key_domains) -> Tuple[List[k2.Key], List[k2.Agg]]:
    """The K2 inputs of a page: packed-key columns ``(data, valid, lo,
    card)`` and aggregate arguments ``(kind, data, valid)``, evaluated
    by K1 where they are expressions; an aggregate takes one entry, a
    covariance five (``_covar_lanes``) and a min_by / max_by two (BY_X,
    then BY_Y_MIN or BY_Y_MAX)."""
    c = ExprCompiler.for_page(page)
    dicts = [b.dictionary for b in page.blocks]
    args = []
    for agg in aggs:
        kind = _state_kind(agg)
        if agg.fn in COVAR_FNS:
            args += [(k2.SUM_DOUBLE, d, v) for d, v in _covar_lanes(c, agg, page)]
            continue
        if agg.fn in ("min_by", "max_by"):
            args += _by_entries(c, dicts, agg, page)
            continue
        if kind == k2.CHECKSUM:
            args.append((kind,) + _argument_lane(c, agg.arg, agg.filter, None,
                                                 _checksum_hash)(page))
            continue
        if kind == k2.COUNT_STAR:
            args.append((kind, None, None))
            continue
        if agg.fn == "map_agg":  # a count of the non-NULL keys
            args.append((kind,) + c.compile(agg.arg)(page))
            continue
        arg = agg.arg
        if kind in (k2.VARIANCE, k2.MOMENTS) and arg.type.name != "double":
            arg = Call(type=DOUBLE, fn="cast_double", args=(arg,))  # _to_double
        rank = None
        if agg.fn in ("min", "max") and arg.type.is_string:
            adict = _agg_dict(agg, dicts)
            if adict is None:
                raise NotPorted(f"{agg.fn} over a string without a dictionary")
            rank = rank_luts(adict)[0]
        if agg.filter is None and rank is None:
            d, v = c.compile(arg)(page)
        else:
            d, v = _argument_lane(c, arg, agg.filter, rank)(page)
        args.append((kind, d, v))
    from presto_tpu_torch.ops.join import key_columns

    return key_columns(page, group_exprs, key_domains), args


def _collect_inputs(c: ExprCompiler, agg: AggCall, page: Page):
    """(selected rows, lanes) of a collecting aggregate: array_agg's
    value over every live row, map_agg's key and value over the live
    rows whose key is not NULL."""
    if agg.fn == "array_agg":
        return page.row_mask, [c.compile(agg.arg)(page)]
    kd, kv = c.compile(agg.arg)(page)
    return page.row_mask & kv, [(kd, kv), c.compile(agg.arg2)(page)]


def _add_collected(states, aggs, page: Page, order, starts) -> None:
    """Put each collecting aggregate's state matrix (K14) before its
    count in ``states``, over the groups' runs ``(order, starts)``."""
    c = ExprCompiler.for_page(page)
    for i, agg in enumerate(aggs):
        if agg.fn in COLLECT_FNS:
            sel, halves = _collect_inputs(c, agg, page)
            t = state_types(agg)[0]
            states[i] = [k14.group_collect(order, starts, sel, halves, t.max_elems,
                                           _torch_dtype(t))] + list(states[i])


def _checksum_hash(lw: _Lowering) -> int:
    """checksum's per-row hash after its argument (the reference's
    ``_partial_states`` :518): splitmix64 of the lane's 64 bits (HLL
    with P = 0; a double's bits), NULL rows the reference's constant."""
    lw._push(k1.HLL, 0)
    lw._push(k1.LIT, lw._const(CHECKSUM_NULL))
    lw._push(k1.COAL)
    return k1.KIND_I64


def _covar_lanes(c: ExprCompiler, agg: AggCall, page: Page):
    """The covariance family's five double lanes ``x``, ``y``, ``x*y``,
    ``x*x``, ``y*y`` (``y`` the first argument, ``x`` the second, each
    as a double), each valid where both are and the filter holds (the
    reference's ``sel``)."""
    from presto_tpu_torch.types import BOOLEAN

    def dbl(e):
        return e if e.type.name == "double" else Call(type=DOUBLE, fn="cast_double", args=(e,))

    y, x = dbl(agg.arg), dbl(agg.arg2)
    null = Literal(type=DOUBLE, value=None)

    def when_valid(other, e):
        return Call(type=DOUBLE, fn="if", args=(
            Call(type=BOOLEAN, fn="not_null", args=(other,)), e, null))

    def mul(a, b):
        return Call(type=DOUBLE, fn="mul", args=(a, b))

    lanes = (when_valid(y, x), when_valid(x, y), mul(x, y), when_valid(y, mul(x, x)),
             when_valid(x, mul(y, y)))
    return [_argument_lane(c, e, agg.filter, None)(page) for e in lanes]


def _by_entries(c: ExprCompiler, dicts, agg: AggCall, page: Page) -> List[k2.Agg]:
    """min_by / max_by's K2 entries: BY_X over ``x`` (a varchar stays a
    code), then BY_Y_MIN or BY_Y_MAX over ``y`` (a varchar through its
    collation rank), its validity the filter's selection."""
    rank = None
    if agg.arg2.type.is_string:
        ydict = expr_dictionary(agg.arg2, dicts)
        if ydict is None:
            raise NotPorted(f"{agg.fn} over a string key without a dictionary")
        rank = rank_luts(ydict)[0]
    xd, xv = c.compile(agg.arg)(page)
    yd, yv = _argument_lane(c, agg.arg2, agg.filter, rank)(page)
    return [(k2.BY_X, xd, xv), (k2.BY_Y_MIN if agg.fn == "min_by" else k2.BY_Y_MAX, yd, yv)]


def _k2_entries(agg: AggCall) -> int:
    """How many K2 entries (``kernel_inputs``) an aggregate takes."""
    return 5 if agg.fn in COVAR_FNS else 2 if agg.fn in ("min_by", "max_by") else 1


def _agg_states(aggs, entry_states) -> List[List[torch.Tensor]]:
    """K2's per-entry states regrouped into each aggregate's partial
    state, in ``state_types`` order."""
    out, pos = [], 0
    for agg in aggs:
        k = _k2_entries(agg)
        got = entry_states[pos:pos + k]
        pos += k
        if agg.fn in COVAR_FNS:  # five (sum, count); the counts are equal
            out.append([st[0] for st in got] + [got[0][1]])
        else:
            out.append([col for st in got for col in st])
    return out


def _argument_lane(c: ExprCompiler, arg: Optional[Expr], filt: Optional[Expr],
                   rank: Optional[k1.Lut], tail=None):
    """One K1 program for an aggregate's argument lane: the argument (or
    a constant true for a filtered count_star), through the collation's
    rank table for a varchar min/max (or ``tail``, which pushes more
    instructions and gives the output kind), and NULL where the filter
    is not true (``if(filter, arg, NULL)``: the reference's ``rowsel &
    valid``), so the kernels' validity lane carries the selection."""
    lw = _Lowering(c.dictionaries)
    if filt is not None:
        lw.emit(filt)
    if arg is None:
        lw._push(k1.LIT, lw._const(1))
        out = k1.KIND_BOOL
    else:
        lw.emit(arg)
        out = _out_kind(arg.type)
    if rank is not None:
        lw._push_lut(rank, k1.CANON)
        out = k1.KIND_I32
    if tail is not None:
        out = tail(lw)
    if filt is not None:
        lw._push(k1.NULL)
        lw._push(k1.SEL)
    return ExprCompiler.run_program(lw.program(out), list(lw.columns))


def _states_out(groups: int, key_blocks, state_cols, per_agg, aggs, mode, agg_dicts,
                device, collected=None) -> Page:
    """The page of a sort-path grouping: ``per_agg`` slices the flat
    K6 state columns back into each aggregate's ``[sum, count]`` or
    ``[count]``; ``collected``: a collecting aggregate's state matrix by
    its index, put before its count."""
    states, pos = [], 0
    for i, k in enumerate(per_agg):
        states.append(([collected[i]] if collected and i in collected else [])
                      + list(state_cols[pos:pos + k]))
        pos += k
    mask = torch.ones(groups, dtype=torch.bool, device=device)
    return _emit(key_blocks, states, aggs, mask, mode, agg_dicts)


def sorted_inputs(page: Page, group_exprs, aggs, key_domains):
    """The K6 inputs of a sort-path grouping: key columns (exact, or
    hashed without exact domains), the flat state list, and how many
    states each aggregate has."""
    keys, args = kernel_inputs(page, group_exprs, aggs, key_domains)
    states, per_agg = [], []
    pos = 0
    for agg in aggs:
        entries = args[pos:pos + _k2_entries(agg)]
        pos += len(entries)
        kind, data, valid = entries[0]
        if agg.fn in COVAR_FNS:  # five fixed-order sums and the count
            states += [(k6.S_DSUM, d, v) for _, d, v in entries] + [(k6.S_VALID, None, valid)]
            per_agg.append(6)
            continue
        if agg.fn in ("min_by", "max_by"):  # x, x flag, y, count of y
            ykind, yd, yv = entries[1]
            states += [(k6.S_BY_X, data, valid), (k6.S_BY_XV, None, valid),
                       (k6.S_BY_Y_MIN if ykind == k2.BY_Y_MIN else k6.S_BY_Y_MAX, yd, yv),
                       (k6.S_VALID, None, yv)]
            per_agg.append(4)
            continue
        if kind == k2.CHECKSUM:
            states.append((k6.S_SUM, data, valid))
            per_agg.append(1)
            continue
        if kind == k2.MOMENTS:  # (s, m2, m3, m4, cnt)
            states.append((k6.S_MOM, data, valid))
            per_agg.append(5)
            continue
        if kind == k2.COUNT_STAR:
            states.append((k6.S_ONE, None, None))
        elif kind == k2.COUNT:
            states.append((k6.S_VALID, None, valid))
        elif kind in _K6_STATE:
            states.append((_K6_STATE[kind], data, valid))
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
               k2.MAX_LONG: k6.S_MAX_LONG, k2.MIN_DOUBLE: k6.S_MIN_F64,
               k2.MAX_DOUBLE: k6.S_MAX_F64}
# the other (value, count) states: bool_and/bool_or's count of true rows
# (a sum of the boolean), the bitwise folds, hll_merge's sum of 2^-rho
_K6_STATE = {**_K6_EXTREME, k2.BOOL_COUNT: k6.S_SUM, k2.BIT_AND: k6.S_BAND,
             k2.BIT_OR: k6.S_BOR, k2.HLL_SUM: k6.S_HLL}


def _sorted_aggregate(page: Page, group_exprs, aggs, key_domains, mode,
                      presorted: bool = False) -> Page:
    """The reference's sort path over K6: every group the page holds,
    in packed-key order; or its streaming branch (``presorted``), in
    page order."""
    keys, states, per_agg = sorted_inputs(page, group_exprs, aggs, key_domains)
    got = k6.sorted_group_agg(keys, page.row_mask, states, presorted, runs=_collects(aggs))
    key_out, cols, groups = got[:3]
    if groups == 0:
        return _empty_groups(group_exprs, aggs, mode, page.device,
                             expr_key_dicts(page, group_exprs))
    collected = None
    if _collects(aggs):
        order, starts = got[3]
        per = [[] for _ in aggs]
        _add_collected(per, aggs, page, order, starts)
        collected = {i: st[0] for i, st in enumerate(per) if st}
    agg_dicts = [_agg_dict(a, [b.dictionary for b in page.blocks]) for a in aggs]
    key_blocks = [Block(d, v, e.type, dic) for (d, v), e, dic in
                  zip(key_out, group_exprs, expr_key_dicts(page, group_exprs))]
    return _states_out(groups, key_blocks, cols, per_agg, aggs, mode, agg_dicts,
                       page.device, collected)


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
        if agg.fn in COLLECT_FNS:  # the counts add; K14 merges the matrices
            states.append((k6.S_SUM, cols[1].data, live))
            per_agg.append(1)
            continue
        if agg.fn in ("count", "count_star", "checksum"):
            states.append((k6.S_SUM, cols[0].data, live))
        elif agg.fn in MOMENT_FNS:  # Chan's form, extended to M3 and M4
            states.append((k6.S_MOM_MERGE, tuple(c.data for c in cols), live))
        elif agg.fn in COVAR_FNS:
            states += [(k6.S_DSUM, c.data, live) for c in cols[:5]]
            states.append((k6.S_SUM, cols[5].data, live))
        elif agg.fn in ("min_by", "max_by"):
            has_x, has_y = cols[1].data > 0, cols[3].data > 0
            states += [(k6.S_BY_X, cols[0].data, has_x), (k6.S_BY_XV, None, has_x),
                       (k6.S_BY_Y_MIN if agg.fn == "min_by" else k6.S_BY_Y_MAX, cols[2].data,
                        has_y), (k6.S_SUM, cols[3].data, live)]
        elif agg.fn in ("min", "max") or agg.fn in BITWISE_FNS:
            states.append((_K6_STATE[_state_kind(agg)], cols[0].data, cols[1].data > 0))
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
    got = k6.sorted_group_agg(keys, partial.row_mask, states, runs=_collects(aggs))
    key_out, cols, groups = got[:3]
    key_blocks_in = partial.blocks[:num_keys]
    if groups == 0:
        return _empty_groups([ColumnRef(type=b.type, index=i)
                              for i, b in enumerate(key_blocks_in)], aggs, mode,
                             partial.device, [b.dictionary for b in key_blocks_in])
    agg_dicts = [c[0].dictionary for c in _slice_state_cols(partial, num_keys, aggs)]
    key_blocks = [Block(d, v, b.type, b.dictionary)
                  for (d, v), b in zip(key_out, key_blocks_in)]
    collected = None
    if _collects(aggs):  # each group's partial lists at running offsets (K14)
        order, starts = got[3]
        collected = {i: k14.group_collect_merge(order, starts, partial.row_mask, cols[0].data,
                                                state_types(agg)[0].max_elems)
                     for i, (agg, cols) in enumerate(zip(aggs, _slice_state_cols(
                         partial, num_keys, aggs))) if agg.fn in COLLECT_FNS}
    return _states_out(groups, key_blocks, cols, per_agg, aggs, mode, agg_dicts,
                       partial.device, collected)


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
        # a variance finalizes from (m2, cnt), the moments from (m2, m3,
        # m4) stacked, the covariance family from its five sums stacked,
        # min_by / max_by from (x, x flag); every other from (state, cnt)
        if kind in k3.VARIANCE_KINDS:
            items.append((kind, cols[1], cols[-1]))
        elif kind in k3.STACKED:
            items.append((kind, torch.stack(cols[1:4] if kind in k3.MOMENT_KINDS
                                            else cols[:5], dim=1), cols[-1]))
        elif agg.fn in ("min_by", "max_by"):
            items.append((kind, cols[0], cols[1]))
        elif agg.fn in COLLECT_FNS:  # the count's validity is the matrix's
            items.append((kind, cols[1], cols[1]))
        else:
            items.append((kind, cols[0], cols[-1]))
    out = k3.packed_finalize(items, mask)
    out = [(cols[0], v) if agg.fn in COLLECT_FNS else (d, v)
           for (d, v), agg, cols in zip(out, aggs, states)]
    for i, (agg, adict) in enumerate(zip(aggs, agg_dicts)):
        if agg.fn in ("min", "max") and agg.arg.type.is_string:
            if adict is None:
                raise NotPorted(f"{agg.fn} over a string without a dictionary")
            d, v = out[i]  # collation ranks back to a code of the value (K1's CANON)
            prog = k1.Program((k1.LOAD, k1.CANON), (0, 0), (), 1, k1.KIND_I32,
                              (rank_luts(adict)[1],))
            out[i] = (k1.expr_eval(prog, [(d, v)], d.shape[0])[0], v)
    # a collapsed long sum keeps the plan's short type, as the reference
    return [Block(d, v, agg.type if kind in (k3.FIN_SUM_COLLAPSE, k3.FIN_SUM0_COLLAPSE)
                  else output_type(agg), adict)
            for (d, v), agg, adict, (kind, _, _) in zip(out, aggs, agg_dicts, items)]


def combine_packed_states(a: Page, b: Page, num_keys: int,
                          aggs: Sequence[AggCall]) -> Page:
    """Fold two packed-direct partial pages slot by slot (K3)."""
    _check_ported(aggs, "partial")
    # a collecting aggregate's matrix merges by K14 (a's list, then b's),
    # its count folds with the others
    ca, cb = _slice_state_cols(a, num_keys, aggs), _slice_state_cols(b, num_keys, aggs)
    sa = [blk for agg, cols in zip(aggs, ca)
          for blk in (cols[1:] if agg.fn in COLLECT_FNS else cols)]
    sb = [blk for agg, cols in zip(aggs, cb)
          for blk in (cols[1:] if agg.fn in COLLECT_FNS else cols)]
    kinds = []
    for agg in aggs:
        if agg.fn in COLLECT_FNS:
            kinds.append(k3.COL_I64)
            continue
        if agg.fn in MOMENT_FNS:
            kinds += [k3.COL_F64, k3.COL_MOM_M2, k3.COL_MOM_M3, k3.COL_MOM_M4, k3.COL_I64]
            continue
        if agg.fn in ("min_by", "max_by"):
            kinds += [k3.COL_BY_X, k3.COL_BY_XV, k3.COL_BY_Y_MIN if agg.fn == "min_by"
                      else k3.COL_BY_Y_MAX, k3.COL_I64]
            continue
        for j, t in enumerate(state_types(agg)):
            if agg.fn in VARIANCE_FNS:
                kinds.append((k3.COL_F64, k3.COL_VAR_M2, k3.COL_I64)[j])
            elif agg.fn in ("min", "max") and j == 0:
                wide = "d128" if t.is_long_decimal else "f64" if t.name == "double" else \
                    "bool" if t.name == "boolean" else \
                    "i32" if np.dtype(t.np_dtype) == np.dtype(np.int32) else "i64"
                kinds.append(_K3_EXTREME[agg.fn, wide])
            elif agg.fn in BITWISE_FNS and j == 0:
                kinds.append(k3.COL_BAND if agg.fn == "bitwise_and_agg" else k3.COL_BOR)
            elif t.name == "double":
                kinds.append(k3.COL_F64)
            else:
                kinds.append(k3.COL_D128 if t.is_long_decimal else k3.COL_I64)

    outs, mask = k3.packed_fold([(k, x.data, x.valid) for k, x in zip(kinds, sa)],
                                [(k, x.data, x.valid) for k, x in zip(kinds, sb)],
                                a.row_mask, b.row_mask)
    folded = iter(zip(sa, outs))
    blocks = list(a.blocks[:num_keys])
    for agg, cols_a, cols_b in zip(aggs, ca, cb):
        if agg.fn in COLLECT_FNS:
            blk = cols_a[0]
            g = blk.data.shape[0]
            both = torch.stack([blk.data, cols_b[0].data], 1).reshape(2 * g, -1)
            live = torch.stack([a.row_mask, b.row_mask], 1).reshape(2 * g)
            starts = torch.arange(0, 2 * g + 1, 2, dtype=torch.int64, device=live.device)
            merged = k14.group_collect_merge(None, starts, live, both.contiguous(),
                                             blk.type.max_elems)
            blocks.append(Block(merged, mask, blk.type, blk.dictionary))
            rest = cols_a[1:]
        else:
            rest = cols_a
        for _ in rest:
            x, (data, valid) = next(folded)
            blocks.append(Block(data, valid, x.type, x.dictionary))
    return Page(tuple(blocks), mask)


_K3_EXTREME = {("min", "i64"): k3.COL_MIN_I64, ("max", "i64"): k3.COL_MAX_I64,
               ("min", "i32"): k3.COL_MIN_I32, ("max", "i32"): k3.COL_MAX_I32,
               ("min", "d128"): k3.COL_MIN_D128, ("max", "d128"): k3.COL_MAX_D128,
               ("min", "f64"): k3.COL_MIN_F64, ("max", "f64"): k3.COL_MAX_F64,
               ("min", "bool"): k3.COL_MIN_BOOL, ("max", "bool"): k3.COL_MAX_BOOL}


def finalize_packed(acc: Page, num_keys: int, aggs: Sequence[AggCall]) -> Page:
    """mode='single' finalize of a packed-direct accumulator: slots
    already hold one group each (K3)."""
    _check_ported(aggs, "single")
    states = [[b.data for b in cols] for cols in _slice_state_cols(acc, num_keys, aggs)]
    agg_dicts = [cols[0].dictionary for cols in _slice_state_cols(acc, num_keys, aggs)]
    agg_blocks = _finalize(states, aggs, agg_dicts, acc.row_mask)
    return Page(tuple(acc.blocks[:num_keys]) + tuple(agg_blocks), acc.row_mask)
