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
a wide decimal's (decimal(37..38), five limbs) sum, avg, min and max,
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

The sketch and heap aggregates (the twelfth slice) keep such a matrix
too.  hll_sketch (approx_set's and merge's outer level), multimap_agg
(a value half of ``1 + 64`` slots per entry: the entry's array) and
map_union (each map row's entries at the group's running offset: K14's
merge over the input maps; its count counts the rows whose map is not
NULL) are K14's.  max(x, n), min(x, n), max_by(x, y, n) and min_by(x,
y, n) are K15 ``group_topn``: two stable ``torch.sort`` passes order
each group's entries by key, K15 writes the n extreme ones (the max
forms from the end: among equal keys the later entry takes the lower
lane, as the reference's); a merge flattens the partial lanes into
entries and runs K15 again; the partials of a top-n state merge
pairwise in the reference runner's order (``fold_topn_partials``), as
the lanes a group keeps among equal keys depend on it.  make_set_digest and merge_set_digest are
K16 ``kmv_lanes``: entries sorted by (group, hash), runs of a hash
deduplicated summing their counts, the 64 smallest kept; the count
column is the group's distinct total (a merge recomputes it from the
merged lanes, as the reference's).  make_set_digest hashes by K1's
splitmix64 (``HLL`` with mode 1), a double by its bits, a varchar by its
dictionary code.

The ML aggregates (the fifteenth slice): learn_regressor,
learn_classifier and evaluate_classifier_predictions keep a ``(groups,
1 + m)`` state of sufficient statistics beside a count of selected rows
(``ML_FNS``).  K19 ``ml_state`` builds each row's lanes (the normal
equations' outer products, the naive Bayes class sums, the tp / fp / fn
counts) and adds them per group, on the packed-direct slots (while
slots x lanes fit ``ml_state.DIRECT_LANES``) or along K6's runs; its
merge mode merges partials, folds two packed tables and serves a spilled
bucket.  K20 ``ml_finalize`` turns the regressor's and the classifier's
states into their models; evaluate's counts pass through to the
executor's host finalize, which formats its text.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from presto_tpu_torch import NotPorted
from presto_tpu_torch.expr.compile import ExprCompiler, _Lowering, _lane, _out_kind, \
    expr_dictionary
from presto_tpu_torch.expr.ir import AggCall, Call, ColumnRef, Expr, Literal
from presto_tpu_torch.expr.geospatial import GeoCompiler, involves_contains
from presto_tpu_torch.expr.rawstrings import RawCompiler, hash_call, involves_raw
from presto_tpu_torch.kernels import expr_eval as k1
from presto_tpu_torch.kernels.container_eval import astype_values, lengths, sentinel
from presto_tpu_torch.kernels import group_collect as k14
from presto_tpu_torch.kernels import group_topn as k15
from presto_tpu_torch.kernels import kmv_lanes as k16
from presto_tpu_torch.kernels import ml_finalize as k20
from presto_tpu_torch.kernels import ml_state as k19
from presto_tpu_torch.kernels import packed_fold_finalize as k3
from presto_tpu_torch.kernels import packed_group_agg as k2
from presto_tpu_torch.kernels import sorted_group_agg as k6
from presto_tpu_torch.ops import rawstring as rs
from presto_tpu_torch.page import Block, Page, _torch_dtype, concat_pages_device
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
# every row, NULL values as the sentinel; map_agg, hll_sketch and
# multimap_agg the rows whose key is not NULL; map_union the entries of
# the maps that are not NULL
COLLECT_FNS = ("array_agg", "map_agg", "hll_sketch", "multimap_agg", "map_union")
# the top-n aggregates (K15 group_topn) and the set digests (K16 kmv_lanes)
TOPN_FNS = ("max_n", "min_n", "max_by_n", "min_by_n")
DIGEST_FNS = ("make_set_digest", "merge_set_digest")
# every aggregate whose state is a (groups, slots) matrix before its count
MATRIX_FNS = COLLECT_FNS + TOPN_FNS + DIGEST_FNS
# the ML aggregates (K19 ml_state, K20 ml_finalize): a (groups, 1 + m)
# state matrix of sufficient statistics before a count of selected rows
ML_FNS = ("learn_regressor", "learn_classifier", "evaluate_classifier_predictions")
# _state_kind's mark of an ML aggregate (no K2 entry) and
# _finalize_kind's (K20, or evaluate's pass-through)
ML_STATE, FIN_ML = -2, -3

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
    sum has one order, K6's; or an aggregate with a state matrix
    (``MATRIX_FNS``), which K14, K15 or K16 writes along K6's runs."""
    return bool(group_exprs) and (presorted or _has_double_state(aggs) or _collects(aggs)
                                  or not packed_direct_layout(group_exprs, key_domains,
                                                              max_groups)
                                  or not _ml_direct(aggs, max_groups))


def _ml_direct(aggs, max_groups: int) -> bool:
    """Whether every ML state of a packed-direct grouping fits K19's
    direct table: the ``max_groups`` slots it launches with, times the
    state's lanes, at most ``k19.DIRECT_LANES``."""
    return all(max_groups * _ml_lanes(a) <= k19.DIRECT_LANES for a in aggs if a.fn in ML_FNS)


def _has_ml(aggs) -> bool:
    return any(a.fn in ML_FNS for a in aggs)


def _collects(aggs) -> bool:
    return any(a.fn in MATRIX_FNS for a in aggs)


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
            and _lane(agg.arg.type) in ("long", "d38"):
        raise NotPorted(f"FILTER over {agg.arg.type}")
    if agg.fn == "count_star":
        return k2.COUNT_STAR if agg.filter is None else k2.COUNT
    if agg.fn == "count":
        return k2.COUNT
    if agg.fn in ("sum", "sum0", "avg"):
        t = agg.arg.type
        st = _sum_type(t)
        if t.name in ("double", "real"):  # a REAL sums in double
            return k2.SUM_DOUBLE
        if t.is_long_decimal:  # two limbs, or a wide argument's five
            return k2.SUM_LONG_ARG if t.value_shape == (2,) else k2.SUM_D38
        if t.value_shape != () or st.name in ("double", "real"):
            raise NotPorted(f"{agg.fn} over {t}")
        return k2.SUM_LONG if st.is_long_decimal else k2.SUM_SHORT
    if agg.fn in VARIANCE_FNS:  # the argument as a double (a decimal's to_double)
        t = agg.arg.type
        if t.value_shape != () and not t.is_long_decimal \
                or t.is_string or t.name in ("real", "boolean"):
            raise NotPorted(f"{agg.fn} over {t}")
        return k2.VARIANCE
    if agg.fn in ("min", "max"):
        t = agg.arg.type
        is_min = agg.fn == "min"
        if t.is_long_decimal and t.value_shape == (2,):
            return k2.MIN_LONG if is_min else k2.MAX_LONG
        if t.is_long_decimal:
            return k2.MIN_D38 if is_min else k2.MAX_D38
        if t.is_raw_string:  # over its pack_lanes lanes
            return k2.MIN_LANES if is_min else k2.MAX_LANES
        if t.name in ("double", "real"):  # a REAL's extreme in float32
            return k2.MIN_DOUBLE if is_min else k2.MAX_DOUBLE
        if t.value_shape != () or not (
                t.is_string or t.name == "boolean"
                or np.dtype(t.np_dtype) in _EXTREME_INTS):
            raise NotPorted(f"{agg.fn} over {t}")
        return k2.MIN_SHORT if is_min else k2.MAX_SHORT  # varchar: over collation ranks
    if agg.fn in ("bool_and", "bool_or", "every"):
        return k2.BOOL_COUNT
    if agg.fn in BITWISE_FNS:
        t = agg.arg.type
        if t.is_decimal or t.value_shape != () or t.is_string \
                or t.name in ("double",) + NARROW_TYPES:
            raise NotPorted(f"{agg.fn} over {t}")
        return k2.BIT_AND if agg.fn == "bitwise_and_agg" else k2.BIT_OR
    if agg.fn == "hll_merge":
        return k2.HLL_SUM
    if agg.fn == "checksum":
        t = agg.arg.type
        if (t.value_shape != () and not t.is_raw_string) or t.is_long_decimal \
                or t.name in NARROW_TYPES:
            raise NotPorted(f"checksum over {t}")
        return k2.CHECKSUM
    if agg.fn in MOMENT_FNS or agg.fn in COVAR_FNS:
        for t in (agg.arg.type, agg.arg2.type if agg.fn in COVAR_FNS else agg.arg.type):
            if t.value_shape != () and not t.is_long_decimal \
                    or t.is_string or t.name in ("real", "boolean", "date", "timestamp"):
                raise NotPorted(f"{agg.fn} over {t}")
        return k2.MOMENTS if agg.fn in MOMENT_FNS else k2.SUM_DOUBLE
    if agg.fn in ("min_by", "max_by"):
        if agg.arg.type.is_raw_string or agg.arg2.type.is_raw_string:
            raise ValueError(f"{agg.fn} over raw varchar / long decimal unsupported")
        for t in (agg.arg.type, agg.arg2.type):
            if t.value_shape != () or t.name in NARROW_TYPES:
                raise NotPorted(f"{agg.fn} over {t}")
        return k2.BY_X
    if agg.fn in MATRIX_FNS:
        if agg.filter is not None:
            raise NotPorted(f"FILTER over {agg.fn}")
        _check_matrix_args(agg)
        # the state's count: every row (array_agg); the rows whose key,
        # value or map is not NULL (a digest's distinct total replaces it)
        return k2.COUNT_STAR if agg.fn == "array_agg" else k2.COUNT
    if agg.fn in ML_FNS:
        _check_ml_args(agg)
        return ML_STATE
    raise NotPorted(f"aggregate {agg.fn}")


def _check_ml_args(agg: AggCall) -> None:
    """Refuse by name what K19 does not take: a FILTER, features that are
    not an array of one to ``k19.MAX_K`` numbers, a label with limbs."""
    if agg.filter is not None:
        raise NotPorted(f"FILTER over {agg.fn}")
    labels = (agg.arg, agg.arg2) if agg.fn == "evaluate_classifier_predictions" else (agg.arg,)
    if any(t.type.value_shape != () and not (agg.fn == "learn_regressor"
                                              and t.type.is_long_decimal) for t in labels):
        raise NotPorted(f"{agg.fn} over {[t.type for t in labels]}")
    if agg.fn != "evaluate_classifier_predictions":
        ft = agg.arg2.type
        if not ft.is_array or not 1 <= ft.max_elems <= k19.MAX_K \
                or ft.element.is_string or ft.element.value_shape != ():
            raise NotPorted(f"{agg.fn} over features {ft}")


def _ml_mode(agg: AggCall) -> int:
    return {"learn_regressor": k19.REGRESSOR, "learn_classifier": k19.CLASSIFIER,
            "evaluate_classifier_predictions": k19.EVALUATE}[agg.fn]


def _ml_lanes(agg: AggCall) -> int:
    k = 0 if agg.fn == "evaluate_classifier_predictions" else agg.arg2.type.max_elems
    return k19.lanes(_ml_mode(agg), k)


def _check_matrix_args(agg: AggCall) -> None:
    """Refuse by name the argument types a state matrix does not hold:
    a nested container, a raw string, a long decimal; a varchar top-n
    (the reference would order its dictionary codes)."""
    if agg.fn == "map_union":
        t = agg.arg.type
        scalars = (t.key_element, t.element) if t.is_map else (t,)
    elif agg.fn == "multimap_agg":  # the rewrite's array_agg of the values
        t = agg.arg2.type
        scalars = (agg.arg.type, t.element if t.is_array else t)
    elif agg.fn == "merge_set_digest":
        scalars = ()
    elif agg.fn in ("map_agg", "hll_sketch", "max_by_n", "min_by_n"):
        scalars = (agg.arg.type, agg.arg2.type)
    else:
        scalars = (agg.arg.type,)
    for t in scalars:
        if t is None or t.value_shape != () or t.is_raw_string \
                or (agg.fn in TOPN_FNS and t.is_string):
            raise NotPorted(f"{agg.fn} over {t}")


# the eleventh slice's narrow scalar types: sum/avg (a REAL in double,
# the integers in bigint) and min/max over them are ported; min_by /
# max_by, checksum and the bitwise folds over them stay refused by name
NARROW_TYPES = ("real", "smallint", "tinyint")
# integer storages a min/max keeps in its own type (interval: int64)
_EXTREME_INTS = tuple(np.dtype(d) for d in (np.int64, np.int32, np.int16, np.int8))


def _finalize_kind(agg: AggCall) -> int:
    """K3 finalize kind of an aggregate (after :func:`_state_kind`); a
    collecting aggregate's count finalizes as a sum, whose validity
    (``count > 0``) is its state matrix's."""
    if agg.fn in MATRIX_FNS:
        return k3.FIN_SUM
    if agg.fn in ML_FNS:
        return FIN_ML
    if agg.fn in ("count", "count_star"):
        return k3.FIN_COUNT
    if agg.fn in ("min", "max"):  # the state's value, NULL where its count is 0
        t = agg.arg.type
        if t.is_raw_string:  # the bytes as they are (_finalize)
            return FIN_RAW
        if t.name in NARROW_TYPES:  # in its own storage: int16, int8, float32
            return k3.FIN_VALUE
        if t.is_long_decimal:
            return k3.FIN_SUM_D128 if t.value_shape == (2,) else k3.FIN_SUM_D38
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
        if st.value_shape == (5,):  # a wide sum
            if zero or not agg.type.is_long_decimal:
                raise NotPorted(f"{agg.fn} over {agg.arg.type} producing {agg.type}")
            return k3.FIN_SUM_D38
        if st.is_long_decimal and agg.type.is_decimal and not agg.type.is_long_decimal:
            # the outer half of a decomposed sum: limbs back to one int64
            return k3.FIN_SUM0_COLLAPSE if zero else k3.FIN_SUM_COLLAPSE
        if st.is_long_decimal:
            return k3.FIN_SUM0_D128 if zero else k3.FIN_SUM_D128
        return k3.FIN_SUM0 if zero else k3.FIN_SUM
    if st.name == "double":
        return k3.FIN_AVG_F64
    if st.value_shape == (5,):  # a wide argument's mean, in its type
        return k3.FIN_AVG_D38
    if t.is_decimal and st.is_long_decimal:
        return k3.FIN_AVG_D128 if t.is_long_decimal else k3.FIN_AVG_D128_NARROW
    if t.is_decimal or t.name.startswith("interval"):
        return k3.FIN_AVG_SHORT
    if t.name == "double" and st.name == "bigint":  # an integer's mean
        return k3.FIN_AVG_DOUBLE
    raise NotPorted(f"avg producing {t}")


# a raw varchar extreme's finalize: its bytes, valid where its count is
# positive (no K3 kind: nothing to compute)
FIN_RAW = -1

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
    for a in aggs:
        if a.fn in ("bool_and", "bool_or", "every") and a.arg is not None \
                and a.arg.type.is_long_decimal:
            # the reference fails on its (n,) mask against the limbs
            raise NotPorted(f"{a.fn} over {a.arg.type}")
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
        states, _ = k2.packed_group_agg(n, page.row_mask, [], args, 1) if args else ([], None)
        out_mask = torch.ones(1, dtype=torch.bool, device=page.device)
        states = _agg_states(aggs, states)
        if _collects(aggs):  # the page's one run, in page order
            starts = torch.tensor([0, n], dtype=torch.int64, device=page.device)
            _add_collected(states, aggs, page, None, starts)
        _add_ml(states, aggs, page, groups=1)
        return _emit([], states, aggs, out_mask, mode, agg_dicts)
    states, present = k2.packed_group_agg(n, page.row_mask, keys, args, max_groups)
    states = _agg_states(aggs, states)
    if _has_ml(aggs):  # each row's slot: its exact packed key (dead rows past every slot)
        _add_ml(states, aggs, page, groups=max_groups, slot=_packed_slots(keys, page.row_mask))
    cards = [card for _, _, _, card in keys]
    key_blocks = _unpack_key_blocks(cards, key_domains, group_exprs,
                                    expr_key_dicts(page, group_exprs), int(np.prod(cards)),
                                    max_groups, page.device)
    return _emit(key_blocks, states, aggs, present, mode, agg_dicts)


def kernel_inputs(page: Page, group_exprs: Sequence[Expr], aggs: Sequence[AggCall],
                  key_domains) -> Tuple[List[k2.Key], List[k2.Agg]]:
    """The K2 inputs of a page: packed-key columns ``(data, valid, lo,
    card)`` and aggregate arguments (:func:`aggregate_args`)."""
    from presto_tpu_torch.ops.join import key_columns

    return key_columns(page, group_exprs, key_domains), aggregate_args(page, aggs)


def aggregate_args(page: Page, aggs: Sequence[AggCall]) -> List[k2.Agg]:
    """The aggregate arguments ``(kind, data, valid)`` of a page,
    evaluated by K1 where they are expressions; an aggregate takes one
    entry, a covariance five (``_covar_lanes``) and a min_by / max_by
    two (BY_X, then BY_Y_MIN or BY_Y_MAX)."""
    c = ExprCompiler.for_page(page)
    dicts = [b.dictionary for b in page.blocks]
    args = []
    for agg in aggs:
        kind = _state_kind(agg)
        if kind == ML_STATE:  # no K2 entry: K19 computes its state
            continue
        if agg.fn in COVAR_FNS:
            args += [(k2.SUM_DOUBLE, d, v) for d, v in _covar_lanes(c, agg, page)]
            continue
        if agg.fn in ("min_by", "max_by"):
            args += _by_entries(c, dicts, agg, page)
            continue
        if kind == k2.CHECKSUM:  # a raw varchar by its hash lane, as the reference
            arg = hash_call(agg.arg) if agg.arg.type.is_raw_string else agg.arg
            args.append((kind,) + _argument_lane(c, arg, agg.filter, None,
                                                 _checksum_hash)(page))
            continue
        if kind == k2.COUNT_STAR:
            args.append((kind, None, None))
            continue
        if agg.fn in MATRIX_FNS:  # a count of the rows whose key (value, map) is not NULL
            count_of = agg.arg2 if agg.fn in ("max_by_n", "min_by_n") else agg.arg
            _, v = c.compile(count_of)(page)
            args.append((kind, v, v))
            continue
        arg = agg.arg
        if arg is not None and arg.type.is_raw_string:  # its lanes (an extreme) or validity
            d, v = c.compile(arg)(page)
            if agg.filter is not None:
                fd, fv = c.compile(agg.filter)(page)
                v = v & fd & fv
            args.append((kind, rs.pack_lanes(d) if kind in k2.LANES else v, v))
            continue
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
    return args


def _run_positions(order: Optional[torch.Tensor], starts: torch.Tensor):
    """(group of each run position, row at each position): K6's runs,
    or the global aggregate's one run of the page (``order`` None)."""
    dev = starts.device
    groups = starts.shape[0] - 1
    live = int(starts[-1])
    g = torch.repeat_interleave(torch.arange(groups, device=dev), starts[1:] - starts[:-1])
    rows = order[:live] if order is not None else torch.arange(live, device=dev)
    return g, rows


def _collect_halves(c: ExprCompiler, agg: AggCall, page: Page):
    """(selected rows, lanes) of a collecting aggregate: array_agg's
    value over every live row, map_agg's, hll_sketch's and
    multimap_agg's key and value (an array row) over the live rows
    whose key is not NULL."""
    if agg.fn == "array_agg":
        return page.row_mask, [c.compile(agg.arg)(page)]
    kd, kv = c.compile(agg.arg)(page)
    return page.row_mask & kv, [(kd, kv), c.compile(agg.arg2)(page)]


def _storage_of(x: torch.Tensor, storage: torch.dtype) -> torch.Tensor:
    """A lane or slot matrix in the state's storage dtype, as the
    reference's ``astype``."""
    return x if x.dtype == storage else astype_values(x, storage)


def _matrix_state(c: ExprCompiler, agg: AggCall, page: Page, order, starts):
    """(state matrix, count or None) of an aggregate of ``MATRIX_FNS``
    over the groups' runs ``(order, starts)``: K14 for the collecting
    aggregates, K15 for the top-n, K16 for the digests (whose count, the
    distinct total, replaces the kernels' count)."""
    t = state_types(agg)[0]
    cap, storage = t.max_elems, _torch_dtype(t)
    if agg.fn == "map_union":  # each live map's entries at the running offset
        d, v = c.compile(agg.arg)(page)
        return k14.group_collect_merge(order, starts, page.row_mask & v, _storage_of(d, storage),
                                       cap, halves=2, in_cap=agg.arg.type.max_elems), None
    if agg.fn in COLLECT_FNS:
        sel, halves = _collect_halves(c, agg, page)
        return k14.group_collect(order, starts, sel, halves, cap, storage), None
    groups = starts.shape[0] - 1
    g, rows = _run_positions(order, starts)
    if agg.fn in TOPN_FNS:
        by = agg.fn in ("max_by_n", "min_by_n")
        xd, xv = c.compile(agg.arg)(page)
        kd, kv = c.compile(agg.arg2)(page) if by else (xd, xv)
        perm, runs = k15.sorted_entries(g, kd[rows], (page.row_mask & kv)[rows], groups)
        vals = _storage_of(xd, storage)
        if by:  # a NULL x keeps its lane, as the sentinel
            vals = torch.where(xv, vals, torch.full_like(vals, sentinel(storage)))
        keys = _storage_of(kd, storage) if by else None
        return k15.group_topn(rows[perm], runs, vals, keys, cap,
                              agg.fn in ("max_n", "max_by_n")), None
    d, v = c.compile(agg.arg)(page)
    ok = (page.row_mask & v)[rows]
    if agg.fn == "make_set_digest":
        h = _digest_hash(c, agg.arg)(page)[0][rows]
        entries = (g, h, None, ok)  # each row counts 1
    else:  # merge_set_digest: the digests' lanes as entries
        entries = k16.digest_entries(d[rows], g, ok, cap)
    perm, runs = k15.sorted_entries(entries[0], entries[1], entries[3], groups)
    return k16.kmv_lanes(perm, *entries[:3], runs, cap)


def digest_hash_program(c: ExprCompiler, arg: Expr) -> Tuple[k1.Program, List[int]]:
    """K1's program of make_set_digest's hash and the columns it loads:
    splitmix64 (the reference's ``mix64``) of the argument's 64 bits, a
    REAL widened to a double first, a varchar's dictionary code as it
    is."""
    if arg.type.name == "real":
        arg = Call(type=DOUBLE, fn="cast_double", args=(arg,))
    lw = _Lowering(c.dictionaries)
    lw.emit(arg)
    lw._push(k1.HLL, 1)
    return lw.program(k1.KIND_I64), list(lw.columns)


def _digest_hash(c: ExprCompiler, arg: Expr):
    return ExprCompiler.run_program(*digest_hash_program(c, arg))


def _merge_matrix(agg: AggCall, order, starts, live: torch.Tensor, parts: torch.Tensor,
                  total: torch.Tensor):
    """(merged state matrix, count or None) of an aggregate of
    ``MATRIX_FNS`` over partial rows in the groups' runs ``(order,
    starts)``: K14 concatenates, K15 and K16 re-run over the flattened
    lanes; ``total`` is the merged count column (the sum of the
    partials'), from which a digest recomputes its distinct total."""
    t = state_types(agg)[0]
    cap = t.max_elems
    if agg.fn in COLLECT_FNS:
        halves = 1 if agg.fn == "array_agg" else 2
        vw = 1 + t.element.max_elems if agg.fn == "multimap_agg" else 1
        return k14.group_collect_merge(order, starts, live, parts, cap, halves=halves,
                                       vw=vw), None
    groups = starts.shape[0] - 1
    g, rows = _run_positions(order, starts)
    part = parts[rows]
    if agg.fn in TOPN_FNS:
        lens = torch.where(live[rows], torch.clamp(lengths(part), max=cap),
                           torch.zeros_like(rows))
        lane_ok = (torch.arange(cap, device=parts.device)[None, :] < lens[:, None]).reshape(-1)
        by = agg.fn in ("max_by_n", "min_by_n")
        vals = part[:, 1:1 + cap].reshape(-1)
        keys = part[:, 1 + cap:1 + 2 * cap].reshape(-1) if by else vals
        perm, runs = k15.sorted_entries(g[:, None].expand(-1, cap).reshape(-1), keys, lane_ok,
                                        groups)
        return k15.group_topn(perm, runs, vals, keys if by else None, cap,
                              agg.fn in ("max_n", "max_by_n"), merge=True), None
    entries = k16.digest_entries(part, g, live[rows], cap)
    perm, runs = k15.sorted_entries(entries[0], entries[1], entries[3], groups)
    state, _ = k16.kmv_lanes(perm, *entries[:3], runs, cap, merge=True)
    # the partials' distinct totals overcount shared hashes: the merged
    # lanes are exact below cap, past it the larger of the two
    merged = state[:, 0]
    distinct = torch.where(merged < cap, merged, torch.maximum(total, merged))
    state[:, 0] = torch.clamp(distinct, max=cap)
    return state, distinct


def _add_collected(states, aggs, page: Page, order, starts) -> None:
    """Put each state matrix (K14, K15, K16) before its count in
    ``states``, over the groups' runs ``(order, starts)`` (a digest's
    distinct total in place of the count)."""
    c = ExprCompiler.for_page(page)
    for i, agg in enumerate(aggs):
        if agg.fn in MATRIX_FNS:
            matrix, count = _matrix_state(c, agg, page, order, starts)
            states[i] = [matrix] + (list(states[i]) if count is None else [count])


def _packed_slots(keys, row_mask: torch.Tensor) -> torch.Tensor:
    """Each row's packed-direct slot (K2's): its exact packed key, a dead
    row's past every slot."""
    from presto_tpu_torch.kernels import keys as pk

    if not row_mask.is_cuda:
        return pk.masked_plain(keys, row_mask, False)[0]
    return pk.pack(keys, row_mask, False, "ml_state")


def _ml_label(c: ExprCompiler, e: Expr, page: Page):
    """A class-id lane as the reference's ``astype(int64)``: a double's
    by XLA's conversion (K1's cast_bigint), else the stored value (a
    varchar's dictionary code, a decimal's unscaled value)."""
    if e.type.name in ("double", "real"):
        e = Call(type=BIGINT, fn="cast_bigint", args=(e,))
    d, v = c.compile(e)(page)
    return d if d.dtype in (torch.int32, torch.int64) else d.to(torch.int64), v


def _ml_inputs(c: ExprCompiler, agg: AggCall, page: Page) -> dict:
    """K19's inputs of an ML aggregate over ``page``: the mode, the label,
    ``y`` or the truth and prediction, the features matrix, and the
    selection (live rows whose arguments are valid)."""
    if agg.fn == "evaluate_classifier_predictions":
        (t, tv), (p, pv) = _ml_label(c, agg.arg, page), _ml_label(c, agg.arg2, page)
        return dict(mode=k19.EVALUATE, label=torch.stack([t.to(torch.int64),
                                                          p.to(torch.int64)], 1),
                    sel=page.row_mask & tv & pv)
    fd, fv = c.compile(agg.arg2)(page)
    k = agg.arg2.type.max_elems
    if agg.fn == "learn_regressor":
        arg = agg.arg if agg.arg.type.name == "double" else \
            Call(type=DOUBLE, fn="cast_double", args=(agg.arg,))
        y, yv = c.compile(arg)(page)
        return dict(mode=k19.REGRESSOR, k=k, y=y, feats=fd, sel=page.row_mask & yv & fv)
    lab, lv = _ml_label(c, agg.arg, page)
    return dict(mode=k19.CLASSIFIER, k=k, label=lab, feats=fd, sel=page.row_mask & lv & fv)


def _add_ml(states, aggs, page: Page, groups: int, slot=None) -> None:
    """Put each ML aggregate's K19 state and count in ``states``, over
    the packed-direct slots (``slot`` None: the global group)."""
    c = ExprCompiler.for_page(page)
    for i, agg in enumerate(aggs):
        if agg.fn in ML_FNS:
            states[i] = list(k19.ml_state(groups=groups, slot=slot, **_ml_inputs(c, agg, page)))


def _merge_ml(agg: AggCall, groups: int, live: torch.Tensor, parts: torch.Tensor,
              counts: torch.Tensor, order=None, starts=None):
    """(state, count) of an ML aggregate's partial rows merged over the
    runs ``(order, starts)`` (K19's merge: every column summed, the
    counts added)."""
    mode = k19.MERGE_I64 if agg.fn == "evaluate_classifier_predictions" else k19.MERGE
    return k19.ml_state(mode, groups, live, parts=parts, counts=counts, order=order,
                        starts=starts)


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
    return 5 if agg.fn in COVAR_FNS else 2 if agg.fn in ("min_by", "max_by") else \
        0 if agg.fn in ML_FNS else 1


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


def _filter_type_check(t: Type) -> None:
    """A FILTER (or count_if) over a non-boolean value, as the reference
    takes it (``live & fd & fv``, ``ops/aggregate.py``): an integer,
    date, timestamp, interval, short decimal or dictionary code selects
    by its low bit; a double or REAL is refused with ``TypeError``, as
    ``jnp.bitwise_and`` refuses it; limbs, raw strings and containers
    (the reference's broadcast error) are not ported."""
    if t.name in ("double", "real"):
        raise TypeError(f"a FILTER or count_if over {t}: the reference's bitwise and "
                        "of the row mask does not accept a floating-point value")
    if t.name != "boolean" and (t.is_long_decimal or t.is_raw_string or t.is_array
                                or t.is_map or t.value_shape != ()):
        raise NotPorted(f"a FILTER or count_if over {t}")


def _argument_lane(c: ExprCompiler, arg: Optional[Expr], filt: Optional[Expr],
                   rank: Optional[k1.Lut], tail=None):
    """One K1 program for an aggregate's argument lane: the argument (or
    a constant true for a filtered count_star), through the collation's
    rank table for a varchar min/max (or ``tail``, which pushes more
    instructions and gives the output kind), and NULL where the filter
    is not true (``if(filter, arg, NULL)``: the reference's ``rowsel &
    valid``), so the kernels' validity lane carries the selection."""
    extend = None
    given = [x for x in (arg, filt) if x is not None]
    bridged = RawCompiler if any(involves_raw(x) for x in given) else \
        GeoCompiler if any(involves_contains(x) for x in given) else None
    if bridged is not None:
        # the raw or geospatial half's bridge columns, then the program over them
        rewritten, extend, dicts = bridged(c).with_bridges(given)
        it = iter(rewritten)
        arg = None if arg is None else next(it)
        filt = None if filt is None else next(it)
        lw = _Lowering(dicts)
    else:
        lw = _Lowering(c.dictionaries)
    if filt is not None:
        _filter_type_check(filt.type)
        lw.emit(filt)
        if filt.type.name != "boolean":
            # the reference's ``live & fd & fv``: a non-boolean value
            # selects its row by its low bit
            lw._push(k1.LIT, lw._const(1))
            lw._push(k1.BITW, k1.BITW_OPS.index("and") | 64 << 4)
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
    run = ExprCompiler.run_program(lw.program(out), list(lw.columns))
    return run if extend is None else (lambda page: run(extend(page)))


def _states_out(groups: int, key_blocks, state_cols, per_agg, aggs, mode, agg_dicts,
                device, collected=None) -> Page:
    """The page of a sort-path grouping: ``per_agg`` slices the flat
    K6 state columns back into each aggregate's ``[sum, count]`` or
    ``[count]``; ``collected``: an aggregate's ``(state matrix, count or
    None)`` by its index, the matrix put before its count (a count given
    replaces K6's)."""
    states, pos = [], 0
    for i, k in enumerate(per_agg):
        cols = list(state_cols[pos:pos + k])
        if collected and i in collected:
            matrix, count = collected[i]
            cols = [matrix] + (cols if count is None else [count])
        states.append(cols)
        pos += k
    mask = torch.ones(groups, dtype=torch.bool, device=device)
    return _emit(key_blocks, states, aggs, mask, mode, agg_dicts)


def sorted_inputs(page: Page, group_exprs, aggs, key_domains):
    """The K6 inputs of a sort-path grouping: key columns (exact, or
    hashed without exact domains), the flat state list, and how many
    states each aggregate has."""
    keys, args = kernel_inputs(page, group_exprs, aggs, key_domains)
    return (keys,) + sorted_states(aggs, args)


def sorted_states(aggs, args) -> tuple:
    """K6's flat state list of the aggregate arguments ``args``
    (:func:`aggregate_args`), and how many states each aggregate has."""
    states, per_agg = [], []
    pos = 0
    for agg in aggs:
        entries = args[pos:pos + _k2_entries(agg)]
        pos += len(entries)
        if agg.fn in ML_FNS:  # K19 over the groups' runs
            per_agg.append(0)
            continue
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
    return states, per_agg


_K6_SUM = {k2.SUM_SHORT: k6.S_SUM, k2.SUM_LONG: k6.S_LIMBS_SHORT,
           k2.SUM_LONG_ARG: k6.S_LIMBS_LONG, k2.SUM_DOUBLE: k6.S_DSUM,
           k2.SUM_D38: k6.S_LIMBS_D38}
_K6_EXTREME = {k2.MIN_SHORT: k6.S_MIN, k2.MAX_SHORT: k6.S_MAX, k2.MIN_LONG: k6.S_MIN_LONG,
               k2.MAX_LONG: k6.S_MAX_LONG, k2.MIN_DOUBLE: k6.S_MIN_F64,
               k2.MAX_DOUBLE: k6.S_MAX_F64, k2.MIN_D38: k6.S_MIN_D38,
               k2.MAX_D38: k6.S_MAX_D38, k2.MIN_LANES: k6.S_MIN_LANES,
               k2.MAX_LANES: k6.S_MAX_LANES}
# the other (value, count) states: bool_and/bool_or's count of true rows
# (a sum of the boolean), the bitwise folds, hll_merge's sum of 2^-rho
_K6_STATE = {**_K6_EXTREME, k2.BOOL_COUNT: k6.S_SUM, k2.BIT_AND: k6.S_BAND,
             k2.BIT_OR: k6.S_BOR, k2.HLL_SUM: k6.S_HLL}


def _sorted_aggregate(page: Page, group_exprs, aggs, key_domains, mode,
                      presorted: bool = False) -> Page:
    """The reference's sort path over K6: every group the page holds,
    in packed-key order; or its streaming branch (``presorted``), in
    page order."""
    from presto_tpu_torch.ops.join import key_tuples

    c = ExprCompiler.for_page(page)
    key_cols = [c.compile_key(e)(page) for e in group_exprs]
    keys = key_tuples(key_cols, [e.type for e in group_exprs], key_domains)
    states, per_agg = sorted_states(aggs, aggregate_args(page, aggs))
    # a raw key's bytes, for its groups' output (the key hashes to one lane)
    raw_keys = {i: kv for i, (kv, e) in enumerate(zip(key_cols, group_exprs))
                if e.type.is_raw_string}
    got = k6.sorted_group_agg(keys, page.row_mask, states or [(k6.S_ONE, None, None)],
                              presorted, runs=_collects(aggs) or bool(raw_keys) or _has_ml(aggs))
    key_out, cols, groups = got[:3]
    if groups == 0:
        return _empty_groups(group_exprs, aggs, mode, page.device,
                             expr_key_dicts(page, group_exprs))
    key_out = _raw_key_out(key_out, raw_keys, got)
    collected = None
    if _collects(aggs) or _has_ml(aggs):
        order, starts = got[3]
        collected = {i: _matrix_state(c, agg, page, order, starts)
                     for i, agg in enumerate(aggs) if agg.fn in MATRIX_FNS}
        collected.update({i: k19.ml_state(groups=groups, order=order, starts=starts,
                                          **_ml_inputs(c, agg, page))
                          for i, agg in enumerate(aggs) if agg.fn in ML_FNS})
    agg_dicts = [_agg_dict(a, [b.dictionary for b in page.blocks]) for a in aggs]
    key_blocks = [Block(d, v, e.type, dic) for (d, v), e, dic in
                  zip(key_out, group_exprs, expr_key_dicts(page, group_exprs))]
    return _states_out(groups, key_blocks, cols, per_agg, aggs, mode, agg_dicts,
                       page.device, collected)


def _raw_key_out(key_out, raw_keys: dict, got) -> list:
    """K6's key outputs with each raw key's hash lane replaced by the
    bytes of its group's first row (the reference keeps the key's
    values)."""
    if not raw_keys:
        return key_out
    order, starts = got[3]
    rep = order[starts[:-1]]
    return [(raw_keys[i][0][rep], raw_keys[i][1][rep]) if i in raw_keys else kv
            for i, kv in enumerate(key_out)]


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

    if num_keys == 0:  # a global aggregate's partials: one group, a constant key
        n, dev = partial.capacity, partial.device
        keys = [(torch.zeros(n, dtype=torch.int64, device=dev),
                 torch.ones(n, dtype=torch.bool, device=dev), 0, 2)]
    else:
        key_blocks = partial.blocks[:num_keys]  # codes already canonical
        keys = key_tuples([(b.data, b.valid) for b in key_blocks],
                          [b.type for b in key_blocks], key_domains)
    live = partial.row_mask
    states, per_agg = [], []
    for agg, cols in zip(aggs, _slice_state_cols(partial, num_keys, aggs)):
        if agg.fn in ML_FNS:  # K19's merge, state and count, over the groups' runs
            per_agg.append(0)
            continue
        if agg.fn in MATRIX_FNS:  # the counts add; K14, K15 or K16 merges the matrices
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
            data = rs.pack_lanes(cols[0].data) if _raw_extreme(agg) else cols[0].data
            states.append((_K6_STATE[_state_kind(agg)], data, cols[1].data > 0))
            states.append((k6.S_SUM, cols[1].data, live))
        elif agg.fn in VARIANCE_FNS:  # Chan's form over k partials
            states.append((k6.S_VAR_MERGE, tuple(c.data for c in cols), live))
        elif cols[0].type.name == "double":
            states.append((k6.S_DSUM, cols[0].data, live))
            states.append((k6.S_SUM, cols[1].data, live))
        elif cols[0].type.is_long_decimal:  # a wide sum's five limbs add as they are
            states.append((k6.S_LIMBS_D38 if cols[0].type.value_shape == (5,)
                           else k6.S_LIMBS_LONG, cols[0].data, cols[1].data > 0))
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
    key_blocks_in = partial.blocks[:num_keys]
    raw_keys = {i: (b.data, b.valid) for i, b in enumerate(key_blocks_in)
                if b.type.is_raw_string}
    got = k6.sorted_group_agg(keys, partial.row_mask, states or [(k6.S_ONE, None, None)],
                              runs=_collects(aggs) or bool(raw_keys) or _has_ml(aggs))
    key_out, cols, groups = got[:3]
    if groups == 0:
        return _empty_groups([ColumnRef(type=b.type, index=i)
                              for i, b in enumerate(key_blocks_in)], aggs, mode,
                             partial.device, [b.dictionary for b in key_blocks_in])
    agg_dicts = [c[0].dictionary for c in _slice_state_cols(partial, num_keys, aggs)]
    key_blocks = [Block(d, v, b.type, b.dictionary)
                  for (d, v), b in zip(_raw_key_out(key_out, raw_keys, got), key_blocks_in)]
    collected = None
    if _collects(aggs) or _has_ml(aggs):  # each group's partial matrices merged
        order, starts = got[3]          # (K14, K15, K16; K19 for the ML states)
        collected, pos = {}, 0
        for i, (agg, k, pcols) in enumerate(zip(aggs, per_agg, _slice_state_cols(
                partial, num_keys, aggs))):
            if agg.fn in MATRIX_FNS:
                collected[i] = _merge_matrix(agg, order, starts, partial.row_mask,
                                             pcols[0].data, cols[pos])
            elif agg.fn in ML_FNS:
                collected[i] = _merge_ml(agg, groups, partial.row_mask, pcols[0].data,
                                         pcols[1].data, order=order, starts=starts)
            pos += k
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


def _raw_extreme(agg: AggCall) -> bool:
    return agg.fn in ("min", "max") and agg.arg.type.is_raw_string


def raw_extremes(aggs) -> bool:
    """Whether a raw varchar min/max is among ``aggs``: its lane state
    merges lexicographically, never slot by slot, so its partials go
    through the merge (the reference's ``packed_fold_supported``)."""
    return any(_raw_extreme(a) for a in aggs)


def _emit(key_blocks, states, aggs, out_mask, mode, agg_dicts) -> Page:
    for agg, cols in zip(aggs, states):  # a raw extreme's lanes back to its bytes
        if _raw_extreme(agg) and cols[0].dtype == torch.int64:
            cols[0] = rs.unpack_lanes(cols[0], agg.arg.type.value_shape[0])
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
    items, raw = [], {}
    for i, (agg, cols) in enumerate(zip(aggs, states)):
        kind = _finalize_kind(agg)
        if kind == FIN_RAW:
            raw[i] = (cols[0], mask & (cols[-1] > 0))
            continue
        if kind == FIN_ML:  # K20's model; evaluate's count matrix for the host finalize
            ok = mask & (cols[-1] > 0)
            if agg.fn == "evaluate_classifier_predictions":
                raw[i] = (cols[0], ok)
            else:
                mode = k20.REGRESSOR if agg.fn == "learn_regressor" else k20.CLASSIFIER
                raw[i] = (k20.ml_finalize(mode, cols[0], agg.arg2.type.max_elems), ok)
            continue
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
        elif agg.fn in MATRIX_FNS:  # the count's validity is the matrix's
            items.append((kind, cols[1], cols[1]))
        else:
            items.append((kind, cols[0], cols[-1]))
    out = list(k3.packed_finalize(items, mask)) if items else []
    for i in sorted(raw):
        out.insert(i, raw[i])
        items.insert(i, (FIN_RAW, None, None))
    out = [(_output_matrix(agg, cols[0]), v) if agg.fn in MATRIX_FNS else (d, v)
           for (d, v), agg, cols in zip(out, aggs, states)]
    for i, (agg, adict) in enumerate(zip(aggs, agg_dicts)):
        if agg.fn in ("min", "max") and agg.arg.type.is_string and i not in raw:
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


def _output_matrix(agg: AggCall, state: torch.Tensor) -> torch.Tensor:
    """A state matrix as its output value: max_by_n / min_by_n drop the
    key half and take the output array's storage (a NaN sentinel of a
    double state becomes an integer's sentinel, a NaN length 0)."""
    if agg.fn not in ("max_by_n", "min_by_n"):
        return state
    cap = state_types(agg)[0].max_elems
    sub = state[:, :1 + cap]
    out_dt = _torch_dtype(output_type(agg))
    if sub.is_floating_point() and not out_dt.is_floating_point:
        body = sub[:, 1:]
        body = torch.where(torch.isnan(body), torch.full_like(body, float(sentinel(out_dt))),
                           body)
        l0 = torch.where(torch.isnan(sub[:, :1]), torch.zeros_like(sub[:, :1]), sub[:, :1])
        sub = torch.cat([l0, body], 1)
    return sub.to(out_dt)


def combine_packed_states(a: Page, b: Page, num_keys: int,
                          aggs: Sequence[AggCall]) -> Page:
    """Fold two packed-direct partial pages slot by slot (K3)."""
    _check_ported(aggs, "partial")
    # a state matrix merges by K14, K15 or K16 (a's row, then b's), its
    # count folds with the others
    ca, cb = _slice_state_cols(a, num_keys, aggs), _slice_state_cols(b, num_keys, aggs)
    # an ML state and its count fold by K19's merge (a's row, then b's)
    sa = [blk for agg, cols in zip(aggs, ca) if agg.fn not in ML_FNS
          for blk in (cols[1:] if agg.fn in MATRIX_FNS else cols)]
    sb = [blk for agg, cols in zip(aggs, cb) if agg.fn not in ML_FNS
          for blk in (cols[1:] if agg.fn in MATRIX_FNS else cols)]
    kinds = []
    for agg in aggs:
        if agg.fn in ML_FNS:
            continue
        if agg.fn in MATRIX_FNS:
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
                # a REAL folds as a double (float32 storage), a SMALLINT
                # or TINYINT as an int64 (its own storage)
                wide = "d38" if t.value_shape == (5,) else \
                    "d128" if t.is_long_decimal else \
                    "f64" if t.name in ("double", "real") else \
                    "bool" if t.name == "boolean" else \
                    "i32" if np.dtype(t.np_dtype) == np.dtype(np.int32) else "i64"
                kinds.append(_K3_EXTREME[agg.fn, wide])
            elif agg.fn in BITWISE_FNS and j == 0:
                kinds.append(k3.COL_BAND if agg.fn == "bitwise_and_agg" else k3.COL_BOR)
            elif t.name == "double":
                kinds.append(k3.COL_F64)
            else:
                kinds.append(k3.COL_D38 if t.value_shape == (5,) else
                             k3.COL_D128 if t.is_long_decimal else k3.COL_I64)

    if sa:
        outs, mask = k3.packed_fold([(k, x.data, x.valid) for k, x in zip(kinds, sa)],
                                    [(k, x.data, x.valid) for k, x in zip(kinds, sb)],
                                    a.row_mask, b.row_mask)
    else:
        outs, mask = [], a.row_mask | b.row_mask
    folded = iter(zip(sa, outs))
    blocks = list(a.blocks[:num_keys])
    for agg, cols_a, cols_b in zip(aggs, ca, cb):
        if agg.fn in ML_FNS:
            g = cols_a[0].data.shape[0]
            both = torch.stack([cols_a[0].data, cols_b[0].data], 1).reshape(2 * g, -1)
            counts = torch.stack([cols_a[1].data, cols_b[1].data], 1).reshape(2 * g)
            live = torch.stack([a.row_mask, b.row_mask], 1).reshape(2 * g)
            starts = torch.arange(0, 2 * g + 1, 2, dtype=torch.int64, device=live.device)
            state, count = _merge_ml(agg, g, live, both.contiguous(), counts, starts=starts)
            blocks.append(Block(state, mask, cols_a[0].type, None))
            blocks.append(Block(count, mask, cols_a[1].type, None))
            continue
        if agg.fn in MATRIX_FNS:
            blk = cols_a[0]
            g = blk.data.shape[0]
            both = torch.stack([blk.data, cols_b[0].data], 1).reshape(2 * g, -1)
            live = torch.stack([a.row_mask, b.row_mask], 1).reshape(2 * g)
            starts = torch.arange(0, 2 * g + 1, 2, dtype=torch.int64, device=live.device)
            x, (total, valid) = next(folded)
            merged, count = _merge_matrix(agg, None, starts, live, both.contiguous(), total)
            blocks.append(Block(merged, mask, blk.type, blk.dictionary))
            blocks.append(Block(total if count is None else count, valid, x.type,
                                x.dictionary))
            continue
        for _ in cols_a:
            x, (data, valid) = next(folded)
            blocks.append(Block(data, valid, x.type, x.dictionary))
    return Page(tuple(blocks), mask)


_K3_EXTREME = {("min", "i64"): k3.COL_MIN_I64, ("max", "i64"): k3.COL_MAX_I64,
               ("min", "i32"): k3.COL_MIN_I32, ("max", "i32"): k3.COL_MAX_I32,
               ("min", "d128"): k3.COL_MIN_D128, ("max", "d128"): k3.COL_MAX_D128,
               ("min", "d38"): k3.COL_MIN_D38, ("max", "d38"): k3.COL_MAX_D38,
               ("min", "f64"): k3.COL_MIN_F64, ("max", "f64"): k3.COL_MAX_F64,
               ("min", "bool"): k3.COL_MIN_BOOL, ("max", "bool"): k3.COL_MAX_BOOL}


#: the smallest capacity of a level of the reference's binary-counter fold
TOWER_MIN_CAP = 1 << 12


def fold_topn_partials(parts: Sequence[Page], num_keys: int, aggs: Sequence[AggCall],
                       max_groups: int, key_domains=None, tower: bool = False) -> Page:
    """The partial pages of an aggregation with a top-n state
    (``TOPN_FNS``) merged pairwise (``merge_aggregate``, mode 'partial')
    in the reference runner's order, ready for the final merge.  Each
    merge of a max form reverses the lanes of equal keys and keeps n of
    them, so which rows a group keeps among ties, and in which order,
    depends on which pages merged when.  ``tower``: the binary counter of
    a keyed fold off the packed-direct layout (a page at the power of two
    above its groups, at least ``TOWER_MIN_CAP`` and at most
    ``max_groups``; two pages of one capacity merge, the older first,
    into twice it; the survivors go to the final merge largest first);
    else the running fold (the first page merged alone, then the
    accumulator with each page)."""
    def merge(pages):
        return merge_aggregate(concat_pages_device(pages), num_keys, aggs, max_groups,
                               key_domains=key_domains, mode="partial")

    if not tower:
        acc = merge([parts[0]])
        for p in parts[1:]:
            acc = merge([acc, p])
        return acc
    levels = {}
    for p in parts:
        live = int(p.row_mask.sum())
        cap = min(max_groups, max(TOWER_MIN_CAP, 1 << max(0, live - 1).bit_length()))
        while cap in levels:
            p = merge([levels.pop(cap), p])
            cap *= 2
        levels[cap] = p
    return concat_pages_device([levels[c] for c in sorted(levels, reverse=True)])


def finalize_packed(acc: Page, num_keys: int, aggs: Sequence[AggCall]) -> Page:
    """mode='single' finalize of a packed-direct accumulator: slots
    already hold one group each (K3)."""
    _check_ported(aggs, "single")
    states = [[b.data for b in cols] for cols in _slice_state_cols(acc, num_keys, aggs)]
    agg_dicts = [cols[0].dictionary for cols in _slice_state_cols(acc, num_keys, aggs)]
    agg_blocks = _finalize(states, aggs, agg_dicts, acc.row_mask)
    return Page(tuple(acc.blocks[:num_keys]) + tuple(agg_blocks), acc.row_mask)
