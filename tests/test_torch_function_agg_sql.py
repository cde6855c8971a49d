"""The reference suites' aggregate SQL in the eighth slice through the
port's ``QueryRunner`` on the CPU against the reference's, at TPC-H sf
0.001 (``tests/test_scalar_functions.py``'s bool_and/bool_or,
``test_function_breadth.py``'s approx_distinct, varchar min/max,
arbitrary, count_if, bitwise aggregates, geometric_mean and
approx_percentile), the filter lane beside unfiltered aggregates on
both grouping paths, min/max over doubles, booleans and varchar, the
formerly deferred max_n, max_by_n, approx_set and DECIMAL(38) against
the reference, and the families still outside the port (ML, geo)
pinned by name.  Rows are exact,
doubles within a relative 1e-9 (the parity tolerance)."""

import math

import pytest

from torch_fn_parity import TpchPair
from torch_parity import assert_models_close

_PAIR = []


def _pair() -> TpchPair:
    if not _PAIR:
        _PAIR.append(TpchPair())
    return _PAIR[0]


AGG_SQL = [
    # tests/test_scalar_functions.py AGG_CASES: bool_and / bool_or
    "select n_regionkey, bool_and(n_nationkey > 2), bool_or(n_nationkey > 20) from nation "
    "group by n_regionkey",
    # tests/test_function_breadth.py: approx_distinct, varchar min/max,
    # arbitrary, count_if, bitwise aggregates, geometric_mean,
    # approx_percentile
    "select approx_distinct(o_custkey) from orders",
    "select approx_distinct(l_partkey) from lineitem",
    "select approx_distinct(s_nationkey) from supplier",
    "select o_orderstatus, approx_distinct(o_custkey) from orders group by o_orderstatus",
    "select approx_distinct(o_custkey) from orders where o_orderkey < 0",
    "select approx_distinct(o_totalprice * 1e0) from orders",
    "select approx_distinct(o_comment) from orders",
    "select min(p_type), max(p_type) from part",
    "select min(c_mktsegment), max(c_mktsegment) from customer",
    "select min(s_name), max(s_name) from supplier",
    "SELECT arbitrary(l_returnflag) FROM lineitem",
    "SELECT count_if(l_quantity > 25), count(CASE WHEN l_quantity > 25 THEN 1 END) FROM lineitem",
    "select bitwise_and_agg(o_orderkey), bitwise_or_agg(o_orderkey) from orders",
    "select g, bitwise_and_agg(v), bitwise_or_agg(v) from (values (1, 12), (1, 10), (1, NULL), "
    "(2, 5), (3, NULL)) t(g, v) group by g order by g",
    "SELECT geometric_mean(l_quantity) FROM lineitem",
    "select s_nationkey, approx_percentile(s_acctbal, 0.5) from supplier group by s_nationkey",
    "select approx_percentile(o_totalprice, 0.25), approx_percentile(o_totalprice, 0.9) "
    "from orders",
    # the filter lane beside unfiltered aggregates, on both grouping paths
    "select l_returnflag, count_if(l_quantity > 25), sum(l_quantity), count(*) from lineitem "
    "group by l_returnflag",
    "select l_orderkey, count_if(l_quantity > 25), sum(l_quantity) from lineitem "
    "group by l_orderkey",
    "select l_returnflag, count_if(l_quantity > 100), min(l_shipdate) from lineitem "
    "group by l_returnflag",
    # min/max over doubles, booleans and varchar beside the rest, grouped
    "select l_shipmode, min(l_extendedprice / l_quantity), max(l_extendedprice / l_quantity), "
    "min(l_shipinstruct), max(l_shipinstruct), min(l_returnflag = 'R'), "
    "max(l_linestatus = 'F'), bool_and(l_quantity > 1), bool_or(l_quantity > 49), "
    "every(l_discount < 0.1), bitwise_and_agg(l_orderkey), bitwise_or_agg(l_partkey) "
    "from lineitem group by l_shipmode",
    "select o_custkey, max(o_orderpriority), min(o_totalprice / 7), bool_or(o_orderstatus = 'F') "
    "from orders group by o_custkey",
    "select g, min(x), max(x) from (values (1, 0e0), (1, -0e0), (2, -0e0), (2, 0e0), "
    "(3, 1e0)) t(g, x) group by g order by g",
]


@pytest.mark.parametrize("i", range(len(AGG_SQL)))
def test_aggregate_sql_equals_reference(i):
    rows = _pair().check(AGG_SQL[i])
    assert rows or "o_orderkey < 0" in AGG_SQL[i]


def test_empty_approx_distinct_is_zero_and_signed_zeros_order():
    """The reference suite's empty approx_distinct gives 0; min/max
    keep -0.0 below 0.0 (the reference's order) through SQL."""
    port = _pair().port
    assert port.execute(AGG_SQL[5]).rows == [(0,)]
    rows = port.execute(AGG_SQL[-1]).rows
    assert [math.copysign(1.0, r[1]) for r in rows[:2]] == [-1.0, -1.0]
    assert [math.copysign(1.0, r[2]) for r in rows[:2]] == [1.0, 1.0]


@pytest.mark.parametrize("sql", [
    "select max(l_extendedprice, 5) from lineitem",
    "select max_by(l_orderkey, l_quantity, 2) from lineitem",
    "select cardinality(approx_set(o_custkey)) from orders",
], ids=["max_n", "max_by_n", "approx_set"])
def test_deferred_aggregate_families_raise_by_name(sql):
    """Pinned as NotPorted until the twelfth slice ported them (max_n,
    max_by_n, approx_set; more in tests/test_torch_sketch_sql.py); now
    equal to the reference."""
    assert _pair().check(sql)


@pytest.mark.parametrize("sql,what", [
    ("select learn_classifier(o_shippriority, array[o_totalprice]) from orders", None),
    ("select evaluate_classifier_predictions(o_orderstatus, o_orderstatus) from orders",
     None),
    ("select st_distance(st_point(o_totalprice, 1.0), st_point(0.0, 0.0)) from orders", None),
    ("select o_orderpriority, sum(cast(o_totalprice as decimal(38,2)) + o_shippriority) "
     "from orders group by o_orderpriority", None),
], ids=["learn_classifier", "evaluate_classifier", "st_distance", "decimal38"])
def test_remaining_families_raise_by_name(sql, what):
    """The families a later slice ports raise NotPorted by name; a family
    a later slice ported (``what`` None: DECIMAL(38), the thirteenth
    slice; the ML aggregates and the geo functions, the fifteenth) equals
    the reference.  A model array's doubles agree lane by lane within a
    relative 1e-9 (``torch_parity.assert_models_close``): its variances
    cancel (``sumx2 / n - mean^2``) over sums that the port and the
    reference add in their own orders."""
    from presto_tpu_torch import NotPorted

    if what is None and "learn_classifier" in sql:
        pair = _pair()
        got, want = pair.port.execute(sql).rows, pair.ref.execute(sql).rows
        assert_models_close([r[0] for r in got], [r[0] for r in want], what=sql)
        return
    if what is None:
        _pair().check(sql)
        return
    with pytest.raises(NotPorted) as e:
        _pair().port.execute(sql)
    assert e.value.what == what


@pytest.mark.parametrize("sql", [
    "select min_by(s_name, s_acctbal) from supplier",
    "select checksum(l_orderkey) from lineitem",
    "select skewness(o_totalprice) from orders",
    "select covar_pop(l_extendedprice, l_quantity) from lineitem",
], ids=["min_by", "checksum", "moments", "covariance"])
def test_former_pin_equals_reference(sql):
    """Pinned as NotPorted until the ninth slice ported them (min_by /
    max_by, checksum, the moments and the covariance family; more in
    tests/test_torch_agg_tail.py); now equal to the reference."""
    _pair().check(sql)
