"""The eleventh slice through SQL: REAL, SMALLINT, TINYINT and INTERVAL
values, IN over a double and ORDER BY ... LIMIT past 100, and a VALUES
row holding an ARRAY, each statement through the reference's
``QueryRunner`` and the port's on the CPU over the reference suites'
catalog (TPC-H sf 0.001, 4096-row splits: ``torch_fn_parity.TpchPair``),
with the suites' own statements of each family
(``tests/test_statements.py`` test_interval_values_and_aggregates,
``tests/test_scalar_breadth2.py`` test_row_review_regressions and
test_row_in_and_real_decode, ``tests/test_kernel_soundness.py``
test_seeded_lossy_cast_caught's statement (against the reference's run
time: its static gate refuses it), and
``tests/test_feature_interactions.py`` test_cte_over_unnest_with_window's).

Tolerances: integers, decimals, intervals, REALs and strings exactly;
doubles within a relative 1e-9 (a REAL's sum adds as doubles, in the
port's fixed order and the reference's own)."""

import pytest

from presto_tpu_torch import NotPorted
from torch_fn_parity import TpchPair

_PAIR = []


def _pair() -> TpchPair:
    if not _PAIR:
        _PAIR.append(TpchPair())
    return _PAIR[0]


DELAY = "l_receiptdate - l_shipdate"
SQL = {
    # the statements the port refused before this slice, by family
    "real_sums": "select l_returnflag, sum(cast(l_quantity as real)), "
                 "min(cast(l_discount as real)), max(cast(l_tax as real)) from lineitem "
                 "group by 1 order by 1",
    "narrow_keys": "select cast(l_linenumber as tinyint) a, cast(l_quantity as smallint) b, "
                   "count(*) from lineitem group by 1, 2",
    "real_product": "select cast(l_extendedprice as real) * cast(l_discount as real) "
                    "from lineitem limit 3",
    "shipping_delay": f"select l_shipmode, sum({DELAY}), avg({DELAY}), max({DELAY}) "
                      "from lineitem group by 1",
    "timestamp_difference": "select timestamp '2020-01-02 00:00:00' - "
                            "timestamp '2020-01-01 12:00:00' from orders limit 2",
    "in_double": "select count(*) from lineitem where cast(l_discount as double) "
                 "in (0.02e0, 0.05e0)",
    "top_150": "select l_orderkey, l_extendedprice from lineitem "
               "order by l_extendedprice desc, l_orderkey limit 150",
    "real_top": "select o_orderkey, cast(o_totalprice as real) r from orders "
                "order by r desc limit 10",
    "real_window": "select o_orderkey, sum(cast(o_totalprice as real)) over "
                   "(partition by o_orderstatus order by o_orderkey) from orders",
    # the suites' statements of each family
    "interval_literal": "select interval '3' day",
    "interval_sum_of_literals": "select interval '90' second + interval '30' second",
    "interval_sum_avg": "select sum(d), avg(d) from (select timestamp '2020-01-02 00:00:00'"
                        " - timestamp '2020-01-01 12:00:00' as d from nation)",
    "interval_months": "select interval '14' month",
    "date_difference_max": "select max(dd) from (select date '2020-01-03' - "
                           "date '2020-01-01' as dd from nation)",
    "real_in_row_field": "select row(cast(1.5 as real))[1]",
    "real_in_row": "select row(cast(1.5 as real))",
    "values_ragged_arrays": "select k, a from (values (1, array[3, 1]), (2, array[2])) "
                            "as t(k, a)",
    "values_equal_arrays": "select k, a from (values (1, array[3, 1]), (2, array[2, 5])) "
                           "as t(k, a)",
    "values_unnest_window": "WITH expanded AS (SELECT k, e FROM (VALUES (1, ARRAY[3, 1]), "
                            "(2, ARRAY[2])) AS t(k, a) CROSS JOIN UNNEST(a) AS u(e)) "
                            "SELECT k, e, row_number() OVER (PARTITION BY k ORDER BY e) AS rn "
                            "FROM expanded ORDER BY k, rn",
    # ORDER BY ... LIMIT past K7's 100 rows, over customer and orders
    "customer_101": "select c_name, c_acctbal from customer order by c_acctbal desc, c_name "
                    "limit 101",
    "customer_150": "select c_custkey, c_acctbal from customer order by c_acctbal "
                    "limit 150",
    "customer_500": "select c_custkey, c_nationkey, c_acctbal from customer "
                    "order by c_nationkey desc, c_acctbal, c_custkey limit 500",
    "orders_101": "select o_orderkey, o_orderdate from orders order by o_orderdate, "
                  "o_orderkey desc limit 101",
    "orders_150": "select o_orderkey, o_totalprice from orders order by o_totalprice desc "
                  "limit 150",
    "orders_500": "select o_custkey, o_orderkey, o_orderpriority from orders "
                  "order by o_orderpriority, o_custkey, o_orderkey limit 500",
    # the smoke's types phase at this scale
    "real_q1": "select l_returnflag, l_linestatus, sum(cast(l_quantity as real)), "
               "sum(cast(l_extendedprice as real) * (1 - cast(l_discount as real))), "
               "avg(cast(l_quantity as real)), avg(cast(l_discount as real)), "
               "min(cast(l_tax as real)), max(cast(l_tax as real)), count(*) from lineitem "
               "where l_shipdate <= date '1998-09-02' group by 1, 2 order by 1, 2",
    "real_supplier": "select count(*), sum(mn), sum(mx), sum(s) from (select l_suppkey, "
                     "min(cast(l_extendedprice * (1 - l_discount) as real)) mn, "
                     "max(cast(l_extendedprice * (1 - l_discount) as real)) mx, "
                     "sum(cast(l_extendedprice * (1 - l_discount) as real)) s "
                     "from lineitem group by l_suppkey)",
    "narrow_sums": "select cast(l_linenumber as tinyint) ln, cast(l_quantity as smallint) q, "
                   "count(*), sum(cast(l_quantity as smallint)), min(cast(l_discount as real)), "
                   "max(cast(l_tax as real)) from lineitem group by 1, 2 order by 1, 2",
    "delay_by_mode": f"select l_shipmode, sum({DELAY}), avg({DELAY}), min({DELAY}), "
                     f"max({DELAY}), max(l_receiptdate - l_commitdate), "
                     "min(cast(l_discount as real)), max(cast(l_quantity as smallint)) "
                     "from lineitem group by l_shipmode order by l_shipmode",
    "in_double_sum": "select count(*), sum(l_extendedprice) from lineitem "
                     "where cast(l_discount as double) in (0.02e0, 0.05e0, 0.07e0)",
    "top_1000": "select l_orderkey, l_linenumber, l_extendedprice from lineitem "
                "order by l_extendedprice desc, l_orderkey, l_linenumber limit 1000",
    "real_top_100": "select o_orderkey, cast(o_totalprice as real) r from orders "
                    "order by r desc, o_orderkey limit 100",
    "real_running_window": "select count(*), max(rs) from (select sum(cast(o_totalprice as "
                           "real)) over (partition by o_custkey order by o_orderdate, "
                           "o_orderkey) rs from orders)",
    # beyond: narrow arithmetic, interval arithmetic on timestamps, REAL
    # comparisons, casts and keys
    "narrow_arithmetic": "select cast(l_linenumber as tinyint) * cast(l_linenumber as tinyint),"
                         " cast(l_quantity as smallint) + cast(l_linenumber as smallint), "
                         "cast(l_quantity as smallint) % cast(l_linenumber as tinyint) "
                         "from lineitem where l_orderkey < 100",
    "interval_scaled": "select o_orderdate, (timestamp '2021-01-01 00:00:00' - "
                       "cast(o_orderdate as timestamp)) * 2 from orders where o_orderkey < 40",
    "real_filter": "select count(*) from lineitem where cast(l_tax as real) > 0.04 "
                   "and cast(l_discount as real) <= cast(l_tax as real)",
    "real_keys": "select cast(l_discount as real) d, count(*), sum(l_quantity) from lineitem "
                 "group by 1 order by 1",
    "real_in": "select count(*) from lineitem where cast(l_discount as real) in "
               "(0.05e0, 0.1e0)",
    "tinyint_window": "select l_orderkey, cast(l_linenumber as tinyint) ln, "
                      "max(cast(l_linenumber as tinyint)) over (partition by l_orderkey), "
                      "lag(cast(l_quantity as real)) over (partition by l_orderkey "
                      "order by l_linenumber) from lineitem where l_orderkey < 200",
}


@pytest.mark.parametrize("name", sorted(SQL))
def test_statement_equals_reference(name):
    _pair().check(SQL[name])


def test_suite_assertions_hold_through_the_port():
    """The reference suites' own assertions on these statements, held
    against the port's rows."""
    import datetime

    port = _pair().port
    td = datetime.timedelta

    def one(sql):
        return port.execute(sql).rows

    assert one(SQL["interval_literal"]) == [(td(days=3),)]
    assert one(SQL["interval_sum_of_literals"]) == [(td(seconds=120),)]
    n = one("select count(*) from nation")[0][0]
    assert one(SQL["interval_sum_avg"]) == [(td(hours=12) * n, td(hours=12))]
    assert one(SQL["interval_months"]) == [(14,)]
    assert one(SQL["date_difference_max"]) == [(td(days=2),)]
    assert one(SQL["real_in_row_field"])[0][0] == 1.5
    assert one(SQL["real_in_row"])[0][0] == (1.5,)
    assert one(SQL["values_unnest_window"]) == [(1, 1, 1), (1, 3, 2), (2, 2, 1)]
    assert one(SQL["values_ragged_arrays"]) == [(1, [3, 1]), (2, [2])]


def test_out_of_range_cast_equals_the_reference_at_run_time():
    """test_kernel_soundness.py's lossy cast: the reference's static
    kernel-soundness gate refuses it at plan time (the port has no such
    gate: the reference's ``analysis`` package is not ported); with that
    gate off, the reference's rows, a NULL where the value does not fit,
    equal the port's."""
    from presto_tpu.analysis import set_kernel_validation
    from presto_tpu.analysis.kernel_soundness import KernelSoundnessError

    sql = "select cast(x as smallint) from (values (40000), (-7)) t(x)"
    pair = _pair()
    with pytest.raises(KernelSoundnessError, match="lossy-cast"):
        pair.ref.execute(sql)
    set_kernel_validation(False)
    try:
        pair.check(sql)
    finally:
        set_kernel_validation(None)
    assert pair.port.execute(sql).rows == [(None,), (-7,)]


@pytest.mark.parametrize("sql,what", [
    ("select cast(l_extendedprice as decimal(38,2)) - l_tax from lineitem", None),
    ("select max(l_quantity, 3) from lineitem", None),
    ("select round(cast(l_tax as real), 1) from lineitem", "round of real"),
    ("select min_by(l_orderkey, cast(l_tax as real)) from lineitem", "min_by over real"),
    ("select checksum(cast(l_linenumber as smallint)) from lineitem", "checksum over smallint"),
    ("select cast(cast(l_tax as real) as decimal(10,2)) from lineitem",
     "coercion of real to decimal(10,2)"),
], ids=["decimal38", "max_n", "round_real", "min_by_real", "checksum_smallint",
        "real_to_decimal"])
def test_families_left_out_raise_by_name(sql, what):
    """What this slice leaves out raises NotPorted with its family's name;
    what a later slice ported (``what`` None: max(x, n), the twelfth
    slice; DECIMAL(38), the thirteenth) equals the reference."""
    if what is None:
        _pair().check(sql)
        return
    with pytest.raises(NotPorted) as e:
        _pair().port.execute(sql)
    assert e.value.what == what
