"""The sixth slice's aggregates end to end: sum0 and sums collapsed to
a short decimal (the mixed-DISTINCT rewrite: TPC-DS q16, q28, q95),
``stddev_samp`` (q17, q39) and q23 (LIMIT over a union) through the port
on the CPU, equal to the JAX reference row for row (``TpcdsPair``);
q17 also against the sqlite oracle; and the binder's approx_percentile
and numeric_histogram rewrites, which now run where the port has what
they reach and otherwise name what they lack."""

import math

import pytest

from presto_tpu_torch import NotPorted
from tpcds_queries import ORACLE_OVERRIDES, QUERIES
from torch_parity import TPCDS_ARGS, TpcdsPair

AGGS = [16, 28, 95, 17, 39, 23]

VARIANCE = """
select i_category, count(ss_quantity) n, stddev(ss_quantity) s, stddev_pop(ss_net_paid) sp,
       variance(ss_sales_price) v, var_pop(ss_quantity) vp, var_samp(ss_wholesale_cost) vs
from store_sales, item
where ss_item_sk = i_item_sk
group by i_category
order by i_category
"""


@pytest.fixture(scope="module")
def pair():
    return TpcdsPair()


@pytest.mark.parametrize("q", AGGS)
def test_aggregate_query_equals_reference(pair, q):
    pair.check(QUERIES[q])


def test_variance_family_equals_reference(pair):
    assert pair.check(VARIANCE)


def test_q17_matches_reference_and_oracle(pair):
    """q17 at sf 0.01: 16 groups, each of one row, so every
    stddev_samp and the ratios over it are NULL.  The port's rows
    equal the reference's, and equal the sqlite oracle's once the
    oracle's ``sqrt`` takes NULL: as tests/oracle.py registers it
    (``math.sqrt``), it raises on the NULL that the closed form gives a
    one-row group (a zero divisor), which is why the reference's
    ``test_tpcds_query[17]`` fails at the oracle, not in the engine."""
    import sqlite3

    from presto_tpu.connectors.tpcds import Tpcds
    from oracle import assert_rows_match, translate
    from test_tpcds_queries import load_tpcds_oracle

    rows = pair.check(QUERIES[17])
    assert len(rows) == 16 and all(r[5] is None for r in rows)
    oracle = load_tpcds_oracle(Tpcds(**TPCDS_ARGS))
    sql = translate(ORACLE_OVERRIDES.get(17, QUERIES[17]))
    with pytest.raises(sqlite3.OperationalError):
        oracle.execute(sql).fetchall()
    oracle.create_function("sqrt", 1, lambda x: None if x is None else math.sqrt(x))
    assert_rows_match(rows, [tuple(r) for r in oracle.execute(sql).fetchall()], ordered=False)


# the rewrites of approx_percentile and numeric_histogram: the weighted
# form runs (a running-sum window, then min over an IF), and since the
# eighth slice the unweighted one (cast_bigint) and the weighted one
# over a double (min over double); numeric_histogram, once stopped at
# map_agg (containers), runs since the tenth slice ported map_agg
PERCENTILE_ROWS = [
    "select approx_percentile(ss_quantity, ss_item_sk, 0.5) from store_sales",
    "select s_state, approx_percentile(ss_sales_price, ss_quantity, 0.9) p "
    "from store_sales, store where ss_store_sk = s_store_sk group by s_state order by s_state",
]
FORMER_GAPS = {
    "approx_percentile": "select approx_percentile(ss_quantity, 0.5) from store_sales",
    "approx_percentile_weighted_double":
        "select approx_percentile(ss_quantity * 1.5e0, ss_item_sk, 0.5) from store_sales",
}
REWRITE_GAPS = {
    "numeric_histogram": ("select numeric_histogram(4, ss_quantity) from store_sales",
                          "aggregate map_agg"),
}


@pytest.mark.parametrize("sql", PERCENTILE_ROWS)
def test_weighted_percentile_equals_reference(pair, sql):
    assert pair.check(sql)


@pytest.mark.parametrize("name", sorted(FORMER_GAPS))
def test_former_gap_equals_reference(pair, name):
    assert pair.check(FORMER_GAPS[name])


@pytest.mark.parametrize("name", sorted(REWRITE_GAPS))
def test_rewrites_name_what_they_lack(pair, name):
    """Pinned as NotPorted ("aggregate map_agg") until map_agg was
    ported; the rewrite now equals the reference."""
    sql, what = REWRITE_GAPS[name]
    assert what == "aggregate map_agg"
    assert pair.check(sql)
