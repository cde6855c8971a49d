"""The port's fifth slice end to end: TPC-DS from SQL to rows on the
CPU, equal to the JAX reference row for row over the same generated
data (sf 0.01, customer_demographics and inventory cut as the
reference's TPC-DS test cuts them).

The slice's queries: q3 and q7 (the bench's; q7's ``avg`` of an integer
is a double), the windowed q12, q20, q98 (``sum(sum(x)) over
(partition by ...)`` and a double ratio), q53, q63, q89 (``avg(sum(x))
over``, ``abs(decimal - double) / double``; q89 a double top-100), q44
(``rank()`` twice under a HAVING against a scalar subquery), q47, q57
(``rank()`` and ``avg`` over two specs, the windowed CTE self-joined),
q51 (running sums in a ROWS frame under a FULL OUTER join); q13, whose
predicate reads nine dictionary tables; and the other queries that
double lanes and the double ``avg`` unblock.  What the port still
lacks is held to raise :class:`NotPorted` by name.  The 42 queries
the port ran before this slice are in ``test_torch_tpcds_corpus.py``.
"""

import pytest

from presto_tpu_torch import NotPorted
from tpcds_queries import QUERIES
from torch_parity import TpcdsPair

SLICE = [3, 7, 12, 20, 98, 53, 63, 89, 44, 47, 57, 51]
# unblocked by the same pieces: double lanes (q21, q31, q58, q73, q83),
# the double avg (q26, q35, q85), K1's table limit (q13)
ALSO = [13, 21, 26, 31, 35, 58, 73, 83, 85]

# every one of the 99 queries now runs (the sixth slice's 37 are in
# test_torch_tpcds_{union,groupid,strings,aggs}.py); what the port still
# lacks raises NotPorted by name
NOT_PORTED = {
    "ordered_string_column_comparison": (
        "select count(*) from customer where c_first_name < c_last_name",
        "ordered comparison (lt) of two string columns"),
    "min_over_double": ("select min(ss_quantity * 1.5e0) from store_sales", "min over double"),
    "max_over_varchar": ("select max(s_state) from store", "max over varchar"),
    "pushed_down_limit_scan": ("select ss_item_sk from store_sales limit 3",
                               "TABLESAMPLE and pushed-down LIMIT scans"),
    "cast_bigint": ("select cast(ss_sales_price as bigint) c from store_sales "
                    "where ss_quantity > 3", "expression cast_bigint"),
}


@pytest.fixture(scope="module")
def pair():
    return TpcdsPair()


@pytest.mark.parametrize("q", SLICE + ALSO)
def test_query_equals_reference(pair, q):
    pair.check(QUERIES[q])


@pytest.mark.parametrize("q", sorted(NOT_PORTED))
def test_query_outside_the_port_raises(pair, q):
    sql, what = NOT_PORTED[q]
    with pytest.raises(NotPorted) as e:
        pair.port.execute(sql)
    assert e.value.what == what
