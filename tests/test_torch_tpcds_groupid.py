"""The sixth slice's ROLLUP / GROUPING SETS queries end to end: TPC-DS
q5, q14, q18, q22, q27, q67, q77 and q80 through the port on the CPU,
equal to the JAX reference row for row (``TpcdsPair``).  GroupId emits
each source page once per grouping set, page by page: K1 computes the
key columns, the set's inactive keys turn NULL, and a constant
``$group_id`` column is appended."""

import pytest

from tpcds_queries import QUERIES
from torch_parity import TpcdsPair

GROUPID = [5, 14, 18, 22, 27, 67, 77, 80]

GROUPING_SETS = """
select i_category, i_class, count(*) c, sum(ss_quantity) q
from store_sales, item
where ss_item_sk = i_item_sk and ss_quantity > 90
group by grouping sets ((i_category, i_class), (i_category), ())
order by i_category, i_class
"""


@pytest.fixture(scope="module")
def pair():
    return TpcdsPair()


@pytest.mark.parametrize("q", GROUPID)
def test_groupid_query_equals_reference(pair, q):
    pair.check(QUERIES[q])


def test_grouping_sets_equal_reference(pair):
    rows = pair.check(GROUPING_SETS)
    assert (None, None) in {r[:2] for r in rows}  # the grand total
