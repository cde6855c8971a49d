"""The sixth slice's UNION queries end to end: TPC-DS q2, q4, q11,
q33, q49, q54, q56, q60, q66, q71, q74, q75 and q76 through the port's
``QueryRunner`` on the CPU, equal to the JAX reference row for row over
the same generated data (``TpcdsPair``).  Each leg's pages move their
dictionary codes into the union's merged dictionaries; a varchar
column whose merged dictionary repeats a value across legs groups and
joins through K1's CANON.  Also LIMIT without ORDER BY and VALUES."""

import pytest

from tpcds_queries import QUERIES
from torch_parity import TpcdsPair

UNION = [2, 4, 11, 33, 49, 54, 56, 60, 66, 71, 74, 75, 76]

# a union whose legs carry different dictionaries, the first and last
# the same column, grouped by the merged column: a value repeats across
# legs and must come out as one group
REPEATED_KEY = """
select s, count(*) c, sum(v) v
from (select i_item_id s, i_current_price v from item
      union all
      select c_customer_id s, cast(c_birth_year as decimal(7,2)) v from customer
      union all
      select i_item_id s, i_current_price v from item where i_item_sk < 200) t
group by s
order by s
"""

OTHER_NODES = {
    "limit_without_order": "select ss_item_sk, ss_quantity from store_sales "
                           "where ss_quantity > 95 limit 7",
    "values": "select x, y, x * 2 from (values (1, 'a'), (2, 'b'), (3, null)) t(x, y)",
    "union_limit": "select d_date_sk from date_dim where d_year = 2000 union all "
                   "select d_date_sk from date_dim where d_year = 1999 limit 400",
}


@pytest.fixture(scope="module")
def pair():
    return TpcdsPair()


@pytest.mark.parametrize("q", UNION)
def test_union_query_equals_reference(pair, q):
    pair.check(QUERIES[q])


def test_group_key_repeated_across_legs_equals_reference(pair):
    rows = pair.check(REPEATED_KEY)
    keys = [r[0] for r in rows]
    assert len(keys) == len(set(keys))
    assert any(r[1] == 2 for r in rows)  # an item id from both item legs


@pytest.mark.parametrize("name", sorted(OTHER_NODES))
def test_limit_and_values_equal_reference(pair, name):
    rows = pair.check(OTHER_NODES[name])
    assert rows
