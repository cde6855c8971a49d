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
double lanes and the double ``avg`` unblock.  Every query still outside
the port is held to raise :class:`NotPorted` by name.  The 42 queries
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

# what still stops each remaining query (ROADMAP queue A)
NOT_PORTED = {
    **{q: "plan node UnionNode" for q in (2, 4, 11, 33, 49, 54, 56, 60, 66, 71, 74, 75, 76)},
    **{q: "plan node GroupIdNode" for q in (5, 14, 18, 22, 27, 67, 77, 80)},
    **{q: "comparison of two string columns" for q in (6, 8, 19, 46, 68)},
    **{q: "dictionary of string expression case" for q in (36, 70, 86)},
    **{q: "sum collapsed to a short decimal (sum0 rewrite)" for q in (16, 95)},
    **{q: "aggregate stddev_samp" for q in (17, 39)},
    **{q: "expression coalesce" for q in (40, 78)},
    23: "plan node LimitNode",
    28: "aggregate sum0",
}


@pytest.fixture(scope="module")
def pair():
    return TpcdsPair()


@pytest.mark.parametrize("q", SLICE + ALSO)
def test_query_equals_reference(pair, q):
    pair.check(QUERIES[q])


@pytest.mark.parametrize("q", sorted(NOT_PORTED))
def test_query_outside_the_port_raises(pair, q):
    with pytest.raises(NotPorted) as e:
        pair.port.execute(QUERIES[q])
    assert e.value.what == NOT_PORTED[q]
