"""The TPC-DS queries the port answered before its window functions and
double lanes, end to end on the CPU, equal to the JAX reference row for
row over the same generated data (``test_torch_tpcds.py`` holds the
fifth slice's queries and the ones still outside the port).

On the card: q3 since the fifth slice; every other query here since the
seventh (``chip_smoke.py`` ``DS3_QUERIES``: at SF10, q72 at a cut
scale, rows checked against the CPU at SF 1)."""

import pytest

from tpcds_queries import QUERIES
from torch_parity import TpcdsPair

BEFORE = [1, 3, 9, 10, 15, 24, 25, 29, 30, 32, 34, 37, 38, 41, 42, 43, 45, 48, 50, 52, 55,
          59, 61, 62, 64, 65, 69, 72, 79, 81, 82, 84, 87, 88, 90, 91, 92, 93, 94, 96, 97, 99]


@pytest.fixture(scope="module")
def pair():
    return TpcdsPair()


@pytest.mark.parametrize("q", BEFORE)
def test_query_equals_reference(pair, q):
    pair.check(QUERIES[q])
