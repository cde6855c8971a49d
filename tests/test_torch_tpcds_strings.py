"""The sixth slice's string work end to end: comparisons of two string
columns (TPC-DS q6, q8, q19, q46, q68: each side's codes into one
value-id space, K1's CANON twice and an integer comparison), string
CASE over a merged dictionary (q36, q70, q86) and coalesce (q40, q78)
through the port on the CPU, equal to the JAX reference row for row
(``TpcdsPair``)."""

import pytest

from tpcds_queries import QUERIES
from torch_parity import TpcdsPair

STRING_CMP = [6, 8, 19, 46, 68]
STRING_CASE = [36, 70, 86]
COALESCE = [40, 78]

EXTRA = {
    "case_over_two_columns": """
        select case when s_number_employees > 250 then s_state else s_city end place,
               count(*) c
        from store group by 1 order by 1""",
    "coalesce_strings": """
        select coalesce(c_first_name, c_last_name, 'none') n, count(*) c
        from customer where c_customer_sk < 300 group by 1 order by 1""",
    "columns_not_equal": """
        select count(*) from customer, customer_address
        where c_current_addr_sk = ca_address_sk and c_birth_country <> ca_country""",
}


@pytest.fixture(scope="module")
def pair():
    return TpcdsPair()


@pytest.mark.parametrize("q", STRING_CMP + STRING_CASE + COALESCE)
def test_string_query_equals_reference(pair, q):
    pair.check(QUERIES[q])


@pytest.mark.parametrize("name", sorted(EXTRA))
def test_string_expressions_equal_reference(pair, name):
    assert pair.check(EXTRA[name])
