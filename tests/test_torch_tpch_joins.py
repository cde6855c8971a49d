"""The port's third slice end to end: TPC-H Q4, Q5, Q10, Q12, Q13, Q16,
Q19 and Q20 (every join form, hashed group keys, IN) from SQL to rows
on the CPU, equal to the JAX reference row for row; and the join forms
no TPC-H query uses (FULL OUTER, a mark join for EXISTS under OR)."""

import pytest

from presto_tpu.testing import LocalQueryRunner as RefRunner
from presto_tpu_torch.testing import LocalQueryRunner as PortRunner
from tpch_queries import QUERIES

# Q20 at sf 0.01 returns one supplier in CANADA; without the nation
# filter its semi joins pass many more rows
Q20_ALL_NATIONS = QUERIES[20].replace("and n_name = 'CANADA'", "")
assert Q20_ALL_NATIONS != QUERIES[20]

FULL_OUTER = """
select n_name, r_name, n_regionkey, r_regionkey
from (select * from nation where n_regionkey <> 3) n
full outer join (select * from region where r_regionkey <> 1) r
    on n_regionkey = r_regionkey
order by n_name, r_name
"""
EXISTS_UNDER_OR = """
select c_custkey, c_nationkey
from customer
where c_nationkey = 3
    or exists (select 1 from orders where o_custkey = c_custkey
               and o_totalprice > 300000)
order by c_custkey
"""


@pytest.fixture(scope="module")
def runners():
    return RefRunner(sf=0.01), PortRunner(sf=0.01, device="cpu")


def _equal(got, want, rel_doubles=True):
    assert got.names == want.names
    assert [str(t) for t in got.types] == [str(t) for t in want.types]
    assert len(got.rows) == len(want.rows) > 0
    doubles = [i for i, t in enumerate(want.types) if str(t) == "double"]
    for g, w in zip(got.rows, want.rows):
        if doubles and rel_doubles:
            assert [x for i, x in enumerate(g) if i not in doubles] == \
                [x for i, x in enumerate(w) if i not in doubles]
            assert [g[i] for i in doubles] == pytest.approx([w[i] for i in doubles],
                                                            rel=1e-9)
        else:
            assert g == w  # Decimal for Decimal, in ORDER BY order


@pytest.mark.parametrize("q", [4, 5, 10, 12, 13, 16, 19, 20])
def test_query_equals_reference(runners, q):
    ref, port = runners
    _equal(port.execute(QUERIES[q]), ref.execute(QUERIES[q]))


def test_q20_over_all_nations_equals_reference(runners):
    ref, port = runners
    want = ref.execute(Q20_ALL_NATIONS)
    assert len(want.rows) > 10
    _equal(port.execute(Q20_ALL_NATIONS), want)


@pytest.mark.parametrize("sql", [FULL_OUTER, EXISTS_UNDER_OR], ids=["full_outer", "mark"])
def test_join_forms_outside_tpch_equal_reference(runners, sql):
    from presto_tpu_torch.planner.plan import JoinNode

    ref, port = runners
    kinds, stack = set(), [port.plan(sql)]
    while stack:
        node = stack.pop()
        if isinstance(node, JoinNode):
            kinds.add(node.kind)
        stack.extend(node.sources)
    assert ("full" if sql is FULL_OUTER else "mark") in kinds
    _equal(port.execute(sql), ref.execute(sql))


def test_memory_connector_with_the_smoke_run_tables(runners):
    """chip_smoke.py's shape: the eight TPC-H tables, pruned to the
    columns its 22 queries read, loaded into a MemoryConnector with
    their domains, primary keys and sort orders; every query's rows,
    over those tables and over its own catalog of the columns its SQL
    names (``query_catalog``), equal the generator-backed runner's, and
    Q18 keeps its streaming aggregation there."""
    import importlib.util
    import pathlib

    from presto_tpu_torch.catalog import Catalog
    from presto_tpu_torch.connectors.memory import MemoryConnector
    from presto_tpu_torch.connectors.tpch import Tpch
    from presto_tpu_torch.runner import QueryRunner

    path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    tpch = Tpch(sf=0.01, split_rows=1 << 12)
    mem = MemoryConnector(device="cpu")
    for table, cols in smoke.TABLES.items():
        mem.load_from(tpch, table, columns=cols)
    assert mem.primary_key("partsupp") == ["ps_partkey", "ps_suppkey"]
    assert mem.column_domain("supplier", "s_suppkey") == tpch.column_domain(
        "supplier", "s_suppkey")
    catalog = Catalog()
    catalog.register("tpch", mem)
    runner = QueryRunner(catalog, device="cpu")
    assert len(smoke.QUERIES) == 22
    for label, sql in smoke.QUERIES.items():
        want = runners[1].execute(sql).rows
        assert runner.execute(sql).rows == want, label
        ordered = smoke.streamed_tables(runner.plan(sql))
        assert (label == "q18") == bool(ordered), label
        own = QueryRunner(smoke.query_catalog(mem, sql, ordered), device="cpu")
        assert own.execute(sql).rows == want, label
        if label == "q18":
            assert smoke.streamed_tables(own.plan(sql)) == {"lineitem"}
