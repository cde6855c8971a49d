"""The port's first two slices end to end: TPC-H Q6, Q1, Q14 and Q3
from SQL to rows on the CPU, equal to the JAX reference row for row,
and no silent paths out of the ported slices (the third slice's
queries are in test_torch_tpch_joins.py)."""

import ast
import pathlib
import subprocess
import sys

import pytest
import torch

from presto_tpu.testing import LocalQueryRunner as RefRunner
from presto_tpu_torch import NotPorted
from presto_tpu_torch.exec.local import QueryStats
from presto_tpu_torch.testing import LocalQueryRunner as PortRunner
from tpch_queries import QUERIES

ROOT = pathlib.Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def runners():
    return RefRunner(sf=0.01), PortRunner(sf=0.01, device="cpu")


@pytest.mark.parametrize("q", [6, 1])
def test_query_equals_reference(runners, q):
    ref, port = runners
    want = ref.execute(QUERIES[q])
    got = port.execute(QUERIES[q])
    assert got.names == want.names
    assert [str(t) for t in got.types] == [str(t) for t in want.types]
    assert got.rows == want.rows  # ORDER BY order, Decimal for Decimal
    assert got.rows


def test_memory_connector_path_and_stats(runners):
    """bench.py's shape: lineitem loaded into a MemoryConnector first;
    per-operator actuals recorded."""
    from presto_tpu_torch.catalog import Catalog
    from presto_tpu_torch.connectors.memory import MemoryConnector
    from presto_tpu_torch.connectors.tpch import Tpch
    from presto_tpu_torch.runner import QueryRunner

    mem = MemoryConnector(device="cpu")
    mem.load_from(Tpch(sf=0.01, split_rows=1 << 12), "lineitem",
                  columns=["l_quantity", "l_extendedprice", "l_discount", "l_tax",
                           "l_returnflag", "l_linestatus", "l_shipdate"])
    catalog = Catalog()
    catalog.register("tpch", mem)
    stats = QueryStats()
    runner = QueryRunner(catalog, device="cpu")
    got = runner.execute(QUERIES[1], stats=stats)
    assert got.rows == runners[0].execute(QUERIES[1]).rows
    assert mem.row_count("lineitem") == 60135
    assert stats.actual_rows(runner.plan(QUERIES[1])) == len(got.rows) == 4


def test_query_outside_the_slice_raises(runners):
    """max_by(x, y, n), refused here until the twelfth slice ported it,
    now equals the reference, keys tied across splits included (the
    partials merge in the reference runner's order)."""
    ref, port = runners
    sql = ("select l_returnflag, max_by(l_orderkey, l_quantity, 2) from lineitem "
           "group by l_returnflag order by 1")
    got = port.execute(sql).rows
    assert got == ref.execute(sql).rows and len(got) == 3


@pytest.mark.parametrize("flag", ["null_safe_keys", "null_aware", "use_index"])
def test_join_forms_outside_the_slice_raise(runners, flag):
    """Q14's join with null-safe keys (INTERSECT/EXCEPT) or null-aware
    keys (NOT IN), once refused, now runs and equals the reference
    running the same join; an index lookup is still refused by the
    executor before any build runs."""
    import dataclasses

    from presto_tpu.planner.plan import JoinNode as RefJoinNode
    from presto_tpu_torch.planner.plan import JoinNode

    ref, port = runners
    node = port.plan(QUERIES[14])
    while not isinstance(node, JoinNode):
        node = node.sources[0]
    assert port.execute(QUERIES[14]).rows  # the join as planned runs
    changed = dataclasses.replace(node, **{flag: True})
    if flag == "use_index":
        with pytest.raises(NotPorted):
            port.executor.run_to_page(changed)
        return
    ref_node = ref.plan(QUERIES[14])
    while not isinstance(ref_node, RefJoinNode):
        ref_node = ref_node.sources[0]
    want = ref.executor.run_to_page(dataclasses.replace(ref_node, **{flag: True}))
    got = port.executor.run_to_page(changed).to_pylist()
    assert got == want.to_pylist()
    assert len(got) > 100


def test_non_query_statement_raises(runners):
    with pytest.raises(NotPorted):
        runners[1].execute("CREATE TABLE t AS SELECT 1 AS x")


def test_default_device_is_cuda():
    if torch.cuda.is_available():
        assert PortRunner(sf=0.01).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            PortRunner(sf=0.01)


def _port_sources():
    files = sorted((ROOT / "presto_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 20
    return files


def test_port_imports_no_jax_and_no_reference():
    for path in _port_sources():
        for node in ast.walk(ast.parse(path.read_text(), str(path))):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for name in names:
                top = name.split(".")[0]
                assert top not in ("jax", "jaxlib", "presto_tpu"), f"{path}: {name}"


def test_importing_the_port_leaves_the_reference_unloaded():
    mods = sorted(".".join(p.relative_to(ROOT).with_suffix("").parts)
                  for p in (ROOT / "presto_tpu_torch").rglob("*.py"))
    mods = [m[:-len(".__init__")] if m.endswith(".__init__") else m for m in mods]
    code = ("import importlib, sys\n"
            f"for m in {mods!r}: importlib.import_module(m)\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'presto_tpu')]\n"
            "assert not bad, bad\n")
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True, timeout=300)


@pytest.mark.parametrize("q", [14, 3])
def test_join_query_equals_reference(runners, q):
    """Q3 row for row in order, Decimal for Decimal; Q14's double to a
    relative 1e-9."""
    ref, port = runners
    want = ref.execute(QUERIES[q])
    got = port.execute(QUERIES[q])
    assert got.names == want.names
    assert [str(t) for t in got.types] == [str(t) for t in want.types]
    assert len(got.rows) == len(want.rows) > 0
    for g, w in zip(got.rows, want.rows):
        assert g == pytest.approx(w, rel=1e-9) if q == 14 else g == w


def test_topn_over_many_splits_equals_reference(runners):
    """A TopN straight over lineitem's splits: the fold ranks each split
    with the rows kept so far, ties (equal prices) broken by position."""
    sql = ("select l_orderkey, l_linenumber, l_extendedprice from lineitem "
           "order by l_extendedprice desc, l_shipdate limit 12")
    ref, port = runners
    assert port.execute(sql).rows == ref.execute(sql).rows


def _dup_pk_catalogs():
    """The same two tables in both packages: ``dim`` declares ``k`` its
    primary key but holds the key 7 twice."""
    import numpy as np

    from presto_tpu.catalog import Catalog as RefCatalog
    from presto_tpu.connectors.memory import MemoryConnector as RefMemory
    from presto_tpu.page import Page as RefPage
    from presto_tpu.types import parse_type as ref_type
    from presto_tpu_torch.catalog import Catalog
    from presto_tpu_torch.connectors.memory import MemoryConnector
    from presto_tpu_torch.page import Page
    from presto_tpu_torch.types import parse_type

    rng = np.random.default_rng(0)
    dim_k = np.arange(1, 301, dtype=np.int64)
    dim_k[150] = 7
    dim_v = rng.integers(0, 1000, 300)
    fact_k = rng.integers(0, 320, 5000)
    fact_x = rng.integers(-50, 50, 5000)
    catalogs = []
    for cat_cls, mem_cls, page_cls, pt, kw in (
            (RefCatalog, RefMemory, RefPage, ref_type, {}),
            (Catalog, MemoryConnector, Page, parse_type, {"device": "cpu"})):
        mem = mem_cls(**kw)
        mem.create_table("dim", [("k", pt("bigint")), ("v", pt("bigint"))],
                         [page_cls.from_arrays([dim_k, dim_v], [pt("bigint")] * 2, **kw)],
                         domains={"k": (1, 300)}, primary_key=["k"])
        mem.create_table("fact", [("fk", pt("bigint")), ("x", pt("bigint"))],
                         [page_cls.from_arrays([fact_k[:2500], fact_x[:2500]],
                                               [pt("bigint")] * 2, **kw),
                          page_cls.from_arrays([fact_k[2500:], fact_x[2500:]],
                                               [pt("bigint")] * 2, **kw)],
                         domains={"fk": (0, 319)})
        cat = cat_cls()
        cat.register("mem", mem)
        catalogs.append(cat)
    return catalogs


def test_broken_primary_key_rebuilds_sorted_and_equals_reference(monkeypatch):
    from presto_tpu.runner import QueryRunner as RefQueryRunner
    from presto_tpu_torch.exec import local
    from presto_tpu_torch.planner.plan import JoinNode
    from presto_tpu_torch.runner import QueryRunner

    builds = []

    def spy(page, keys, key_domains=None, unique=False, **kw):
        out = real(page, keys, key_domains=key_domains, unique=unique, **kw)
        builds.append((unique, None if out.unique_ok is None else bool(out.unique_ok)))
        return out

    real = local.build_join
    monkeypatch.setattr(local, "build_join", spy)

    ref_cat, port_cat = _dup_pk_catalogs()
    sql = ("select f.fk, f.x, d.v from fact f join dim d on f.fk = d.k "
           "order by f.x, f.fk, d.v")
    ref = RefQueryRunner(ref_cat)
    port = QueryRunner(port_cat, device="cpu")
    plan = port.plan(sql)
    stack, joins = [plan], []
    while stack:
        node = stack.pop()
        joins += [node] if isinstance(node, JoinNode) else []
        stack.extend(node.sources)
    assert joins and all(j.unique_build for j in joins)  # the promise the data breaks
    got = port.execute(sql).rows
    assert builds == [(True, False), (False, None)]  # unique, broken; then sorted
    assert got == ref.execute(sql).rows
    assert any(r[0] == 7 for r in got)


def test_memory_connector_join_path(runners):
    """bench.py's shape for Q3 and Q14: orders, customer and part loaded
    into a MemoryConnector with their key domains and primary keys."""
    from presto_tpu_torch.catalog import Catalog
    from presto_tpu_torch.connectors.memory import MemoryConnector
    from presto_tpu_torch.connectors.tpch import Tpch
    from presto_tpu_torch.runner import QueryRunner

    tpch = Tpch(sf=0.01, split_rows=1 << 12)
    mem = MemoryConnector(device="cpu")
    for table, cols in (
            ("lineitem", ["l_orderkey", "l_partkey", "l_extendedprice", "l_discount",
                          "l_shipdate"]),
            ("orders", ["o_orderkey", "o_custkey", "o_orderdate", "o_shippriority"]),
            ("customer", ["c_custkey", "c_mktsegment"]), ("part", ["p_partkey", "p_type"])):
        mem.load_from(tpch, table, columns=cols)
    assert mem.primary_key("orders") == ["o_orderkey"]
    assert mem.primary_key("part") == ["p_partkey"]
    assert mem.column_domain("orders", "o_orderkey") == tpch.column_domain(
        "orders", "o_orderkey")
    catalog = Catalog()
    catalog.register("tpch", mem)
    runner = QueryRunner(catalog, device="cpu")
    for q in (3, 14):
        assert runner.execute(QUERIES[q]).rows == runners[1].execute(QUERIES[q]).rows
