"""The mesh tier (``presto_tpu_torch/parallel/dist.py``) on an 8-shard
CPU mesh against the reference's ``DistributedRunner`` on the 8 virtual
XLA host devices (``tests/conftest.py``) and against the port's local
runner, over ``Tpch(sf=0.01, split_rows=4096)``: the scenarios of
``tests/test_distributed.py``.  Integers, decimals and strings match
exactly; doubles within a relative 1e-9 of the reference's (its own
stage tolerance) and 1e-12 of the port's local run."""

import pytest

import torch_parity  # noqa: F401  (one torch thread per process)
from presto_tpu.catalog import Catalog as RefCatalog
from presto_tpu.parallel.dist import DistributedRunner as RefDist
from presto_tpu.parallel.dist import make_mesh as ref_mesh
from presto_tpu.runner import QueryRunner as RefRunner
from presto_tpu_torch.parallel.dist import DistributedRunner
from presto_tpu_torch.parallel.mesh import make_mesh
from presto_tpu_torch.runner import QueryRunner
from presto_tpu_torch.testing import tpch_catalog
from torch_mesh_parity import Side, check_mesh, match_rows, make_sides
from tpch_queries import QUERIES


@pytest.fixture(scope="module")
def env():
    return make_sides()


@pytest.fixture(scope="module")
def env_partitioned():
    # threshold 0: every join takes the partitioned-exchange path
    return make_sides(broadcast_threshold=0)


@pytest.mark.parametrize("q", [6, 1, 14, 3])
def test_broadcast_queries(env, q):
    got = check_mesh(env, QUERIES[q])
    assert got.rows


@pytest.mark.parametrize("q", [3, 9])
def test_partitioned_joins(env_partitioned, q):
    """Build sides sharded across the mesh, the probe rows exchanged on
    the join key inside the wave (K21's twin)."""
    from presto_tpu_torch.kernels import exchange_partition as k21

    calls = []
    plain = k21.partition_plain

    def counted(*args):
        calls.append(1)
        return plain(*args)

    k21.partition_plain = counted
    try:
        check_mesh(env_partitioned, QUERIES[q])
    finally:
        k21.partition_plain = plain
    assert calls


def _joins(plan):
    from presto_tpu_torch.planner.plan import JoinNode

    out = []

    def walk(n):
        if isinstance(n, JoinNode):
            out.append(n)
        for s in n.sources:
            walk(s)

    walk(plan)
    return out


def test_partitioned_join_capacity_retry(env_partitioned):
    """Undersized exchange buckets are detected by their fills and
    retried, never silently truncated."""
    ref, port = env_partitioned
    sql = QUERIES[3]
    plan = port.local.plan(sql)
    joins = _joins(plan)
    assert joins
    for j in joins:  # deliberately far too small
        port.dist._join_cfg[j] = {"bucket_cap": 16}
    got = port.dist.run(plan)
    match_rows(got.rows, ref.expected(sql), 1e-9, what="reference local")
    match_rows(got.rows, port.expected(sql), 1e-12, what="port local")
    assert any(port.dist._join_cfg[j]["bucket_cap"] > 16 for j in joins)


def test_aggregation_exchange_sized_from_the_count(env):
    """A grouping of 1000 keys a shard exchanges its partial states in
    buckets sized from their count (K21's twin drops nothing)."""
    from presto_tpu_torch.kernels import exchange_partition as k21

    ref, port = env
    sql = "select o_custkey, count(*), sum(o_totalprice) from orders group by o_custkey"
    seen = []
    plain = k21.partition_plain

    def spy(key, targets, row_mask, n_parts, bucket_cap, cols):
        out = plain(key, targets, row_mask, n_parts, bucket_cap, cols)
        seen.append((int(out[2]), bucket_cap))
        return out

    k21.partition_plain = spy
    try:
        got = port.run(sql)
    finally:
        k21.partition_plain = plain
    assert seen and all(fill <= cap for fill, cap in seen)
    match_rows(got.rows, ref.run(sql).rows, 1e-9, what="reference mesh")
    match_rows(got.rows, port.expected(sql), 1e-12, what="port local")


def _walk(plan):
    yield plan
    for s in plan.sources:
        yield from _walk(s)


COLOCATED_SQL = """
SELECT o_orderpriority, count(*) AS c, sum(l_extendedprice) AS s
FROM orders, lineitem
WHERE l_orderkey = o_orderkey AND o_orderdate >= DATE '1995-01-01'
GROUP BY o_orderpriority
ORDER BY o_orderpriority
"""


def test_colocated_join():
    """Bucket-aligned orders and lineitem (``tests/test_colocated.py``'s
    query) join with neither side moving."""
    env = make_sides(split_rows=1 << 11, aligned=True)
    ref, port = env
    plan = port.local.plan(COLOCATED_SQL)
    assert "colocated" in {port.dist._join_mode(j) for j in _joins(plan)}
    check_mesh(env, COLOCATED_SQL, ordered=True)


CHAIN_SQL = [
    # filter + sort + limit
    "SELECT l_orderkey, l_quantity FROM lineitem WHERE l_quantity > 45 "
    "ORDER BY l_orderkey, l_quantity, l_extendedprice LIMIT 25",
    # streaming join chain, no aggregation
    "SELECT o_orderkey, c_name FROM orders, customer "
    "WHERE o_custkey = c_custkey AND o_totalprice > 100000.0 "
    "ORDER BY o_orderkey LIMIT 30",
    # bare projection chain
    "SELECT l_orderkey + 1 AS k FROM lineitem WHERE l_linenumber = 7 "
    "ORDER BY k LIMIT 15",
]


@pytest.mark.parametrize("i", range(len(CHAIN_SQL)))
def test_chain_without_aggregation(i):
    env = make_sides(sf=0.005, split_rows=1 << 10)
    got = check_mesh(env, CHAIN_SQL[i], ordered=True)
    assert got.rows


@pytest.fixture(scope="module")
def env_general(env):
    _, port = env
    ref, _ = env
    port.dist.min_stage_rows = ref.dist.min_stage_rows = 0  # small pages still shard
    yield env
    port.dist.min_stage_rows = ref.dist.min_stage_rows = 1 << 13


GENERAL_SQL = {
    "multi_level_aggregation": (
        "SELECT max(c) AS mx, min(ok) AS mn, count(*) AS n FROM "
        "(SELECT o_custkey AS ok, count(*) AS c FROM orders GROUP BY o_custkey)", 2),
    "union_arms": (
        "SELECT count(*) AS n, sum(k) AS s FROM ("
        "SELECT o_orderkey AS k FROM orders WHERE o_orderkey % 2 = 0 "
        "UNION ALL "
        "SELECT l_orderkey AS k FROM lineitem WHERE l_linenumber = 1)", 3),
    "window_glue": (
        "SELECT count(*) AS n, max(rnk) AS top FROM ("
        "  SELECT o_custkey, rank() OVER (ORDER BY c DESC) AS rnk FROM ("
        "    SELECT o_custkey, count(*) AS c FROM orders GROUP BY o_custkey))"
        " WHERE rnk <= 10", 1),
}


@pytest.mark.parametrize("name", sorted(GENERAL_SQL))
def test_general_stage_decomposition(env_general, name):
    sql, stages = GENERAL_SQL[name]
    check_mesh(env_general, sql, min_stages=stages)


def test_tpcds_q7_distributes():
    """A TPC-DS star join through the general decomposition."""
    from presto_tpu.connectors.tpcds import Tpcds as RefTpcds
    from presto_tpu_torch.testing import tpcds_catalog
    from tpcds_queries import QUERIES as DS

    args = dict(sf=0.002, split_rows=512, cd_rows=2 * 5 * 7 * 4, inv_rows=2000)
    cat = RefCatalog()
    cat.register("tpcds", RefTpcds(**args))
    ref_local = RefRunner(cat)
    ref = Side(ref_local, RefDist(cat, ref_mesh(8)))
    pcat = tpcds_catalog(**args)
    port = Side(QueryRunner(pcat, device="cpu"), DistributedRunner(pcat, make_mesh(8, device="cpu")))
    ref.dist.min_stage_rows = port.dist.min_stage_rows = 0
    check_mesh((ref, port), DS[7], ordered=True)


def test_fallback_is_loud(env):
    """An undistributable plan falls back with its reason recorded."""
    ref, port = env
    sql = "SELECT * FROM (VALUES (1, 'a'), (2, 'b')) t(x, y)"
    got = port.run(sql)
    want = ref.run(sql)
    assert got.rows == want.rows and len(got.rows) == 2
    assert port.dist.last_stage_count == 0 and got.dist_stages == 0
    assert port.dist.last_fallback_reason == ref.dist.last_fallback_reason
    assert got.dist_fallback == port.dist.last_fallback_reason
    check_mesh(env, "select count(*) from (select o_orderkey from orders limit 5)")


def test_explain_distributed_equals_reference(env):
    from presto_tpu.parallel.fragment import explain_distributed as ref_explain
    from presto_tpu_torch.parallel.fragment import explain_distributed

    ref, port = env
    for sql in (QUERIES[3], QUERIES[9], "SELECT * FROM (VALUES (1), (2)) t(x)"):
        for threshold in (1 << 16, 0):
            want = ref_explain(ref.local.plan(sql), threshold)
            got = explain_distributed(port.local.plan(sql), threshold)
            assert got == want
    assert port.local.explain_distributed(QUERIES[3]).startswith("FRAGMENTED: yes")
    assert "coordinator" in port.local.explain_distributed("SELECT * FROM (VALUES (1)) t(x)")


def test_per_shard_topn_bound(env):
    """A TopN consumer bounds each shard's gather to its count, and the
    fragment advertises it."""
    from presto_tpu_torch.parallel.fragment import fragment_plan

    sql = ("select l_orderkey, l_extendedprice from lineitem "
           "where l_quantity > 10 order by l_extendedprice desc, l_orderkey limit 5")
    got = check_mesh(env, sql, ordered=True)
    assert len(got.rows) == 5
    bounds = []

    def walk(f):
        bounds.append(f.shard_bound)
        for c in f.children:
            walk(c)

    walk(fragment_plan(env[1].local.plan(sql)))
    assert 5 in bounds


def test_per_shard_limit_bound(env):
    _, port = env
    sql = "select l_orderkey from lineitem where l_quantity > 30 limit 7"
    got = port.run(sql)
    assert port.dist.last_fallback_reason is None and got.dist_stages >= 1
    assert len(got.rows) == 7
    keys = {r[0] for r in port.local.execute(
        "select l_orderkey from lineitem where l_quantity > 30").rows}
    assert all(r[0] in keys for r in got.rows)


def test_set_session_distributed_runs_q1_on_the_mesh():
    """``SET SESSION distributed = true`` routes the QueryRunner's q1
    through an 8-shard mesh (``hash_partition_count``)."""
    r = QueryRunner(tpch_catalog(sf=0.01, split_rows=4096), device="cpu")
    want = r.execute(QUERIES[1]).rows
    assert r.execute("SET SESSION distributed = true").rows == [("SET SESSION",)]
    r.execute("SET SESSION hash_partition_count = 8")
    got = r.execute(QUERIES[1])
    assert got.dist_fallback is None and got.dist_stages >= 1
    assert r._distributed().n == 8
    match_rows(got.rows, want, 1e-12)
    r.execute("SET SESSION distributed = false")
    assert not hasattr(r.execute(QUERIES[6]), "dist_stages")


def test_subplan_cache_is_not_ported(env):
    from presto_tpu_torch import NotPorted

    _, port = env
    port.dist.subplan_cache_enabled = True
    try:
        with pytest.raises(NotPorted, match="subplan cache"):
            port.run(QUERIES[6])
    finally:
        port.dist.subplan_cache_enabled = False


def test_tablesample_scan_falls_back_known_fault(env):
    """A fault of the reference's mesh tier: its waves read whole splits
    and drop the scan's sample, so a sampled count is the table's; the
    port falls back to the local runner, loudly, and keeps the sample."""
    ref, port = env
    sql = "select count(*) from lineitem tablesample bernoulli (10)"
    got = port.run(sql)
    assert got.dist_fallback == "TABLESAMPLE scan"
    assert got.rows == port.expected(sql) == ref.expected(sql)
    assert ref.run(sql).rows == ref.expected("select count(*) from lineitem")
