"""The mesh tier's window, sort and union stages
(``presto_tpu_torch/parallel/dist.py``) on an 8-shard CPU mesh with
``min_stage_rows = 0``, against the reference's ``DistributedRunner``
on the 8 virtual XLA host devices and the port's local runner: the
mesh scenarios of ``tests/test_distributed_stages.py``, the
reference's streaming exchange on and off against the port's inline
one, and the ``explain_distributed`` text of each
shape equal to the reference's."""

import pytest

import torch_parity  # noqa: F401  (one torch thread per process)
from presto_tpu.parallel.fragment import explain_distributed as ref_explain
from presto_tpu.parallel.fragment import fragment_plan as ref_fragment_plan
from presto_tpu_torch import NotPorted
from presto_tpu_torch.parallel.dist import DistributedRunner
from presto_tpu_torch.parallel.fragment import explain_distributed, fragment_plan
from presto_tpu_torch.parallel.mesh import make_mesh
from presto_tpu_torch.runner import QueryRunner
from presto_tpu_torch.session import Session
from torch_mesh_parity import check_mesh, make_sides

WINDOW_SQL = ("SELECT o_custkey, o_totalprice, "
              "sum(o_totalprice) OVER (PARTITION BY o_custkey) "
              "FROM orders")
WINDOW_ORDERED_SQL = (
    "SELECT o_custkey, o_orderkey, "
    "rank() OVER (PARTITION BY o_custkey ORDER BY o_totalprice DESC), "
    "sum(o_totalprice) OVER (PARTITION BY o_custkey ORDER BY o_orderkey) "
    "FROM orders")
ORDER_BY_SQL = ("SELECT l_orderkey, l_extendedprice, l_shipdate "
                "FROM lineitem "
                "ORDER BY l_extendedprice DESC, l_orderkey, l_linenumber")
UNION_SQL = ("SELECT o_orderkey FROM orders "
             "UNION ALL SELECT o_orderkey FROM orders "
             "UNION ALL SELECT l_orderkey FROM lineitem")
UNION_MIXED_SQL = ("SELECT l_returnflag x FROM lineitem "
                   "UNION ALL SELECT o_orderstatus FROM orders")
WINDOW_THEN_ORDER_SQL = (
    "SELECT o_custkey, r FROM ("
    "SELECT o_custkey, sum(o_totalprice) "
    "OVER (PARTITION BY o_custkey) r FROM orders) "
    "ORDER BY r DESC, o_custkey")


@pytest.fixture(scope="module")
def env():
    ref, port = make_sides()
    ref.dist.min_stage_rows = port.dist.min_stage_rows = 0
    return ref, port


SCENARIOS = {
    "window_partition_agg": (WINDOW_SQL, False, 1),
    "window_with_order": (WINDOW_ORDERED_SQL, False, 1),
    "large_order_by_exact_order": (ORDER_BY_SQL, True, 1),
    "union_three_legs": (UNION_SQL, False, 3),
    "union_merged_dictionaries": (UNION_MIXED_SQL, False, 2),
    "window_then_order_by": (WINDOW_THEN_ORDER_SQL, True, 2),
}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_mesh_stage(env, name):
    sql, ordered, stages = SCENARIOS[name]
    check_mesh(env, sql, ordered=ordered, min_stages=stages)


def test_order_by_merges_runs_on_k22(env):
    """The sort stage's runs merge through K22's twin."""
    from presto_tpu_torch.kernels import merge_sorted as k22

    calls = []
    plain = k22.merge_sorted_plain

    def counted(a, b):
        calls.append(1)
        return plain(a, b)

    k22.merge_sorted_plain = counted
    try:
        check_mesh(env, ORDER_BY_SQL, ordered=True)
    finally:
        k22.merge_sorted_plain = plain
    assert calls


def test_streaming_toggle_same_result(env):
    """The reference's exchange with its producer on a thread (its
    default) and inline give the port's rows; the port runs its
    producers inline."""
    ref, port = env
    got = port.run(ORDER_BY_SQL)
    assert got.dist_fallback is None
    rows = {}
    for on in (True, False):
        ref.dist.exchange_streaming = on
        try:
            out = ref.run(ORDER_BY_SQL)
        finally:
            ref.dist.exchange_streaming = True
        assert out.dist_fallback is None
        rows[on] = out.rows
    assert got.rows == rows[True] == rows[False] == port.expected(ORDER_BY_SQL)


def test_threaded_exchange_not_ported(env):
    """``exchange_streaming = true`` asks for a producer thread, which
    the port does not have: the mesh tier raises NotPorted by name, also
    through SET SESSION."""
    _, port = env
    session = Session()
    session.set("exchange_streaming", "true")
    with pytest.raises(NotPorted, match="exchange_streaming"):
        DistributedRunner(port.local.catalog, make_mesh(8, device="cpu"), session=session)
    runner = QueryRunner(port.local.catalog, device="cpu")
    runner.execute("SET SESSION distributed = true")
    runner.execute("SET SESSION exchange_streaming = true")
    with pytest.raises(NotPorted, match="exchange_streaming"):
        runner.execute(ORDER_BY_SQL)


def test_sort_stays_glue_over_small_intermediates(env):
    """ORDER BY over a below-threshold materialized intermediate keeps
    the coordinator-glue path (the default min_stage_rows gate)."""
    ref, port = env
    sql = ("SELECT l_returnflag, sum(l_quantity) q FROM lineitem "
           "GROUP BY l_returnflag ORDER BY q")
    text = explain_distributed(port.local.plan(sql))
    assert text == ref_explain(ref.local.plan(sql))
    assert "root=AggregationNode" in text
    assert "via merge[" not in text
    assert "[SINGLE] => output [SINGLE] via gather root=SortNode" in text


@pytest.mark.parametrize("sql, needle", [
    (WINDOW_SQL, "via hash[o_custkey]"),
    (ORDER_BY_SQL, "via merge["),
    (UNION_SQL, "via union"),
])
def test_explain_shapes_equal_reference(env, sql, needle):
    ref, port = env
    text = explain_distributed(port.local.plan(sql), min_stage_rows=0)
    assert text == ref_explain(ref.local.plan(sql), min_stage_rows=0)
    assert text.startswith("FRAGMENTED: yes") and needle in text


def test_explain_agrees_with_execution(env):
    """The simulated decomposition and the executed one count the same
    stages for every breaker shape, in both engines."""
    ref, port = env
    for sql in (WINDOW_SQL, ORDER_BY_SQL, UNION_SQL):
        frags = fragment_plan(port.local.plan(sql), min_stage_rows=0)
        assert frags.mesh_stages == ref_fragment_plan(ref.local.plan(sql),
                                                      min_stage_rows=0).mesh_stages
        assert frags.mesh_stages == port.run(sql).dist_stages, sql
