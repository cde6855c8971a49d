"""The port's memory pool (``presto_tpu_torch/memory.py``) against the
reference's (``presto_tpu/memory.py``), and the always-on accounting of
``tests/test_always_on_memory.py`` through the port's ``QueryRunner``.

The pool classes are driven by one sequence of reserve, free, kill and
release calls in both packages, and every observable compared: reserved
and peak bytes, tags, per-site peaks, the refusal's fields and the
killed query's error.  EXPLAIN ANALYZE (which prints the peak in the
reference) is not ported and raises ``NotPorted``.
"""

import pytest

from presto_tpu import memory as ref_mem
from presto_tpu_torch import NotPorted
from presto_tpu_torch import memory as port_mem
from presto_tpu_torch.catalog import Catalog
from presto_tpu_torch.connectors.tpch import Tpch
from presto_tpu_torch.runner import QueryRunner

# (call, arguments): reservations of two queries, a refusal, a soft
# reservation past the limit, frees, a kill and a release
SCRIPT = [
    ("reserve", ("q1", "join_build@1", 400)),
    ("reserve", ("q1", "scan_page", 300)),
    ("reserve", ("q2", "agg_accumulator@2", 200)),
    ("reserve", ("q1", "join_build@1", 200)),
    ("free", ("q1", 1)),
    ("reserve", ("q2", "agg_accumulator@2", 700)),  # refused
    ("reserve_soft", ("q1", "scan_page", 900)),  # counted past the limit
    ("free", ("q1", 2)),
    ("reserve", ("q2", "sort_input", 100)),
    ("kill", ("q2",)),
    ("reserve", ("q2", "sort_input", 1)),  # the killed query's next reserve
    ("release", ("q1",)),
    ("reserve", ("q1", "join_build_partition@1", 50)),
]


def _drive(mod):
    """Run SCRIPT against ``mod``'s classes; a trace of observables."""
    pool = mod.MemoryPool(1000)
    ctxs = {q: mod.QueryMemoryContext(pool, q) for q in ("q1", "q2")}
    tags = {q: [] for q in ctxs}
    trace = []
    for call, args in SCRIPT:
        q = args[0]
        try:
            if call == "reserve":
                tags[q].append(ctxs[q].reserve(args[1], args[2]))
            elif call == "reserve_soft":
                tags[q].append(ctxs[q].reserve(args[1], args[2], enforce=False))
            elif call == "free":
                ctxs[q].free(tags[q][args[1]])
            elif call == "kill":
                trace.append(("killed", pool.kill_query(q)))
            else:
                ctxs[q].release_all()
        except mod.ExceededMemoryLimitError as e:
            trace.append(("refused", e.tag, e.requested, e.reserved, e.limit, str(e)))
        except mod.QueryKilledError as e:
            trace.append(("killed_error", str(e)))
        trace.append((call, pool.reserved, pool.peak, sorted(pool.tags().items()),
                      {k: (c.reserved, c.peak, dict(c.site_peak), c.headroom())
                       for k, c in ctxs.items()}))
    return trace


def test_pool_and_context_match_reference():
    assert _drive(port_mem) == _drive(ref_mem)


def test_page_bytes_counts_data_valid_and_row_mask():
    import torch

    from presto_tpu_torch.page import Block, Page
    from presto_tpu_torch.types import parse_type

    n = 10
    page = Page((Block(torch.zeros(n, dtype=torch.int64), torch.ones(n, dtype=torch.bool),
                       parse_type("bigint")),
                 Block(torch.zeros((n, 2), dtype=torch.int64), torch.ones(n, dtype=torch.bool),
                       parse_type("decimal(38,2)"))), torch.ones(n, dtype=torch.bool))
    assert port_mem.page_bytes(page) == 8 * n + n + 16 * n + n + n


def test_detected_limit_reads_the_override(monkeypatch):
    monkeypatch.setenv("PRESTO_TPU_MEMORY_LIMIT_BYTES", "12345")
    assert port_mem.detected_memory_limit() == 12345
    monkeypatch.delenv("PRESTO_TPU_MEMORY_LIMIT_BYTES")
    # no card here: half of host RAM, as the reference's CPU backend
    assert port_mem.detected_memory_limit() == ref_mem.detected_memory_limit()


# -- tests/test_always_on_memory.py through the port -------------------------

def _runner(**kw):
    catalog = Catalog()
    catalog.register("tpch", Tpch(sf=0.001, split_rows=2048))
    return QueryRunner(catalog, device="cpu", **kw)


def test_default_pool_engaged_without_opt_in():
    r = _runner()
    assert r.memory_pool is port_mem.default_memory_pool()
    assert r.memory_pool.limit > 0
    r.execute("select o_orderpriority, count(*) from orders, customer "
              "where o_custkey = c_custkey group by o_orderpriority")
    # scan pages + join build + agg accumulator were all charged
    assert r.executor.last_peak_bytes > 0
    assert {s.split("@")[0] for s in r.executor.last_site_peaks} >= {
        "scan_page", "join_build", "agg_accumulator"}
    # and released at query end: no reservation may remain
    assert r.memory_pool.reserved == 0, list(r.memory_pool.tags())


def test_explain_analyze_is_not_ported():
    with pytest.raises(NotPorted):
        _runner().execute("explain analyze select count(*) from lineitem")


def test_explicit_pool_still_respected():
    pool = port_mem.MemoryPool(1 << 30)
    r = _runner(memory_pool=pool)
    assert r.memory_pool is pool
    r.execute("select count(*) from lineitem")
    assert pool.peak > 0
    assert pool.reserved == 0  # released


def test_opt_out_with_false():
    r = _runner(memory_pool=False)
    assert r.memory_pool is None and r.executor.memory_pool is None
    assert r.execute("select count(*) from lineitem").rows[0][0] > 0
    assert r.executor.last_peak_bytes == 0
