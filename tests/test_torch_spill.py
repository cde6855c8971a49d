"""The port's host-RAM spill against the reference's (``tests/test_spill.py``):
the same aggregation, join and FULL OUTER join at sf 0.004 with 2^12-row
splits, under a pool at 0.6x the largest reservation of their spill
site, found with a peeking pool as the reference's tests find it.  The
spilled rows must equal the port's unconstrained rows and the
reference's, integers and decimals exactly, and the partitioned path
must have run (spilled bytes above 0; per-partition join builds
charged).  A streaming join whose build trips the pool is demoted out
of its chain into that path (the inner join here, and the null-aware
anti and mark joins of NOT IN, whose GLOBAL three-valued flags must
survive the partitioning).

The reference's capacity-trigger case (``test_agg_spill_capacity_trigger``:
``GroupCapacityExceeded`` past ``SPILL_GROUP_THRESHOLD``) has no
counterpart: the port sizes its aggregation outputs from a count it
reads once, so the pool is its only spill trigger.

Also here: K11's twin (``kernels/spill_partition.py``) through the
port's ``make_bucket_fn`` + ``partition_to_host`` against the
reference's on one page (every row's bucket, each bucket's rows in the
same order), and ``build_null_flags`` against the reference's.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from presto_tpu.catalog import Catalog as RefCatalog
from presto_tpu.connectors.tpch import Tpch as RefTpch
from presto_tpu.exec import spill as ref_spill
from presto_tpu.exec.local import LocalRunner as RefRunner
from presto_tpu.expr import ir as ref_ir
from presto_tpu.ops import join as ref_join
from presto_tpu.page import Block as RefBlock, Dictionary as RefDictionary, Page as RefPage
from presto_tpu.sql.binder import Binder as RefBinder
from presto_tpu.types import parse_type as ref_type
from presto_tpu_torch.exec import spill as port_spill
from presto_tpu_torch.exec.local import LocalRunner
from presto_tpu_torch.expr import ir as port_ir
from presto_tpu_torch.memory import ExceededMemoryLimitError, MemoryPool
from presto_tpu_torch.ops import join as port_join
from presto_tpu_torch.sql.binder import Binder
from presto_tpu_torch.testing import tpch_catalog
from presto_tpu_torch.types import parse_type as port_type
from test_spill import AGG_SQL, FULL_SQL, JOIN_SQL
from torch_parity import to_port

SF, SPLIT_ROWS = 0.004, 1 << 12

# NOT IN through the partitioned join: the build holds a NULL (every
# unmatched probe is UNKNOWN, so no row passes), the probe holds NULLs
# against a build without one, and a mark join under OR (three-valued
# marks: rows pass only through the other disjunct)
_NULL_AT_4 = "case when o_orderkey = 4 then null else o_orderkey end"
NOT_IN_BUILD_NULL = ("select l_orderkey, l_linenumber from lineitem where l_orderkey not in"
                     f" (select {_NULL_AT_4} from orders where o_orderstatus <> 'P')")
NOT_IN_PROBE_NULL = ("select l_orderkey, l_linenumber from lineitem where"
                     " (case when l_linenumber = 2 then null else l_orderkey end)"
                     " not in (select o_orderkey from orders where o_orderstatus <> 'P')")
NOT_IN_MARK = ("select l_orderkey, l_linenumber from lineitem where l_returnflag = 'R' or"
               f" l_orderkey not in (select {_NULL_AT_4} from orders"
               " where o_orderstatus <> 'P')")


class PeekPool(MemoryPool):
    """Pool that remembers every reservation's size by tag."""

    def __init__(self, limit):
        super().__init__(limit)
        self.peek = {}

    def reserve(self, tag, nbytes, enforce=True):
        self.peek[tag] = nbytes
        super().reserve(tag, nbytes, enforce=enforce)


@pytest.fixture(scope="module")
def catalogs():
    ref = RefCatalog()
    ref.register("tpch", RefTpch(sf=SF, split_rows=SPLIT_ROWS))
    return ref, tpch_catalog(sf=SF, split_rows=SPLIT_ROWS)


def _run(catalog, sql, pool=None):
    runner = LocalRunner(catalog, device="cpu", memory_pool=pool)
    return runner.run(Binder(catalog).plan(sql)).rows, runner


def _reference_rows(ref_catalog, sql):
    return RefRunner(ref_catalog).run(RefBinder(ref_catalog).plan(sql)).rows


def _exact(rows):
    return sorted(rows, key=repr)


def _spilled(catalog, sql, site):
    """The port's unconstrained rows, and its rows and runner under a
    pool at 0.6x the largest ``site`` reservation."""
    expected, _ = _run(catalog, sql)
    probe = PeekPool(1 << 40)
    _run(catalog, sql, probe)
    site_bytes = max(n for t, n in probe.peek.items() if site in t)
    pool = PeekPool(int(site_bytes * 0.6))
    rows, runner = _run(catalog, sql, pool)
    assert pool.reserved == 0, pool.tags()
    return expected, rows, runner, pool


@pytest.mark.parametrize("name,sql,site", [
    ("agg", AGG_SQL, "agg_accumulator@"),
    ("join", JOIN_SQL, "join_build@"),
    ("full", FULL_SQL, "join_build@"),
], ids=["agg", "join", "full"])
def test_spilled_rows_equal_unconstrained_and_reference(catalogs, name, sql, site):
    ref_catalog, catalog = catalogs
    expected, rows, runner, pool = _spilled(catalog, sql, site)
    assert rows and _exact(rows) == _exact(expected)
    assert _exact(rows) == _exact(_reference_rows(ref_catalog, sql))
    assert runner.last_spill.bytes > 0 and runner.last_spill.buckets > 0
    if name != "agg":
        assert any("join_build_partition@" in t for t in pool.peek)


def test_streaming_join_is_demoted_into_the_partitioned_join(catalogs):
    _, catalog = catalogs
    _, _, runner, _ = _spilled(catalog, JOIN_SQL, "join_build@")
    (demoted,) = runner._force_expanding
    assert demoted.kind == "inner" and demoted.unique_build


@pytest.mark.parametrize("sql", [NOT_IN_BUILD_NULL, NOT_IN_PROBE_NULL, NOT_IN_MARK],
                         ids=["build_null", "probe_null", "mark"])
def test_spilled_null_aware_join_is_three_valued(catalogs, sql):
    ref_catalog, catalog = catalogs
    expected, rows, runner, pool = _spilled(catalog, sql, "join_build@")
    assert _exact(rows) == _exact(expected) == _exact(_reference_rows(ref_catalog, sql))
    assert any("join_build_partition@" in t for t in pool.peek)
    (demoted,) = runner._force_expanding
    assert demoted.kind in ("anti", "mark") and demoted.null_aware
    if sql == NOT_IN_BUILD_NULL:
        assert rows == []  # a NULL in the build: NOT IN is never TRUE
    else:
        assert rows


def test_pool_still_enforced_for_oversized_results(catalogs):
    """A sort input past the pool fails cleanly: spill covers
    aggregation and join state, not every materialization."""
    _, catalog = catalogs
    with pytest.raises(ExceededMemoryLimitError) as e:
        _run(catalog, "select * from lineitem order by l_extendedprice", MemoryPool(1 << 10))
    assert "sort_input" in e.value.tag


# -- K11's twin against make_bucket_fn + partition_to_host ---------------------

def _bucket_page(seed: int, n: int = 3000) -> RefPage:
    """A bigint key with a domain, a dictionary varchar (one value
    repeated under two codes) and an integer, with NULLs and dead rows."""
    rng = np.random.default_rng(seed)
    words = ["ash", "birch", "cedar", "ash", "elm", "fir"]
    k = rng.integers(0, 1000, n)
    s = rng.integers(0, len(words), n).astype(np.int32)
    i = rng.integers(-50, 50, n).astype(np.int32)
    blocks = [RefBlock(jnp.asarray(k), jnp.asarray(rng.random(n) > 0.1), ref_type("bigint")),
              RefBlock(jnp.asarray(s), jnp.asarray(rng.random(n) > 0.1), ref_type("varchar"),
                       RefDictionary(words)),
              RefBlock(jnp.asarray(i), jnp.asarray(rng.random(n) > 0.1), ref_type("integer"))]
    return RefPage(tuple(blocks), jnp.asarray(rng.random(n) > 0.15))


def _keys(ir, parse_type, case):
    k = ir.ColumnRef(type=parse_type("bigint"), index=0)
    s = ir.ColumnRef(type=parse_type("varchar"), index=1)
    i = ir.ColumnRef(type=parse_type("integer"), index=2)
    if case == "packed":
        return [k], [(0, 999)]
    return [s, i], None  # no domain: hashed


@pytest.mark.parametrize("num_buckets", [1, 8, 13])
@pytest.mark.parametrize("case", ["packed", "hashed"])
def test_k11_twin_matches_make_bucket_fn_and_partition_to_host(case, num_buckets):
    ref_page = _bucket_page(num_buckets)
    page = to_port(ref_page)
    ref_exprs, kd = _keys(ref_ir, ref_type, case)
    port_exprs, _ = _keys(port_ir, port_type, case)
    ref_bids = ref_spill.make_bucket_fn(ref_exprs, kd, num_buckets, jit=False)(ref_page)
    ref_parts = ref_spill.partition_to_host(ref_page, ref_bids, num_buckets)
    parts = port_spill.make_bucket_fn(port_exprs, kd, num_buckets)(page)
    counter = port_spill.SpillCounter()
    got = port_spill.partition_to_host(page, parts, num_buckets, counter)
    live = np.asarray(ref_page.row_mask)
    np.testing.assert_array_equal(parts[0].numpy()[live], np.asarray(ref_bids)[live])
    assert (parts[0].numpy()[~live] == -1).all()
    assert [hp is None for hp in got] == [hp is None for hp in ref_parts]
    spilled = 0
    for hp, rp in zip(got, ref_parts):
        if rp is None:
            continue
        assert hp.num_rows == rp.num_rows
        for (d, v, t, dic), (rd, rv, rt, rdic) in zip(hp.columns, rp.columns):
            assert str(t) == str(rt) and (dic is None) == (rdic is None)
            np.testing.assert_array_equal(v.numpy(), rv)
            np.testing.assert_array_equal(d.numpy(), rd)
            spilled += rd.nbytes + rv.nbytes
    assert counter.bytes == spilled and counter.buckets == sum(p is not None for p in ref_parts)


def test_k11_twin_unsigned_mod_of_negative_keys():
    """Remixed keys with the top bit set take the unsigned remainder (a
    K that is not a power of two tells it from the signed one)."""
    from presto_tpu_torch.kernels import spill_partition as k11

    n = 4096
    key = torch.arange(n, dtype=torch.int64) * 7919
    mask = torch.ones(n, dtype=torch.bool)
    got = k11.bucket_ids_plain([(key, mask, 0, 0)], mask, 13)
    h = np.asarray(k11.pk.pack_plain([(key, mask, 0, 0)], n, "cpu")[0]).astype(np.uint64)
    h = (h ^ (h >> np.uint64(33))) * np.uint64(0xFF51AFD7ED558CCD)
    h = h ^ (h >> np.uint64(33))
    assert (h >= np.uint64(1 << 63)).any()
    np.testing.assert_array_equal(got.numpy(), (h % np.uint64(13)).astype(np.int32))


# -- build_null_flags ---------------------------------------------------------

@pytest.mark.parametrize("case", ["plain", "expression", "no_nulls", "empty"])
def test_build_null_flags_matches_reference(case):
    ref_page = _bucket_page(7)
    n = ref_page.capacity
    if case in ("no_nulls", "empty"):
        blocks = tuple(RefBlock(b.data, jnp.ones(n, dtype=jnp.bool_), b.type, b.dictionary)
                       for b in ref_page.blocks)
        mask = jnp.zeros(n, dtype=jnp.bool_) if case == "empty" else ref_page.row_mask
        ref_page = RefPage(blocks, mask)
    page = to_port(ref_page)

    def keys(ir, parse_type):
        k = ir.ColumnRef(type=parse_type("bigint"), index=0)
        i = ir.ColumnRef(type=parse_type("integer"), index=2)
        if case == "expression":
            return [ir.Call(type=parse_type("bigint"), fn="add",
                            args=(k, ir.Literal(type=parse_type("bigint"), value=1))), i]
        return [k, i]

    want = ref_join.build_null_flags(ref_page, keys(ref_ir, ref_type))
    got = port_join.build_null_flags(page, keys(port_ir, port_type))
    assert (bool(got[0]), bool(got[1])) == (bool(want[0]), bool(want[1]))
    assert (bool(got[0]), bool(got[1])) == {"plain": (True, True), "expression": (True, True),
                                           "no_nulls": (False, True),
                                           "empty": (False, False)}[case]
