"""Queue C of ROADMAP.md: the faults found in the port against the
reference, each repaired to the reference's answer or pinned as a
known fault of the reference.

- C1: the port divides a double (and a REAL) exactly, as the reference's
  code is written and as its eager ops compute; the jitted reference
  runner's XLA:CPU turns a division by a constant into a product by its
  reciprocal and is an ulp off (pinned).
- C2: count_if and an aggregate FILTER over a non-boolean value select
  by its low bit (the reference's ``live & fd & fv``); a double raises
  TypeError; limbs are not ported.
- C3: floor and ceil of a REAL return the value, as the reference does
  (pinned as the reference's fault: SQL floors).
- C4: width_bucket and power over a long decimal raise the reference's
  ValueError; unary minus of a boolean its TypeError.
- C5: numeric_histogram over a non-integer double, key by key.
- A spilled top-n grouping with ties across its splits keeps the
  reference's lanes.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest

import torch_parity  # noqa: F401  (one torch thread per process)
from presto_tpu.expr import ir as ref_ir
from presto_tpu.expr.compile import ExprCompiler as RefCompiler
from presto_tpu.page import Block as RefBlock
from presto_tpu.page import Page as RefPage
from presto_tpu.types import parse_type as ref_type
from presto_tpu_torch import NotPorted
from presto_tpu_torch.expr import ir
from presto_tpu_torch.expr.compile import ExprCompiler
from presto_tpu_torch.types import parse_type
from torch_fn_parity import TpchPair
from torch_parity import to_port


@pytest.fixture(scope="module")
def pair():
    return TpchPair()  # TPC-H sf 0.001, 4096-row splits


def _decimal_page(n: int = 4096, seed: int = 3):
    """A reference page of a decimal(12,2) column: prices like
    l_extendedprice's (the C1 cases among them), NULLs, dead rows."""
    rng = np.random.default_rng(seed)
    d = rng.integers(90000, 10_500_000, n)
    d[:4] = [3622559, 1882080, 1, -1882080]
    valid = rng.random(n) >= 0.05
    valid[:4] = True
    mask = rng.random(n) >= 0.05
    mask[:4] = True
    return RefPage((RefBlock(jnp.asarray(d), jnp.asarray(valid), ref_type("decimal(12,2)")),),
                   jnp.asarray(mask))


def _expr(mod, pt, spec):
    kind = spec[0]
    if kind == "col":
        return mod.ColumnRef(type=pt("decimal(12,2)"), index=0)
    if kind == "lit":
        return mod.Literal(type=pt(spec[2]), value=spec[1])
    _, fn, t, *args = spec
    return mod.Call(type=pt(t), fn=fn, args=tuple(_expr(mod, pt, a) for a in args))


COL = ("col",)
DIVISIONS = {
    "to_double": ("call", "cast_double", "double", COL),
    "double_by_100": ("call", "div", "double", ("call", "cast_double", "double", COL),
                      ("lit", 100.0, "double")),
    "double_by_7": ("call", "div", "double", ("call", "cast_double", "double", COL),
                    ("lit", 7.0, "double")),
    "real_by_3": ("call", "div", "real", ("call", "cast_real", "real", COL),
                  ("lit", 3.0, "real")),
}


@pytest.mark.parametrize("name", sorted(DIVISIONS))
def test_c1_division_equals_the_eager_reference_bit_for_bit(name):
    """C1: ``_to_double`` (``data / 10.0 ** scale``) and divisions by a
    constant, bit for bit against the reference's compiler run eagerly,
    as its code is written (no XLA rewrite of the division)."""
    ref = _decimal_page()
    spec = DIVISIONS[name]
    rd, rv = RefCompiler.for_page(ref).compile(_expr(ref_ir, ref_type, spec))(ref)
    pd, pv = ExprCompiler.for_page(to_port(ref)).compile(_expr(ir, parse_type, spec))(
        to_port(ref))
    rd, rv = np.asarray(rd), np.asarray(rv)
    np.testing.assert_array_equal(pv.numpy(), rv)
    np.testing.assert_array_equal(pd.numpy()[rv].view(np.uint8), rd[rv].view(np.uint8))


def test_c1_jitted_reference_rows_known_fault(pair):
    """C1, a known fault of the reference runner: under ``jax.jit``
    XLA:CPU multiplies by the constant's reciprocal, so 3622559 / 100.0
    is 36225.590000000004 there and no row equals 36225.59e0 (the port
    and the eager division find 2); a REAL / 3 is 6273.6006 where the
    correctly rounded quotient is 6273.6."""
    sql = "select count(*) from lineitem where cast(l_extendedprice as double) = 36225.59e0"
    assert pair.ref.execute(sql).rows == [(0,)]
    assert pair.port.execute(sql).rows == [(2,)]
    assert 3622559 / 100.0 == 36225.59
    sql = ("select cast(l_extendedprice as real) / 3 from lineitem "
           "where l_extendedprice = 18820.80")
    want = np.float32(np.float32(18820.8) / np.float32(3))
    assert want == np.float32(6273.6)
    ref_rows, port_rows = pair.ref.execute(sql).rows, pair.port.execute(sql).rows
    assert ref_rows and len(ref_rows) == len(port_rows)
    assert all(r[0] == np.float32(6273.6006) for r in ref_rows)
    assert all(r[0] == want for r in port_rows)


C2_SQL = {
    "integers_dates_decimals": "select count_if(l_shipdate), count_if(l_partkey), "
                               "count_if(l_linenumber), count_if(l_quantity), "
                               "count_if(l_discount) from lineitem",
    "orderkey": "select count_if(l_orderkey), count(*) from lineitem",
    "timestamp": "select count_if(cast(l_shipdate as timestamp)) from lineitem",
    "interval": "select count_if(l_receiptdate - l_shipdate) from lineitem",
    "narrow": "select count_if(cast(l_linenumber as tinyint)), "
              "count_if(cast(l_linenumber as smallint)) from lineitem",
    "dictionary_code": "select count_if(l_shipmode) from lineitem",
    "grouped": "select l_returnflag, count_if(l_orderkey) from lineitem group by 1 order by 1",
    "sort_path": "select l_orderkey % 97, count_if(l_partkey) from lineitem group by 1 order by 1",
    "values": "select count_if(x) from (values 0, 1, 2) t(x)",
}


@pytest.mark.parametrize("name", sorted(C2_SQL))
def test_c2_count_if_over_a_non_boolean_follows_the_low_bit(pair, name):
    rows = pair.check(C2_SQL[name])
    if name == "orderkey":
        assert rows == [(2928, 5928)]
    if name == "values":
        assert rows == [(1,)]


@pytest.mark.parametrize("sql, exc", [
    ("select count_if(cast(l_extendedprice as double)) from lineitem", TypeError),
    ("select count_if(cast(l_extendedprice as real)) from lineitem", TypeError),
    ("select count_if(cast(l_extendedprice as decimal(30,2))) from lineitem", ValueError),
    ("select count_if(cast(l_extendedprice as decimal(38,2))) from lineitem", ValueError),
    ("select bool_and(cast(l_extendedprice as decimal(30,2))) from lineitem", ValueError),
])
def test_c2_refusals(pair, sql, exc):
    """A double raises the reference's TypeError; limbs, where the
    reference fails on its broadcast, raise NotPorted by name."""
    with pytest.raises(exc):
        pair.ref.execute(sql)
    with pytest.raises(TypeError if exc is TypeError else NotPorted):
        pair.port.execute(sql)


def test_c3_floor_and_ceil_of_a_real_known_fault(pair):
    """C3, a known fault of the reference followed by the port: its only
    float branch of floor/ceil is the double's, so a REAL comes back
    unchanged (SQL's floor of 18820.8 is 18820)."""
    sql = ("select floor(cast(l_extendedprice as real)), ceil(cast(l_extendedprice as real)), "
           "floor(cast(l_extendedprice as double)) from lineitem where l_extendedprice = 18820.80")
    rows = pair.check(sql)
    assert rows and all(r[0] == r[1] == np.float32(18820.8) and r[2] == 18820.0 for r in rows)
    pair.check("select floor(cast(l_discount as real)), ceil(cast(l_tax * 3 as real)) "
               "from lineitem")


@pytest.mark.parametrize("sql, exc", [
    ("select width_bucket(cast(l_extendedprice as decimal(30,2)), 0, 100000, 10) "
     "from lineitem", ValueError),
    ("select width_bucket(cast(l_extendedprice as decimal(38,2)), 0, 100000, 10) "
     "from lineitem", ValueError),
    ("select power(cast(l_extendedprice as decimal(30,2)), 2) from lineitem", ValueError),
    ("select pow(cast(l_extendedprice as decimal(38,2)), 2) from lineitem", ValueError),
    ("select -(l_quantity > 10) from lineitem", TypeError),
])
def test_c4_refuses_as_the_reference_does(pair, sql, exc):
    with pytest.raises(exc) as want:
        pair.ref.execute(sql)
    with pytest.raises(exc) as got:
        pair.port.execute(sql)
    if exc is ValueError:
        assert str(got.value) == str(want.value)


def test_c4_what_still_answers(pair):
    """A long decimal past the first operand converts to a double in
    both; a boolean literal's negation folds in both."""
    pair.check("select power(2, cast(l_discount as decimal(30,2))) from lineitem")
    pair.check("select -(true) from lineitem where l_orderkey < 10")


C5_SQL = [
    "select numeric_histogram(10, l_extendedprice) from lineitem",
    "select numeric_histogram(8, o_totalprice * 1.5e0) from orders",
    "select l_returnflag, numeric_histogram(6, l_discount * l_extendedprice) "
    "from lineitem group by 1 order by 1",
]


@pytest.mark.parametrize("i", range(len(C5_SQL)))
def test_c5_numeric_histogram_over_a_non_integer_double(pair, i):
    """C5: the bins' counts exactly, their keys (weighted means) within
    the parity tolerance (a relative 1e-9: the port's fixed sum order
    and C1 move the last bits)."""
    want = pair.ref.execute(C5_SQL[i]).rows
    got = pair.port.execute(C5_SQL[i]).rows
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g[:-1] == w[:-1]
        gk, wk = sorted(g[-1].items()), sorted(w[-1].items())
        assert len(gk) == len(wk) and len(gk) > 1
        for (ka, ca), (kb, cb) in zip(gk, wk):
            assert ca == cb
            assert math.isclose(ka, kb, rel_tol=1e-9)
            assert ka != int(ka)  # non-integer keys


TIED_SPILL = ("select (l_orderkey * 8 + l_linenumber) % 30011 g, max_by(l_orderkey * 10 + "
              "l_linenumber, l_quantity % 5, 2), min_by(l_orderkey * 10 + l_linenumber, "
              "l_quantity % 5, 1) from lineitem group by 1")


def test_spilled_topn_grouping_keeps_the_reference_lanes():
    """A top-n grouping spilled under a pool at 0.6x its accumulator, in
    both engines, with ties across splits of unequal capacities: the
    lanes each group keeps equal the reference's spilled run (which
    differ from its unspilled run: the ties follow the merges)."""
    from presto_tpu.catalog import Catalog as RefCatalog
    from presto_tpu.connectors.tpch import Tpch as RefTpch
    from presto_tpu.exec.local import LocalRunner as RefRunner
    from presto_tpu.memory import MemoryPool as RefPool
    from presto_tpu.sql.binder import Binder as RefBinder
    from presto_tpu_torch.exec.local import LocalRunner
    from presto_tpu_torch.memory import MemoryPool
    from presto_tpu_torch.sql.binder import Binder
    from presto_tpu_torch.testing import tpch_catalog

    def peeking(cls):
        class Peek(cls):
            def __init__(self, limit):
                super().__init__(limit)
                self.peek = {}

            def reserve(self, tag, nbytes, *a, **k):
                self.peek[tag] = nbytes
                return super().reserve(tag, nbytes, *a, **k)
        return Peek

    rc = RefCatalog()
    rc.register("tpch", RefTpch(sf=0.01, split_rows=45000))
    pc = tpch_catalog(sf=0.01, split_rows=45000)

    def ref(pool=None):
        return RefRunner(rc, memory_pool=pool).run(RefBinder(rc).plan(TIED_SPILL)).rows

    def port(pool=None):
        r = LocalRunner(pc, device="cpu", memory_pool=pool)
        return r.run(Binder(pc).plan(TIED_SPILL)).rows, r

    def site(pool):
        return int(max(n for t, n in pool.peek.items() if "agg_accumulator" in t) * 0.6)

    probe = peeking(RefPool)(1 << 40)
    unspilled = ref(probe)
    ref_spilled = ref(RefPool(site(probe)))
    probe = peeking(MemoryPool)(1 << 40)
    port(probe)
    got, runner = port(MemoryPool(site(probe)))
    assert runner.last_spill.bytes > 0
    assert len(got) == 28247
    assert sorted(ref_spilled) != sorted(unspilled)
    assert sorted(got) == sorted(ref_spilled)
