"""The thirteenth slice's SQL: DECIMAL(37..38) values and long-decimal
literals through the port's ``QueryRunner`` on the CPU against the
reference's runner.

- ``tests/test_decimal38.py``'s statements, over ``VALUES`` in place of
  its CTAS (the port has none), and ``tests/test_long_decimal.py``'s
  decimal(36,4) literal;
- ``chip_smoke.py``'s D38 queries at TPC-H sf 0.01 over ``lineitem_d38``
  (lineitem with l_quantity and l_extendedprice as decimal(38,2), built
  by the port's casts in the port and by CTAS in the reference).  Those
  with a wide x short product over a column the reference cannot answer
  (its ``mul_wide_small`` broadcast fault, ROADMAP queue C, pinned
  here): they are held against Python's ``Decimal``, through the
  reference's exact short-decimal run of the same query over lineitem
  and, for Q6, a sum computed here;
- the wide price through a unique-build join (K5) and a non-unique one
  (K8), and a wide aggregation spilled under a small pool (K11).

Rows compare exactly (decimals as ``Decimal``), doubles within a
relative 1e-9."""

import decimal
from decimal import Decimal

import pytest

import chip_smoke
from oracle import assert_rows_match

decimal.getcontext().prec = 60

SF, SPLIT_ROWS = 0.01, 1 << 14
_D38 = "(select cast(x as decimal(38,2)) as v from (values 1.25, 7.50, " \
       "12345678901234567890123456789012345.67) t(x)) d38"

# tests/test_decimal38.py's statements, over VALUES
DECIMAL38_SQL = [
    "select cast(12345678901234567890123456789012345678 as decimal(38,0))",
    "select cast(99999999999999999999999999999999999.99 as decimal(38,2))"
    " - cast(0.99 as decimal(38,2))",
    "select cast(1.25 as decimal(38,2)) + cast(2.50 as decimal(38,2))",
    "select cast(1.25 as decimal(38,2)) < cast(1.30 as decimal(20,2))",
    "select cast(123.456 as decimal(38,3)) = cast(123.456 as decimal(20,3))",
    f"select sum(v), avg(v), max(v), min(v) from {_D38}",
    f"select v from {_D38} where v > 2 order by v",
    "select cast(cast(5.75 as decimal(38,2)) as double)",
    "select cast(2.5 as decimal(38,2)) * 3",
    "select cast(12345678901234567890 as decimal(38,0)) * 10",
    "select cast(12345678901234567890 as decimal(38,0)) * 999999999999999999",
    "select cast(-4.5 as decimal(38,1)) * 1000000000000000",
    "select cast(cast(1.2 as decimal(38,1)) as decimal(38,4))",
    # tests/test_long_decimal.py: a decimal(36,4) literal standing alone
    "select cast(cast(123456789012345678.0000 as decimal(36, 4)) as bigint)",
]


class _Pair:
    """The reference's runner and the port's (CPU) over the same data:
    TPC-H lineitem, orders and supplier at ``SF`` in a memory table each,
    and ``lineitem_d38`` beside them."""

    def __init__(self):
        from presto_tpu.catalog import Catalog as RefCatalog
        from presto_tpu.connectors.memory import MemoryConnector as RefMemory
        from presto_tpu.connectors.tpch import Tpch as RefTpch
        from presto_tpu.runner import QueryRunner as RefRunner
        from presto_tpu_torch.catalog import Catalog
        from presto_tpu_torch.connectors.memory import MemoryConnector
        from presto_tpu_torch.connectors.tpch import Tpch
        from presto_tpu_torch.runner import QueryRunner

        tables = ("lineitem", "orders", "supplier")
        ref_mem = RefMemory()
        for t in tables:
            ref_mem.load_from(RefTpch(sf=SF, split_rows=SPLIT_ROWS), t)
        ref_catalog = RefCatalog()
        ref_catalog.register("tpch", ref_mem, writable=True)
        self.ref = RefRunner(ref_catalog)
        cols = ", ".join(f"cast({c} as decimal(38,2)) as {c}" if c in chip_smoke.D38_COLUMNS
                         else c for c, _ in ref_mem.schema("lineitem"))
        self.ref.execute(f"create table {chip_smoke.D38_TABLE} as select {cols} from lineitem")
        self.mem = MemoryConnector(device="cpu")
        for t in tables:
            self.mem.load_from(Tpch(sf=SF, split_rows=SPLIT_ROWS), t)
        chip_smoke.make_lineitem_d38(self.mem)
        self.catalog = Catalog()
        self.catalog.register("tpch", self.mem)
        self.port = QueryRunner(self.catalog, device="cpu")

    def check(self, sql: str, ordered: bool = True):
        want = self.ref.execute(sql)
        got = self.port.execute(sql)
        assert [str(t) for t in got.types] == [str(t) for t in want.types]
        assert_rows_match(got.rows, want.rows, ordered=ordered)
        return got.rows


_PAIR = []


def _pair() -> _Pair:
    if not _PAIR:
        _PAIR.append(_Pair())
    return _PAIR[0]


@pytest.mark.parametrize("sql", DECIMAL38_SQL)
def test_decimal38_statements_equal_the_reference(sql):
    _pair().check(sql)


def test_values_match_decimal():
    """The same statements' values, as the reference suite asserts them."""
    port = _pair().port
    vals = [Decimal("1.25"), Decimal("7.50"), Decimal("12345678901234567890123456789012345.67")]
    s, a, mx, mn = port.execute(DECIMAL38_SQL[5]).rows[0]
    assert (s, a, mx, mn) == (sum(vals), (sum(vals) / 3).quantize(Decimal("0.01")), max(vals),
                              min(vals))
    big = 12345678901234567890 * 999999999999999999
    assert port.execute(DECIMAL38_SQL[10]).rows == [(Decimal(big),)]
    assert port.execute(DECIMAL38_SQL[13]).rows == [(123456789012345678,)]


def test_wrap_past_38_digits_equals_the_reference():
    """An up-scale past 38 digits does not give NULL, as a short
    decimal's overflow does: the five limbs hold the value up to 45
    digits and drop the carry past them (the magnitude modulo 10^45), in
    both packages."""
    sql = ("select cast(v as decimal(38,30)) from (select cast(x as decimal(38,2)) as v "
           "from (values 123456789012345678901.25, 2.5) t(x))")
    rows = _pair().check(sql)
    exact = int(Decimal("123456789012345678901.25").scaleb(30))
    assert int(rows[0][0].scaleb(30)) == exact % 10 ** 45 != exact
    assert rows[1] == (Decimal("2.5"),)


def test_wide_times_long_still_unsupported():
    """A wide x wide product raises in both packages ("mul unsupported")."""
    sql = f"select cast(2.5 as decimal(38,2)) * v from {_D38}"
    with pytest.raises(Exception, match="mul unsupported"):
        _pair().ref.execute(sql)
    with pytest.raises(Exception, match="mul unsupported"):
        _pair().port.execute(sql)


# the smoke's D38 queries the reference answers, and those with a wide
# x short product over a column, which it cannot
_PRODUCTS = ("d38_q1", "d38_q6", "d38_supplier_top")


@pytest.mark.parametrize("label", [q for q in chip_smoke.D38_QUERIES if q not in _PRODUCTS])
def test_smoke_d38_queries_equal_the_reference(label):
    rows = _pair().check(chip_smoke.D38_QUERIES[label])
    assert rows


@pytest.mark.parametrize("label", _PRODUCTS)
def test_smoke_d38_products_equal_decimal(label):
    """The port's rows equal the exact Decimal values, here the
    reference's short-decimal run of the same query over lineitem (its
    limb arithmetic is exact there); the reference's own run over
    lineitem_d38 raises its broadcast error (queue C)."""
    sql = chip_smoke.D38_QUERIES[label]
    pair = _pair()
    got = pair.port.execute(sql)
    want = pair.ref.execute(sql.replace(chip_smoke.D38_TABLE, "lineitem"))
    assert got.rows
    assert_rows_match(got.rows, want.rows, ordered=True)
    with pytest.raises(ValueError, match="Incompatible shapes for broadcasting"):
        pair.ref.execute(sql)


def test_q6_revenue_is_the_decimal_sum():
    """d38_q6's revenue against a sum of Decimal products computed here
    from the qualifying rows."""
    pair = _pair()
    rows = pair.port.execute(
        "select l_extendedprice, l_discount from lineitem_d38 where l_shipdate >= "
        "date '1994-01-01' and l_shipdate < date '1995-01-01' and l_discount between 0.05 "
        "and 0.07 and l_quantity < 24").rows
    want = sum((p * d for p, d in rows), Decimal(0))
    assert rows and pair.port.execute(chip_smoke.D38_QUERIES["d38_q6"]).rows == [(want,)]


@pytest.mark.parametrize("sql", [
    chip_smoke.D38_QUERIES["d38_join"],
    "select s_name, l_extendedprice from supplier left join lineitem_d38 on s_suppkey = "
    "l_suppkey and l_quantity > 49 order by 1, 2",
], ids=["probe", "expand"])
def test_wide_column_through_joins(sql):
    """The wide price carried through a unique-build join (K5's probe
    gathers it) and a non-unique one (K8 expands the build's 40-byte
    rows); the plans take those paths."""
    from presto_tpu_torch.planner.plan import JoinNode

    pair = _pair()
    (join,) = chip_smoke.find_all(pair.port.plan(sql), JoinNode)
    assert join.unique_build == ("join orders" in sql)
    assert pair.check(sql)


def test_wide_aggregation_spills():
    """A wide sum and max by l_orderkey under a pool at 0.6x its
    accumulator's largest reservation: K11 spills the wide states and
    the rows equal the unconstrained run's and the reference's."""
    from presto_tpu_torch.exec.local import LocalRunner
    from presto_tpu_torch.memory import MemoryPool
    from presto_tpu_torch.sql.binder import Binder

    sql = ("select l_orderkey, sum(l_extendedprice), max(l_extendedprice), "
           "min(l_quantity) from lineitem_d38 group by l_orderkey")
    pair = _pair()

    class Peek(MemoryPool):
        def __init__(self, limit):
            super().__init__(limit)
            self.peek = {}

        def reserve(self, tag, nbytes, enforce=True):
            self.peek[tag] = nbytes
            super().reserve(tag, nbytes, enforce=enforce)

    def run(pool=None):
        runner = LocalRunner(pair.catalog, device="cpu", memory_pool=pool)
        return runner.run(Binder(pair.catalog).plan(sql)).rows, runner

    expected, _ = run()
    probe = Peek(1 << 40)
    run(probe)
    site = max(n for t, n in probe.peek.items() if "agg_accumulator@" in t)
    rows, runner = run(Peek(int(site * 0.6)))
    assert runner.last_spill.bytes > 0 and runner.last_spill.buckets > 0
    assert sorted(rows) == sorted(expected)
    assert_rows_match(rows, pair.ref.execute(sql).rows, ordered=False)
