"""The fourteenth slice's SQL: raw (non-dictionary) VARCHAR values through
the port's ``QueryRunner`` on the CPU against the reference's runner.

- every statement of ``tests/test_raw_varchar.py`` but its serde and
  column-file round trips (the port has neither), its Unicode runner's
  too, over the same ``MemoryConnector`` tables built in both packages;
- ``chip_smoke.py``'s raw queries at TPC-H sf 0.01 over raw copies of
  TPC-H's text columns (``orders_raw``, ``customer_raw``, ``part_raw``,
  ``supplier_raw``: built by ``chip_smoke.make_raw_tables`` in the port,
  from the decoded values in the reference);
- a raw column carried through a unique-build join (K5) and a non-unique
  one (K8), and a raw aggregation spilled under a small pool (K11);
- the reference's own errors, raised the same way.

Rows compare exactly."""

import random
import re

import numpy as np
import pytest

import chip_smoke
from oracle import assert_rows_match

W = 24
random.seed(3)
WORDS = ["alpha", "Bravo", "charlie", "delta-9", "Echo", "fox trot", ""]
STRINGS = ["%s %s%d" % (random.choice(WORDS), random.choice(WORDS), i % 97)
           for i in range(800)]
LOOKUP = sorted(set(STRINGS))[:100]
UNI = ["héllo wörld", "ÀÉÎÕÜ mixed", "naïve café", "ascii only", "öß and þorn",
       "日本語テスト", ""]


def _suite_tables(pkg):
    """The suites' tables (txt, lookup, uni, mt) in one package's
    MemoryConnector: (connector module, page module, types module)."""
    memory, page, types = pkg
    mem = memory.MemoryConnector(**({} if memory.__name__.startswith("presto_tpu.")
                                    else {"device": "cpu"}))
    big, raw = types.BIGINT, types.VarcharType(W, raw=True)
    mem.create_table("txt", [("id", big), ("s", raw)], [page.Page.from_arrays(
        [np.arange(len(STRINGS), dtype=np.int64), STRINGS], [big, raw])])
    tags = page.Dictionary(["alpha", "zulu"])  # a dictionary varchar beside the raw key
    mem.create_table("lookup", [("k", raw), ("v", big), ("tag", types.VARCHAR)], [
        page.Page.from_arrays([LOOKUP, np.arange(100, dtype=np.int64),
                               np.arange(100, dtype=np.int32) % 2], [raw, big, types.VARCHAR],
                              dictionaries=[None, None, tags])])
    uni = types.VarcharType(32, raw=True)
    mem.create_table("uni", [("id", big), ("s", uni)], [page.Page.from_arrays(
        [np.arange(len(UNI), dtype=np.int64), UNI], [big, uni])])
    rt = types.VarcharType(12, raw=True)
    mem.create_table("mt", [("g", big), ("s", rt)], [
        page.Page.from_arrays([np.array([1, 1, 2, 2, 1]),
                               ["banana", "apple", "zebra", "aardvark", None]], [big, rt],
                              valids=[None, np.array([True, True, True, True, False])]),
        page.Page.from_arrays([np.array([2, 1]), ["yak", "cherry"]], [big, rt])])
    return mem


class _Suite:
    def __init__(self):
        import presto_tpu.connectors.memory as ref_memory
        import presto_tpu.page as ref_page
        import presto_tpu.types as ref_types
        import presto_tpu_torch.connectors.memory as memory
        import presto_tpu_torch.page as page
        import presto_tpu_torch.types as types
        from presto_tpu.catalog import Catalog as RefCatalog
        from presto_tpu.runner import QueryRunner as RefRunner
        from presto_tpu_torch.catalog import Catalog
        from presto_tpu_torch.runner import QueryRunner

        ref_catalog = RefCatalog()
        ref_catalog.register("mem", _suite_tables((ref_memory, ref_page, ref_types)))
        self.ref = RefRunner(ref_catalog)
        catalog = Catalog()
        catalog.register("mem", _suite_tables((memory, page, types)))
        self.port = QueryRunner(catalog, device="cpu")

    def check(self, sql: str):
        want = self.ref.execute(sql)
        got = self.port.execute(sql)
        assert got.names == want.names
        assert_rows_match(got.rows, want.rows, ordered="order by" in sql)
        return got.rows


_CACHE = {}


def _suite() -> _Suite:
    if "suite" not in _CACHE:
        _CACHE["suite"] = _Suite()
    return _CACHE["suite"]


# tests/test_raw_varchar.py's statements (serde and the column file aside)
SUITE_SQL = [
    "select id, s from txt order by id limit 10",
    f"select count(*) from txt where s = '{STRINGS[5]}'",
    "select count(*) from txt where s < 'charlie'",
    f"select count(*) from txt where s in ('{STRINGS[0]}', '{STRINGS[1]}')",
    "select count(*) from txt where substr(s, 1, 4) = substr(s, 1, 4)",
    "select count(*) from txt where s like 'alpha%'",
    "select count(*) from txt where regexp_like(s, '[0-9][0-9]$')",
    "select count(*) from txt where starts_with(s, 'Echo')",
    "select id, length(s), substr(s, 2, 3), upper(s) from txt where id < 30 order by id",
    "select id, trim(s), replace(s, ' ', '_') from txt where id < 20 order by id",
    "select id, s || '#' || s from txt where id < 10 order by id",
    "select s, count(*) from txt group by s",
    "select count(*) from txt, lookup where s = k",
    "select s from txt order by s, id",
    "select count(distinct s) from txt",
    "select approx_distinct(s) from txt",
    "select min(s), max(s) from txt",
    "select id, case when id < 5 then s else 'other' end,"
    " coalesce(nullif(s, 'alpha alpha0'), 'was-alpha') from txt where id < 10 order by id",
    "select id, greatest(s, 'charlie'), least(s, 'charlie') from txt where id < 30 order by id",
    "select g, min(s), max(s) from mt group by g order by g",
    "select min(s), max(s) from mt",
    "select min(s) from mt where g = 3",
    "select id, substr(s, 2, 4) from uni order by id",
    "select id, substr(s, 3) from uni order by id",
    "select id, upper(s), lower(s) from uni order by id",
    # beyond the suite: the port's other raw paths
    "select id, strpos(s, 'a'), codepoint(s), ends_with(s, '1'), length(s) from txt"
    " where id < 40 order by id",
    "select id, length(s), strpos(s, 'ö'), codepoint(s) from uni order by id",
    "select checksum(s), count(s) from txt",
    "select id % 5 as m, min(s), max(s), count(distinct s) from txt group by id % 5 order by m",
    "select s from txt order by s desc, id limit 7",
    "select s, id from txt order by s, id limit 300",
    "select s, id, row_number() over (partition by substr(s, 1, 3) order by s, id) as rn,"
    " rank() over (order by s) as rk from txt order by id limit 40",
    "select count(*) from txt where s like '%a_p%' or s like '_ravo%'",
    "select s, count(*) from txt where s like '%9' group by s order by s",
]


@pytest.mark.parametrize("sql", SUITE_SQL)
def test_raw_varchar_statements_equal_the_reference(sql):
    assert _suite().check(sql) is not None


def test_the_suite_answers():
    """The suite's own expectations, through the port."""
    port = _suite().port
    assert dict(port.execute("select s, count(*) from txt group by s").rows) == \
        {s: STRINGS.count(s) for s in set(STRINGS)}
    assert [r[0] for r in port.execute("select s from txt order by s, id").rows] == \
        sorted(STRINGS)
    rx = re.compile(r"[0-9][0-9]$")
    assert port.execute("select count(*) from txt where regexp_like(s, '[0-9][0-9]$')"
                        ).rows == [(sum(1 for s in STRINGS if rx.search(s)),)]
    for i, s in port.execute("select id, substr(s, 2, 4) from uni order by id").rows:
        assert s == UNI[i][1:5]


@pytest.mark.parametrize("sql,err", [
    ("select max_by(s, id) from txt", "raw varchar / long decimal unsupported"),
    ("select count(*) from txt, lookup where s < tag",
     "raw-vs-dictionary string comparison unsupported"),
    ("select s || tag from txt, lookup where id < 3", "multi-column concat needs raw varchar"),
], ids=["max_by", "raw_vs_dictionary", "concat_mix"])
def test_the_reference_errors_stay(sql, err):
    """Two-argument extremes over raw values and a raw string against a
    dictionary string (the compilers' ValueError), and a concat mixing
    them (the binders' BindError), raise the same error in both
    packages."""
    suite = _suite()
    with pytest.raises(Exception, match=re.escape(err)) as want:
        suite.ref.execute(sql)
    with pytest.raises(Exception, match=re.escape(err)) as got:
        suite.port.execute(sql)
    assert type(got.value).__name__ == type(want.value).__name__


# -- TPC-H sf 0.01 with raw text columns -------------------------------------------

SF, SPLIT_ROWS = 0.01, 1 << 14
TPCH = ("lineitem", "orders", "customer", "part", "partsupp", "supplier", "nation")


def _ref_raw_tables(mem) -> None:
    """The reference's copies of ``chip_smoke.RAW_TABLES``: each text
    column's codes decoded and the values encoded as raw bytes."""
    import jax.numpy as jnp

    from presto_tpu.ops.rawstring import encode_strings
    from presto_tpu.page import Block, Page
    from presto_tpu.types import VarcharType

    for name, (src, widths) in chip_smoke.RAW_TABLES.items():
        schema = mem.schema(src)
        cols = [c for c, _ in schema]
        pages = []
        for split in range(mem.num_splits(src)):
            page = mem.page_for_split(src, split)
            blocks = list(page.blocks)
            for c, w in widths.items():
                b = blocks[cols.index(c)]
                vals = b.dictionary.decode(np.asarray(b.data))
                blocks[cols.index(c)] = Block(jnp.asarray(encode_strings(list(vals), w)),
                                              b.valid, VarcharType(w, raw=True))
            pages.append(Page(tuple(blocks), page.row_mask))
        mem.create_table(name, [(c, VarcharType(widths[c], raw=True) if c in widths else t)
                                for c, t in schema], pages,
                         {c: mem.column_domain(src, c) for c in cols if c not in widths},
                         mem.primary_key(src), sort_order=mem.sort_order(src))


class _Tpch:
    def __init__(self):
        from presto_tpu.catalog import Catalog as RefCatalog
        from presto_tpu.connectors.memory import MemoryConnector as RefMemory
        from presto_tpu.connectors.tpch import Tpch as RefTpch
        from presto_tpu.runner import QueryRunner as RefRunner
        from presto_tpu_torch.catalog import Catalog
        from presto_tpu_torch.connectors.memory import MemoryConnector
        from presto_tpu_torch.connectors.tpch import Tpch
        from presto_tpu_torch.runner import QueryRunner

        ref_mem = RefMemory()
        for t in TPCH:
            ref_mem.load_from(RefTpch(sf=SF, split_rows=SPLIT_ROWS), t)
        _ref_raw_tables(ref_mem)
        ref_catalog = RefCatalog()
        ref_catalog.register("tpch", ref_mem)
        self.ref = RefRunner(ref_catalog)
        self.mem = MemoryConnector(device="cpu")
        for t in TPCH:
            self.mem.load_from(Tpch(sf=SF, split_rows=SPLIT_ROWS), t)
        chip_smoke.make_raw_tables(self.mem)
        self.catalog = Catalog()
        self.catalog.register("tpch", self.mem)
        self.port = QueryRunner(self.catalog, device="cpu")

    def check(self, sql: str):
        want = self.ref.execute(sql)
        got = self.port.execute(sql)
        assert [str(t) for t in got.types] == [str(t) for t in want.types]
        assert_rows_match(got.rows, want.rows, ordered=True)
        return got.rows


def _tpch() -> _Tpch:
    if "tpch" not in _CACHE:
        _CACHE["tpch"] = _Tpch()
    return _CACHE["tpch"]


@pytest.mark.parametrize("label", sorted(chip_smoke.RAW_QUERIES))
def test_smoke_raw_queries_equal_the_reference(label):
    assert _tpch().check(chip_smoke.RAW_QUERIES[label])


def test_raw_tables_hold_the_dictionary_values():
    """make_raw_tables' byte rows decode to the source columns' values."""
    from presto_tpu_torch.ops.rawstring import decode_strings

    mem = _tpch().mem
    for name, (src, widths) in chip_smoke.RAW_TABLES.items():
        cols = [c for c, _ in mem.schema(src)]
        raw_page, page = mem.page_for_split(name, 0), mem.page_for_split(src, 0)
        for c in widths:
            want = [(v,) for v in page.blocks[cols.index(c)].dictionary.decode(
                page.blocks[cols.index(c)].data.numpy()[:50])]
            got = [(v,) for v in decode_strings(raw_page.blocks[cols.index(c)].data.numpy()[:50])]
            assert got == want, (name, c)


@pytest.mark.parametrize("sql,unique", [
    ("select o_orderkey, c_name, c_phone from orders join customer_raw on "
     "o_custkey = c_custkey where o_orderkey < 400 order by o_orderkey", True),
    ("select c_custkey, c_name, o_comment from customer_raw left join orders_raw on "
     "c_custkey = o_custkey and o_totalprice > 250000 order by c_custkey, o_comment", False),
], ids=["probe", "expand"])
def test_raw_columns_through_joins(sql, unique):
    """A raw column carried through a unique-build join (K5's probe
    gathers its 25- and 15-byte rows) and a non-unique one (K8 expands
    the build's 79-byte rows)."""
    from presto_tpu_torch.planner.plan import JoinNode

    pair = _tpch()
    (join,) = chip_smoke.find_all(pair.port.plan(sql), JoinNode)
    assert join.unique_build == unique
    assert pair.check(sql)


def test_raw_aggregation_spills():
    """Raw min/max by a raw key under a pool at 0.6x its accumulator's
    largest reservation: K11 spills the byte rows and the rows equal the
    unconstrained run's and the reference's."""
    from presto_tpu_torch.exec.local import LocalRunner
    from presto_tpu_torch.memory import MemoryPool
    from presto_tpu_torch.sql.binder import Binder

    sql = ("select substr(o_comment, 1, 6) as head, count(*), min(o_comment), "
           "max(o_comment) from orders_raw group by substr(o_comment, 1, 6)")
    pair = _tpch()

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
