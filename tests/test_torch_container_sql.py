"""ARRAY, MAP and ROW through both engines' ``QueryRunner``.

Every statement of ``tests/test_array_map.py`` (98) and
``tests/test_named_rows.py`` (9) runs through the reference's runner and
the port's (on the CPU) over the same tables: the suites' memory table
``t`` (``id``, ``arr``, ``mp``, ``g``) and ``pts`` (a named ROW column,
which the reference suite makes by CTAS and the port, which has no CTAS,
gets by ``create_table`` in both connectors), and TPC-H at sf 0.001 for
the histogram statements.  The statements the reference rejects (bind
errors, slice's bounds, a stray or malformed lambda, a ROW cast's arity,
an unknown or unnamed field) are rejected by both.  All 107 statements
run here; none is left out.

Also: the slice's motivating statements and the smoke's containers
phase at TPC-H sf 0.01, ROLLUP and CUBE over no input row (the
grand-total row), the reference's deviations the port follows (pinned),
and the families still deferred, which raise ``NotPorted`` by name.

Rows must be equal; doubles within a relative 1e-9
(``oracle.assert_rows_match``), container values exactly.
"""

import numpy as np
import pytest

from oracle import assert_rows_match
from presto_tpu_torch import NotPorted

MEM_SQL = [
    'SELECT cardinality(ARRAY[1,2,3])',
    'SELECT ARRAY[1,2,3][2]',
    'SELECT element_at(ARRAY[10,20], 5)',
    'SELECT contains(ARRAY[1,2,3], 2)',
    'SELECT array_position(ARRAY[5,6], 6)',
    'SELECT array_position(ARRAY[5,6], 7)',
    'SELECT array_min(ARRAY[3,1,2]), array_max(ARRAY[3,1,2])',
    'SELECT array_sum(ARRAY[1,2,3])',
    'SELECT array_average(ARRAY[1,2,3,4])',
    'SELECT array_sort(ARRAY[3,1,2])',
    'SELECT array_distinct(ARRAY[3,1,3,2,1])',
    'SELECT ARRAY[1, 2.5]',
    'SELECT map(ARRAY[1,2],ARRAY[10,20])[2]',
    'SELECT map_keys(map(ARRAY[1,2],ARRAY[10,20]))',
    'SELECT map_values(map(ARRAY[1,2],ARRAY[10,20]))',
    'SELECT cardinality(map(ARRAY[1,2],ARRAY[10,20]))',
    'SELECT map(ARRAY[1],ARRAY[10])[7]',
    'SELECT id, arr FROM t ORDER BY id',
    'SELECT mp FROM t WHERE id = 2',
    'SELECT id FROM t WHERE cardinality(arr) > 1 ORDER BY id',
    'SELECT id FROM t WHERE contains(arr, 3)',
    'SELECT id, e FROM t CROSS JOIN UNNEST(arr) AS u(e) ORDER BY id, e',
    'SELECT id, e, o FROM t CROSS JOIN UNNEST(arr) WITH ORDINALITY AS u(e, o) ORDER BY id, o',
    'SELECT id, k, v FROM t CROSS JOIN UNNEST(mp) AS u(k, v) ORDER BY id, k',
    'SELECT id, e FROM t, UNNEST(arr) AS u(e) WHERE e > 2 ORDER BY e',
    'SELECT sum(e) FROM t CROSS JOIN UNNEST(arr) AS u(e)',
    'SELECT id, count(e) FROM t CROSS JOIN UNNEST(arr) AS u(e) GROUP BY id ORDER BY id',
    'SELECT id, e FROM t, UNNEST(arr) AS u(e) WHERE CASE WHEN e > 2 THEN true ELSE false END '
     'ORDER BY e',
    'SELECT e FROM t, UNNEST(arr) AS u(e) WHERE e IN (SELECT id FROM t) ORDER BY e',
    'SELECT array_sort(arr) FROM t WHERE id = 4',
    'SELECT array_distinct(ARRAY[9223372036854775807, 1, 9223372036854775807])',
    'SELECT g, array_agg(id) FROM t GROUP BY g ORDER BY g',
    'SELECT array_agg(id) FROM t',
    'SELECT sequence(1, 5)',
    'SELECT sequence(0, 10, 3)',
    'SELECT slice(ARRAY[1,2,3,4,5], 2, 3)',
    'SELECT slice(ARRAY[1,2], 2, 9)',
    'SELECT repeat(7, 3)',
    'SELECT ARRAY[1,2] || ARRAY[3,4]',
    'SELECT slice(ARRAY[1,2,3,4], -2, 2)',
    'SELECT ARRAY[1,2] || 3',
    'SELECT 0 || ARRAY[1]',
    'SELECT ARRAY[1.5] || ARRAY[2.25]',
    'SELECT ARRAY[1, 2] || ARRAY[2.5]',
    'SELECT transform(sequence(1, 4), x -> x * x)',
    'SELECT g, map_agg(id, id * 10) FROM t GROUP BY g ORDER BY g',
    'SELECT cardinality(map_agg(id, g)) FROM t',
    'SELECT map_agg(id, g)[3] FROM t',
    'SELECT e FROM (SELECT array_agg(id) AS a FROM t) CROSS JOIN UNNEST(a) AS u(e) ORDER BY e',
    'SELECT transform(ARRAY[1,2,3], x -> x * 2)',
    'SELECT transform(ARRAY[1,2], x -> x * 0.5)',
    'SELECT id, transform(arr, x -> x + id) FROM t WHERE id <= 2 ORDER BY id',
    'SELECT filter(ARRAY[1,2,3,4], x -> x % 2 = 0)',
    'SELECT id, filter(arr, x -> x > 1) FROM t ORDER BY id',
    'SELECT any_match(ARRAY[1,2], x -> x > 1)',
    'SELECT all_match(ARRAY[2,4], x -> x % 2 = 0)',
    'SELECT none_match(ARRAY[1,3], x -> x > 5)',
    'SELECT any_match(arr, x -> x > 0), all_match(arr, x -> x > 0) FROM t WHERE id = 3',
    'SELECT id FROM t WHERE any_match(arr, x -> x >= 4) ORDER BY id',
    'select map_filter(map(array[1,2,3], array[10,20,30]), (k, v) -> v > 15 and k < 3)',
    'select transform_values(map(array[1,2], array[10,20]), (k, v) -> k + v)',
    'select transform_keys(map(array[1,2], array[10,20]), (k, v) -> k * 100)',
    'select map_filter(map(array[1], array[10]), (k, v) -> v < 0)',
    'select g, map_filter(m, (k, v) -> v >= 2) from (select g, map_agg(k, v) m from (values '
     '(1,1,1),(1,2,2),(2,3,3)) t(g,k,v) group by g) order by g',
    'select zip_with(array[1,2,3], array[10,20,30], (x, y) -> x + y)',
    'select zip_with(array[1,2], array[10], (x, y) -> coalesce(y, 0) + x)',
    'select zip_with(array[1,2], array[3,4], (x, y) -> x * y)',
    'select reduce(array[5,20,50], 0, (s, x) -> s + x, s -> s)',
    'select reduce(array[5,20,50], cast(1 as double), (s, x) -> s * x, s -> s / 2)',
    'select reduce(array[1, null, 3], 0, (s, x) -> s + coalesce(x, 100), s -> s)',
    'select id, reduce(array[1, 2], id, (s, x) -> s + x, s -> s) from t order by 1',
    'select array_intersect(array[1,2,2,3], array[2,3,4])',
    'select array_union(array[1,2], array[2,3])',
    'select array_except(array[1,2,3], array[2])',
    'select array_remove(array[1,2,1,3], 1)',
    'select arrays_overlap(array[1,2], array[2,3]), arrays_overlap(array[1], array[3])',
    'select arrays_overlap(array[1, null], array[3])',
    'select arrays_overlap(array[1, null], array[1])',
    'select map_concat(map(array[1], array[10]), map(array[1,2], array[99,20]))',
    'select map_concat(map(array[1], array[1]), map(array[2], array[2]), map(array[1], array[7]))',
    'select map_concat(map(array[1], array[10]), map(array[1], array[99]))[1]',
    'select transform(array[1,2], (x) -> x + 1)',
    'select transform(array[1,2], x -> array_sum(transform(array[10], y -> y + x)))',
    'select array_intersect(a, b), array_except(a, b), arrays_overlap(a, b) from (select '
     'array[1,2] a, array[2.5, 3.5] b) t',
    'select array_intersect(a, b) from (select array[1,2] a, array[2.0, 3.5] b) t',
    'select map_concat(map(array[1], array[10]), map(array[2], array[2.5]))',
    'select transform_keys(map(array[1,2], array[10,20]), (k, v) -> 0)',
    'select transform_keys(map(array[1,2], array[10,20]), (k, v) -> 0)[0]',
]

HISTOGRAM_SQL = [
    'SELECT histogram(n_regionkey) FROM nation',
    'SELECT n_regionkey, histogram(n_nationkey % 2) FROM nation GROUP BY n_regionkey ORDER '
     'BY n_regionkey',
    'SELECT cardinality(histogram(n_regionkey)) FROM nation',
]


# the statements the reference rejects: both runners must
REJECTED_SQL = [
    "SELECT slice(ARRAY[1,2], 0, 1)",
    "SELECT slice(ARRAY[1,2], 1, -1)",
    "SELECT x -> x + 1",
    "select map_concat(map(array[1], array[10]))",
    "select array_intersect(array[1])",
    "select arrays_overlap(array[1])",
    "select zip_with(array[1], array[2], (x, y,) -> x + y)",
    "select p.z from pts",
    "select r.q from (select row(1, 2) as r) t",
    "select cast(row(1, 2) as row(x bigint))",
]

# container columns carried through joins, sorts, top-N and IN
JOIN_SQL = [
    "select t.id, x.a from (select g, array_agg(id) a from t group by g) x join t "
    "on x.g = t.id order by t.id",
    "select t.id, x.a, t.arr from t left join (select g, array_agg(id) a from t group by g) x "
    "on x.g = t.id order by t.id",
    "select id, arr from t order by id desc limit 2",
    "select id, arr, mp from t where id in (select g from t) order by id",
]

NAMED_ROWS_SQL = [
    "select cast(row(1, 2) as row(x bigint, y bigint)).x",
    "select cast(row(1, 2.5) as row(a bigint, b double)).b + 1",
    "select p.y from pts",
    "select p.x + p.y from pts where p.x >= 2",
    "select t.p.y from pts t where t.p.x = 3",
    "select p.x % 2 as odd, sum(p.y) from pts group by 1",
]

# the slice's motivating statements (TPC-H sf 0.01)
TPCH_SQL = [
    "select array[1,2,3]",
    "select cardinality(array[1,2,3])",
    "select n_regionkey, array_agg(n_nationkey) from nation group by 1 order by 1",
    "select n_regionkey, array_agg(n_name) from nation group by 1 order by 1",
    "select x from unnest(array[1,2]) t(x)",
    "select split(n_name, 'A') from nation",
    "select n_name, split(n_name, 'A')[1], cardinality(split(n_name, 'A')) from nation "
    "order by 1",
    "select transform(array[1,2], x -> x * 2)",
    "select cast(row(1, 2) as row(x bigint, y bigint)).x",
    "select row(n_nationkey, n_regionkey) from nation",
    "select histogram(l_shipmode) from lineitem",
    "select l_returnflag, histogram(l_linestatus) from lineitem group by 1 order by 1",
    "select numeric_histogram(4, l_quantity) from lineitem",
    "select o_orderstatus, map_agg(o_orderkey, o_totalprice) from orders "
    "where o_orderkey < 60 group by 1 order by 1",
    "select array_agg(o_totalprice) from orders where o_orderkey < 40",
]
# chip_smoke.py's CT_QUERIES, at sf 0.01
SMOKE_SQL = {
    "ct_array_agg": "select count(*), sum(cardinality(a)), sum(array_sum(a)), "
                    "sum(element_at(a, 1)) from (select l_orderkey, array_agg(l_partkey) a "
                    "from lineitem group by l_orderkey)",
    "ct_unnest": "select count(*), sum(e), sum(o), max(o) from (select l_orderkey, "
                 "array_agg(l_partkey) a from lineitem group by l_orderkey) cross join "
                 "unnest(a) with ordinality as u(e, o)",
    "ct_words": "select w, count(*) c from part cross join unnest(split(p_name, ' ')) as u(w) "
                "group by w order by c desc, w limit 10",
    "ct_histogram": "select histogram(l_shipmode) from lineitem",
    "ct_histogram_by": "select l_returnflag, histogram(l_linenumber) from lineitem "
                       "group by 1 order by 1",
    "ct_map_agg": "select map_agg(l_returnflag, c), cardinality(map_agg(l_returnflag, c)) "
                  "from (select l_returnflag, count(*) c from lineitem group by 1)",
    "ct_row_ops": "select sum(case when contains(array[1, 5, 7], l_linenumber) then 1 else 0 "
                  "end), sum(array[l_partkey, l_suppkey][2]), "
                  "sum(map(array['A','N','R'], array[1,2,3])[l_returnflag]), "
                  "sum(cast(row(l_partkey, l_suppkey) as row(x bigint, y bigint)).x) "
                  "from lineitem",
    "ct_lambdas": "select count(*), sum(array_sum(transform(a, x -> x * 2))), "
                  "sum(cardinality(filter(a, x -> x % 2 = 0))), "
                  "sum(case when any_match(a, x -> x > 100000) then 1 else 0 end), "
                  "sum(reduce(a, 0, (s, x) -> s + x, s -> s)) from (select l_orderkey, "
                  "array_agg(l_partkey) a from lineitem group by l_orderkey)",
}
GROUPING_EMPTY_SQL = [
    "select n_regionkey, count(*), sum(n_nationkey) from nation where n_nationkey < 0 "
    "group by rollup(n_regionkey)",
    "select n_regionkey, n_name, count(*), max(n_nationkey) from nation "
    "where n_nationkey < 0 group by cube(n_regionkey, n_name)",
]
# still with the reference, by the name the port raises
DEFERRED = {
    "multimap_agg": ("select multimap_agg(n_regionkey, n_nationkey) from nation",
                     "aggregate multimap_agg"),
    "map_union": ("select map_union(m) from (select map_agg(n_nationkey, n_regionkey) m "
                  "from nation group by n_regionkey)", "aggregate map_union"),
    "approx_set": ("select cardinality(approx_set(n_nationkey)) from nation",
                   "aggregate hll_sketch"),
    "setdigest": ("select jaccard_index(make_set_digest(n_nationkey), "
                  "make_set_digest(n_regionkey)) from nation", "aggregate make_set_digest"),
}


def _check(got, want, sql):
    assert got.names == want.names
    assert [str(t) for t in got.types] == [str(t) for t in want.types]
    ordered = "order by" in sql.lower().rsplit(")", 1)[-1]
    g, w = got.rows, want.rows
    if not ordered:
        g, w = sorted(g, key=repr), sorted(w, key=repr)
    assert_rows_match(g, w, ordered=True)


@pytest.fixture(scope="module")
def mem_runners():
    """Both runners over the suites' tables ``t`` and ``pts``."""
    from presto_tpu.catalog import Catalog
    from presto_tpu.connectors.memory import MemoryConnector
    from presto_tpu.page import Page
    from presto_tpu.runner import QueryRunner
    from presto_tpu import types as rt
    from presto_tpu_torch import types as pt
    from presto_tpu_torch.catalog import Catalog as PortCatalog
    from presto_tpu_torch.connectors.memory import MemoryConnector as PortMemory
    from presto_tpu_torch.page import Page as PortPage
    from presto_tpu_torch.runner import QueryRunner as PortRunner

    vals = [np.arange(1, 5), [[1, 2], [3], [], [4, 5, None]],
            [{1: 10}, {2: 20, 3: 30}, {}, {9: None}], np.array([1, 1, 2, 2])]
    pts = np.array([[1, 10], [2, 20], [3, 30]], dtype=np.int64)
    out = []
    for types, Memory, PageCls, CatalogCls, Runner, kw in (
            (rt, MemoryConnector, Page, Catalog, QueryRunner, {}),
            (pt, PortMemory, PortPage, PortCatalog, PortRunner, {"device": "cpu"})):
        at, mt = types.ArrayType(types.BIGINT, 4), types.MapType(types.BIGINT, types.BIGINT, 4)
        rowt = types.parse_type("row(x bigint, y bigint)")
        mem = Memory(**kw)
        schema = [("id", types.BIGINT), ("arr", at), ("mp", mt), ("g", types.BIGINT)]
        mem.create_table("t", schema, [PageCls.from_arrays(vals, [t for _, t in schema], **kw)])
        mem.create_table("pts", [("p", rowt)], [PageCls.from_arrays([pts], [rowt], **kw)])
        cat = CatalogCls()
        cat.register("mem", mem)
        out.append(Runner(cat, **kw))
    return tuple(out)


class _Pairs:
    def __init__(self):
        self._by_sf = {}

    def __call__(self, sf):
        if sf not in self._by_sf:
            from torch_fn_parity import TpchPair

            self._by_sf[sf] = TpchPair(sf=sf, split_rows=4096)
        return self._by_sf[sf]


_PAIRS = _Pairs()


@pytest.mark.parametrize("i", range(len(MEM_SQL)))
def test_array_map_statement_equals_reference(mem_runners, i):
    ref, port = mem_runners
    sql = MEM_SQL[i]
    _check(port.execute(sql), ref.execute(sql), sql)


@pytest.mark.parametrize("i", range(len(JOIN_SQL)))
def test_container_columns_through_joins_and_sorts(mem_runners, i):
    ref, port = mem_runners
    sql = JOIN_SQL[i]
    _check(port.execute(sql), ref.execute(sql), sql)


def test_unnest_replicates_only_the_columns_read(mem_runners):
    """An UNNEST under a chain copies only the page columns the chain
    reads: the aggregated array column is not replicated per element."""
    from presto_tpu_torch.exec.local import _leaf_columns_read
    from presto_tpu_torch.planner.plan import AggregationNode, UnnestNode

    ref, port = mem_runners
    sql = ("select count(*), sum(e), max(o) from (select g, array_agg(id) a from t group by g) "
           "cross join unnest(a) with ordinality as u(e, o)")
    _check(port.execute(sql), ref.execute(sql), sql)
    plan = port.plan(sql)

    def find(n, cls):
        if isinstance(n, cls):
            return n
        return next((f for f in (find(c, cls) for c in n.sources) if f is not None), None)

    leaf = find(plan, UnnestNode)
    top = port.executor.partial_node(find(plan, AggregationNode))
    needed = _leaf_columns_read(top, leaf)
    assert needed is not None and 1 not in needed  # column 1: the array a


@pytest.mark.parametrize("i", range(len(NAMED_ROWS_SQL)))
def test_named_rows_statement_equals_reference(mem_runners, i):
    ref, port = mem_runners
    sql = NAMED_ROWS_SQL[i]
    _check(port.execute(sql), ref.execute(sql), sql)


@pytest.mark.parametrize("i", range(len(REJECTED_SQL)))
def test_rejected_statement_is_rejected_by_both(mem_runners, i):
    ref, port = mem_runners
    sql = REJECTED_SQL[i]
    with pytest.raises(Exception):
        ref.execute(sql)
    with pytest.raises(Exception) as e:
        port.execute(sql)
    assert not isinstance(e.value, NotPorted), e.value


@pytest.mark.parametrize("i", range(len(HISTOGRAM_SQL)))
def test_histogram_statement_equals_reference(i):
    pair = _PAIRS(0.001)
    assert pair.check(HISTOGRAM_SQL[i])


@pytest.mark.parametrize("i", range(len(TPCH_SQL)))
def test_motivating_statement_equals_reference(i):
    assert _PAIRS(0.01).check(TPCH_SQL[i]) is not None


@pytest.mark.parametrize("name", sorted(SMOKE_SQL))
def test_smoke_container_query_equals_reference(name):
    rows = _PAIRS(0.01).check(SMOKE_SQL[name])
    assert rows


@pytest.mark.parametrize("i", range(len(GROUPING_EMPTY_SQL)))
def test_grouping_sets_over_no_row_emit_the_grand_total(i):
    """ROLLUP / CUBE over an input with no row: the set with no key
    still emits its one global row (count 0, NULL elsewhere), as the
    reference's ``_groupid_empty_fixup`` adds it."""
    rows = _PAIRS(0.001).check(GROUPING_EMPTY_SQL[i])
    assert len(rows) == 1 and rows[0][-2 if i == 1 else 1] == 0
    assert all(v is None for v in rows[0][:-2 if i == 1 else 1])


def test_reference_deviations_are_followed():
    """A fault of the reference the port keeps (ROADMAP queue C):
    histogram over a varchar loses map_agg's key dictionary, so every key
    decodes as NULL and the map collapses to one entry."""
    port = _PAIRS(0.01).port
    (hist,), = port.execute("select histogram(l_shipmode) from lineitem").rows
    assert list(hist) == [None]


@pytest.mark.parametrize("name", sorted(DEFERRED))
def test_deferred_container_families_raise_by_name(name):
    sql, what = DEFERRED[name]
    with pytest.raises(NotPorted) as e:
        _PAIRS(0.001).port.execute(sql)
    assert e.value.what == what
