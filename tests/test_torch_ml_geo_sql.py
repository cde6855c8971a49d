"""The fifteenth slice's SQL: the ML aggregates and the geospatial
functions through the port's ``QueryRunner`` on the CPU against the
reference's runner.

- every statement of ``tests/test_ml.py`` and ``tests/test_geospatial.py``
  over the same ``MemoryConnector`` tables built in both packages (the
  suites' ``train``, ``t2``, ``points`` and ``regions``);
- ``chip_smoke.py``'s ML queries over TPC-H lineitem at sf 0.01 and its
  geo queries over ``chip_smoke.make_geo_tables``' zones and trips cut
  to 16 zones and 1/1024 of the points (the reference side built from
  the same seeded values);
- the three aggregates that ``test_torch_function_agg_sql`` pinned as
  refused, an ML aggregation spilled under a small pool (K11), and the
  reference's errors: a bare ``ST_Point``, a geometry column that is not
  dictionary-coded (a raw varchar), a bad WKT literal.

Tolerances: integers, strings and the geo results exactly (the
point-in-polygon test is the reference's bit for bit); doubles within a
relative 1e-9 (``oracle.assert_rows_match``); a learn_classifier model
lane by lane (``torch_parity.assert_models_close``: the class count
exactly, each other lane within a relative 1e-9 of that lane's largest
magnitude over the rows); learn_regressor's weights: the port eliminates
the normal equations itself where the reference calls LAPACK's solve, so
those agree to the conditioning of ``X'X + 1e-8 I``, held to ``1e3 *
cond * eps`` of the weights' norm with ``cond`` from numpy over the same
table's features (the lineitem features' ranges differ by three orders,
so that bound is looser there)."""

import math

import numpy as np
import pytest

import chip_smoke
from oracle import assert_rows_match
from torch_parity import assert_models_close

TPCH_SF, SPLIT_ROWS = 0.01, 1 << 14
GEO_DIV, GEO_ZONES = 1024, 16
SQUARE = "POLYGON ((0 0, 10 0, 10 10, 0 10, 0 0))"
HOLED = "POLYGON ((0 0, 10 0, 10 10, 0 10, 0 0), (4 4, 6 4, 6 6, 4 6, 4 4))"
FAR = "POLYGON ((100 100, 110 100, 110 110, 100 110, 100 100))"


def _suite_tables(pkg):
    """The suites' tables and the geo tables in one package's
    MemoryConnector: (connector module, page module, types module)."""
    memory, page, types = pkg
    ref = memory.__name__.startswith("presto_tpu.")
    mem = memory.MemoryConnector(**({} if ref else {"device": "cpu"}))
    T = types
    rng = np.random.RandomState(7)
    n = 400
    x1, x2 = rng.uniform(-3, 3, n), rng.uniform(-3, 3, n)
    y = 2.0 * x1 - 0.5 * x2 + 1.25
    cls = (x1 + x2 > 0).astype(np.int64)
    mem.create_table("train", [("x1", T.DOUBLE), ("x2", T.DOUBLE), ("y", T.DOUBLE),
                               ("label", T.BIGINT)],
                     [page.Page.from_arrays([x1, x2, y, cls],
                                            [T.DOUBLE, T.DOUBLE, T.DOUBLE, T.BIGINT])])
    xs = np.linspace(-2, 2, 50)
    mem.create_table("t2", [("x", T.DOUBLE), ("y", T.DOUBLE)], [
        page.Page.from_arrays([xs[:25], 3 * xs[:25] + 1], [T.DOUBLE, T.DOUBLE]),
        page.Page.from_arrays([xs[25:], 3 * xs[25:] + 1], [T.DOUBLE, T.DOUBLE])])
    mem.create_table("points", [("pid", T.BIGINT), ("x", T.DOUBLE), ("y", T.DOUBLE)], [
        page.Page.from_arrays([np.arange(1, 5), np.asarray([1.0, 5.0, 50.0, 105.0]),
                               np.asarray([1.0, 5.0, 5.0, 105.0])],
                              [T.BIGINT, T.DOUBLE, T.DOUBLE])])
    mem.create_table("regions", [("rid", T.BIGINT), ("geom", T.VARCHAR)], [
        page.Page.from_arrays([np.arange(1, 3), np.arange(2, dtype=np.int32)],
                              [T.BIGINT, T.VARCHAR],
                              dictionaries=[None, page.Dictionary([SQUARE, FAR])])])
    raw = T.VarcharType(120, raw=True)
    mem.create_table("regions_raw", [("rid", T.BIGINT), ("geom", raw)], [
        page.Page.from_arrays([np.arange(1, 3), [SQUARE, FAR]], [T.BIGINT, raw])])
    if not ref:
        chip_smoke.make_geo_tables(mem, GEO_DIV, zones=GEO_ZONES)
        return mem
    live = np.ones(GEO_ZONES, bool)
    mem.create_table("zones", [("zid", T.BIGINT), ("geom", T.VARCHAR)], [
        page.Page.from_arrays([np.arange(1, GEO_ZONES + 1), np.arange(GEO_ZONES,
                                                                      dtype=np.int32)],
                              [T.BIGINT, T.VARCHAR], valids=[live, live],
                              dictionaries=[None, page.Dictionary(
                                  chip_smoke.geo_zones(zones=GEO_ZONES))])],
                     {"zid": (1, GEO_ZONES)})
    x, y = chip_smoke.geo_points(GEO_DIV)
    for name, rows in (("trips", x.shape[0]), ("trips_sample",
                                                chip_smoke.GEO_SAMPLE // GEO_DIV)):
        mem.create_table(name, [("tid", T.BIGINT), ("x", T.DOUBLE), ("y", T.DOUBLE)], [
            page.Page.from_arrays([np.arange(rows), x[:rows], y[:rows]],
                                  [T.BIGINT, T.DOUBLE, T.DOUBLE])], {"tid": (0, rows - 1)})
    return mem


class _Pair:
    def __init__(self):
        import presto_tpu.connectors.memory as ref_memory
        import presto_tpu.page as ref_page
        import presto_tpu.types as ref_types
        import presto_tpu_torch.connectors.memory as memory
        import presto_tpu_torch.page as page
        import presto_tpu_torch.types as types
        from presto_tpu.catalog import Catalog as RefCatalog
        from presto_tpu.connectors.tpch import Tpch as RefTpch
        from presto_tpu.runner import QueryRunner as RefRunner
        from presto_tpu_torch.catalog import Catalog
        from presto_tpu_torch.connectors.tpch import Tpch
        from presto_tpu_torch.runner import QueryRunner

        ref_catalog = RefCatalog()
        ref_catalog.register("mem", _suite_tables((ref_memory, ref_page, ref_types)))
        ref_catalog.register("tpch", RefTpch(sf=TPCH_SF, split_rows=SPLIT_ROWS))
        self.ref = RefRunner(ref_catalog)
        self.catalog = Catalog()
        self.catalog.register("mem", _suite_tables((memory, page, types)))
        self.catalog.register("tpch", Tpch(sf=TPCH_SF, split_rows=SPLIT_ROWS))
        self.port = QueryRunner(self.catalog, device="cpu")

    def check(self, sql: str, weights_bound: float = 0.0):
        """The port's rows against the reference's (the module's
        tolerances; ``weights_bound``: learn_regressor's relative bound)."""
        want = self.ref.execute(sql)
        got = self.port.execute(sql)
        assert got.names == want.names
        assert [str(t) for t in got.types] == [str(t) for t in want.types]
        lists = [j for j, t in enumerate(got.types) if t.is_array]
        if not lists:
            assert_rows_match(got.rows, want.rows, ordered="order by" in sql.lower())
            return got.rows
        assert len(got.rows) == len(want.rows)
        for g, w in zip(got.rows, want.rows):
            assert_rows_match([tuple(v for j, v in enumerate(g) if j not in lists)],
                              [tuple(v for j, v in enumerate(w) if j not in lists)], True)
        for j in lists:
            assert_models_close([g[j] for g in got.rows], [w[j] for w in want.rows],
                                weights_bound, sql)
        return got.rows


_CACHE = {}


def _pair() -> _Pair:
    if "pair" not in _CACHE:
        _CACHE["pair"] = _Pair()
    return _CACHE["pair"]


def _cond_bound(features: np.ndarray) -> float:
    """``1e3 * cond * eps`` of ``X'X + 1e-8 I`` over the rows' features
    and the bias column."""
    xa = np.concatenate([features, np.ones((features.shape[0], 1))], 1)
    a = xa.T @ xa + 1e-8 * np.eye(xa.shape[1])
    return 1e3 * np.linalg.cond(a) * np.finfo(np.float64).eps


# tests/test_ml.py's and tests/test_geospatial.py's statements
ML_SUITE = [
    "SELECT learn_regressor(y, features(x1, x2)) FROM train",
    "SELECT regress(m, features(1.0, 2.0)) FROM "
    "(SELECT learn_regressor(y, features(x1, x2)) AS m FROM train)",
    "SELECT avg(CASE WHEN classify(m, features(x1, x2)) = label "
    "THEN 1.0 ELSE 0.0 END) FROM train "
    "CROSS JOIN (SELECT learn_classifier(label, features(x1, x2)) AS m FROM train)",
    "SELECT label, learn_regressor(y, features(x1, x2)) FROM train "
    "GROUP BY label ORDER BY label",
    "SELECT learn_regressor(y, features(x)) FROM t2",
    "select evaluate_classifier_predictions(t, p) from "
    "(values (1,1),(1,1),(0,1),(0,0),(1,0)) x(t, p)",
    "select g, evaluate_classifier_predictions(t, p) from "
    "(values (7,1,1),(7,0,1),(8,1,1),(8,0,0)) x(g,t,p) group by g",
]
GEO_SUITE = [
    f"SELECT ST_Area(ST_GeometryFromText('{SQUARE}'))",
    "SELECT ST_X(ST_GeometryFromText('POINT (3 4)')), "
    "ST_Y(ST_GeometryFromText('POINT (3 4)'))",
    "SELECT ST_Distance(ST_Point(0, 0), ST_Point(3, 4))",
    f"SELECT pid FROM points WHERE ST_Contains(ST_GeometryFromText('{SQUARE}'), "
    "ST_Point(x, y)) ORDER BY pid",
    f"SELECT pid FROM points WHERE ST_Contains(ST_GeometryFromText('{HOLED}'), "
    "ST_Point(x, y)) ORDER BY pid",
    "SELECT r.rid, p.pid FROM regions r, points p "
    "WHERE ST_Contains(r.geom, ST_Point(p.x, p.y)) ORDER BY r.rid, p.pid",
    "SELECT pid, ST_Distance(ST_Point(x, y), ST_Point(0, 0)) AS d "
    "FROM points ORDER BY pid LIMIT 2",
    "SELECT rid, ST_Area(geom) FROM regions ORDER BY rid",
    # beyond the suite: a literal POINT's coordinates and NULL paths
    "SELECT pid, ST_Distance(ST_GeometryFromText('POINT (1 1)'), ST_Point(x, y)), "
    "ST_Contains(ST_GeometryFromText('POINT (5 5)'), ST_Point(x, y)) FROM points ORDER BY pid",
    "SELECT rid, ST_X(geom), ST_Area(ST_GeometryFromText(geom)) FROM regions ORDER BY rid",
    "SELECT count_if(ST_Contains(r.geom, ST_Point(p.x, p.y))) FROM regions r, points p",
]


@pytest.mark.parametrize("sql", ML_SUITE)
def test_ml_suite_equals_the_reference(sql):
    assert _pair().check(sql)


@pytest.mark.parametrize("sql", GEO_SUITE)
def test_geo_suite_equals_the_reference(sql):
    assert _pair().check(sql)


def test_suite_values():
    """The suites' own assertions hold for the port's rows."""
    port = _pair().port
    (model,) = port.execute(ML_SUITE[0]).rows[0]
    assert model == pytest.approx([2.0, -0.5, 1.25], abs=1e-6)
    assert port.execute(ML_SUITE[2]).rows[0][0] > 0.9
    assert port.execute(ML_SUITE[5]).rows[0][0].startswith("Accuracy: 3/5 (60.00%)\n")
    assert port.execute(GEO_SUITE[5]).rows == [(1, 1), (1, 2), (2, 4)]
    assert port.execute(GEO_SUITE[4]).rows == [(1,)]


def _lineitem_bound() -> float:
    """The weights' bound over lineitem's features (quantity, discount,
    tax as doubles), from numpy."""
    if "bound" not in _CACHE:
        rows = _pair().port.execute("select cast(l_quantity as double), "
                                    "cast(l_discount as double), cast(l_tax as double) "
                                    "from lineitem").rows
        _CACHE["bound"] = _cond_bound(np.asarray(rows, np.float64))
    return _CACHE["bound"]


@pytest.mark.parametrize("label", sorted(chip_smoke.ML_QUERIES))
def test_smoke_ml_queries_equal_the_reference(label):
    assert _pair().check(chip_smoke.ML_QUERIES[label], _lineitem_bound())


@pytest.mark.parametrize("label", sorted(chip_smoke.GEO_QUERIES))
def test_smoke_geo_queries_equal_the_reference(label):
    assert _pair().check(chip_smoke.GEO_QUERIES[label])


@pytest.mark.parametrize("sql", [
    "select learn_classifier(o_shippriority, array[o_totalprice]) from orders",
    "select evaluate_classifier_predictions(o_orderstatus, o_orderstatus) from orders",
    "select st_distance(st_point(o_totalprice, 1.0), st_point(0.0, 0.0)) from orders",
], ids=["learn_classifier", "evaluate_classifier", "st_distance"])
def test_formerly_refused_families_equal_the_reference(sql):
    """A decimal array's unscaled values as features, a varchar label's
    dictionary codes as class ids (the reference's reading), a decimal
    coordinate as a double."""
    assert _pair().check(sql)


@pytest.mark.parametrize("sql,what", [
    ("select st_point(x, y) from points", "ST_Point is only usable"),
    ("select count(*) from regions_raw r, points p "
     "where ST_Contains(r.geom, ST_Point(p.x, p.y))", "dictionary varchar column"),
    ("select ST_Area(geom) from regions_raw", "dictionary varchar column"),
    ("select pid from points where ST_Contains(ST_GeometryFromText('LINESTRING (0 0, 1 1)'), "
     "ST_Point(x, y))", "unsupported WKT"),
], ids=["bare_point", "raw_contains", "raw_area", "bad_wkt"])
def test_reference_errors_raise_the_same(sql, what):
    pair = _pair()
    for runner in (pair.ref, pair.port):
        with pytest.raises(ValueError, match=what):
            runner.execute(sql)


def test_ml_aggregation_spills():
    """learn_regressor by l_suppkey under a pool at 0.6x its
    accumulator's largest reservation: K11 spills the rows (features
    and all) and the models equal the unconstrained run's bit for bit
    and the reference's within the bound."""
    from presto_tpu_torch.exec.local import LocalRunner
    from presto_tpu_torch.memory import MemoryPool
    from presto_tpu_torch.sql.binder import Binder

    sql = ("select l_suppkey, learn_regressor(l_extendedprice, features(l_quantity, "
           "l_discount, l_tax)) as m, count(*) from lineitem where l_suppkey < 40 "
           "group by l_suppkey")
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
    key = lambda r: r[0]  # noqa: E731
    assert sorted(rows, key=key) == sorted(expected, key=key)
    want = sorted(pair.ref.execute(sql).rows, key=key)
    bound = _lineitem_bound()
    for g, w in zip(sorted(rows, key=key), want):
        assert g[0] == w[0] and g[2] == w[2]
        assert all(math.isclose(a, b, rel_tol=0, abs_tol=bound * max(map(abs, w[1])))
                   for a, b in zip(g[1], w[1]))
