"""K18 ``geo_contains`` and the port's geometry host functions against the
reference's ``presto_tpu/geo.py``.

The twin of K18 (``kernels/geo_contains.geo_contains_plain``, what the
card is held to bit for bit) against the reference's
``bbox_mask(g.bbox, x, y) & points_in_geometry(g, x, y)`` over seeded
points: a square, a polygon with a hole, a MULTIPOLYGON, a triangle
with horizontal edges, star polygons of many vertices and a POINT, with
points on vertices, on edges (slanted, vertical and horizontal), at a
vertex's y, inside holes and outside every bbox; a dictionary column's
codes (out of range, an unparsable value) through the ``ok`` lane as
the reference's ``run_contains_col``; and ``st_area``, ``st_x``, ``st_y``
and ``parse_wkt`` (its errors too).  Every comparison is exact."""

import numpy as np
import pytest
import torch

from presto_tpu import geo as ref_geo
from presto_tpu_torch import geo
from presto_tpu_torch.kernels import geo_contains as k18

SQUARE = "POLYGON ((0 0, 10 0, 10 10, 0 10, 0 0))"
HOLED = "POLYGON ((0 0, 10 0, 10 10, 0 10, 0 0), (4 4, 6 4, 6 6, 4 6, 4 4))"
MULTI = ("MULTIPOLYGON (((0 0, 4 0, 4 4, 0 4, 0 0), (1 1, 2 1, 2 2, 1 2, 1 1)), "
         "((6 6, 9 6, 9 9, 6 9, 6 6)))")
TRIANGLE = "POLYGON ((0 2, 8 2, 4 8, 0 2))"  # a horizontal edge at y = 2
UNCLOSED = "POLYGON ((1 1, 9 1, 5 9))"  # the wrap edge alone closes it
POINT = "POINT (3 4)"


def _star(rng, nv, cx=5.0, cy=5.0, r=4.0):
    ang = np.sort(rng.uniform(0, 2 * np.pi, nv))
    rad = r * rng.uniform(0.4, 1.0, nv)
    pts = [(float(cx + a * np.cos(t)), float(cy + a * np.sin(t))) for a, t in zip(rad, ang)]
    return "POLYGON ((" + ", ".join(f"{x!r} {y!r}" for x, y in pts + pts[:1]) + "))"


def _wkts():
    rng = np.random.default_rng(18)
    return [SQUARE, HOLED, MULTI, TRIANGLE, UNCLOSED, POINT, _star(rng, 7), _star(rng, 400)]


def _points(wkts, seed=5, n=4000):
    """Uniform points over the extent, plus every vertex, every edge's
    midpoint and a quarter point, and points at each vertex's y."""
    rng = np.random.default_rng(seed)
    xs, ys = [rng.uniform(-1, 11, n)], [rng.uniform(-1, 11, n)]
    for w in wkts:
        for ring in ref_geo.parse_wkt(w).rings:
            nxt = np.roll(ring, -1, 0)
            for f in (0.0, 0.5, 0.25):
                p = ring + f * (nxt - ring)
                xs.append(p[:, 0])
                ys.append(p[:, 1])
            xs.append(ring[:, 0] - 0.5)
            ys.append(ring[:, 1])
    return np.concatenate(xs), np.concatenate(ys)


_REFERENCE = {}


def _reference(which):
    """The reference's bbox_mask & points_in_geometry of geometry
    ``which`` over every point of ``_points`` (computed once), op by op
    as the functions are written: under ``jax.jit`` XLA:CPU may fuse
    ``vx + t * (vx2 - vx)`` into one fused multiply-add, which moves a
    point within an ulp of an edge to the other side (9 of the 5788
    points of the 400-vertex star here)."""
    import jax.numpy as jnp

    if which not in _REFERENCE:
        g = ref_geo.parse_wkt(_wkts()[which])
        xs, ys = (jnp.asarray(v) for v in _points(_wkts()))
        _REFERENCE[which] = np.asarray(ref_geo.bbox_mask(g.bbox, xs, ys)
                                       & ref_geo.points_in_geometry(g, xs, ys))
    return _REFERENCE[which]


@pytest.mark.parametrize("which", range(8))
def test_literal_contains_equals_reference(which):
    w = _wkts()[which]
    x, y = _points(_wkts())
    hit, ok = k18.geo_contains(geo.GeometryTable([geo.parse_wkt(w)]), torch.from_numpy(x),
                               torch.from_numpy(y))
    np.testing.assert_array_equal(hit.numpy(), _reference(which), err_msg=w[:40])
    assert bool(ok.all())


def test_column_contains_selects_each_rows_geometry():
    """The reference's ``run_contains_col``: each row its own geometry
    by code; a code out of range or of a value that does not parse is
    not ok (a NULL row)."""
    wkts = _wkts() + ["POLYGON ((1 1, oops))"]
    x, y = _points(_wkts())
    rng = np.random.default_rng(7)
    code = rng.integers(-1, len(wkts) + 1, x.shape[0]).astype(np.int32)
    table = geo.GeometryTable([geo.parse_or_none(w) for w in wkts])
    hit, ok = k18.geo_contains(table, torch.from_numpy(x), torch.from_numpy(y),
                               torch.from_numpy(code))
    want_ok = (code >= 0) & (code < len(wkts) - 1)
    np.testing.assert_array_equal(ok.numpy(), want_ok)
    for gi in range(len(wkts) - 1):
        sel = code == gi
        np.testing.assert_array_equal(hit.numpy()[sel], _reference(gi)[sel])
    assert not hit.numpy()[~want_ok].any()


def test_table_layout_keeps_every_ring_as_parsed():
    table = geo.GeometryTable([geo.parse_wkt(w) for w in (MULTI, POINT)] + [None])
    h = table.host
    np.testing.assert_array_equal(h["kind"], [geo.KIND_POLYGON, geo.KIND_POINT,
                                              geo.KIND_MISSING])
    np.testing.assert_array_equal(h["ring_lo"], [0, 3, 4, 4])
    np.testing.assert_array_equal(np.diff(h["vert_lo"]), [5, 5, 5, 1])
    np.testing.assert_array_equal(table.edges(), [15, 0, 0])
    assert table.vertices == 16


@pytest.mark.parametrize("w", [SQUARE, HOLED, MULTI, TRIANGLE, UNCLOSED, POINT])
def test_host_functions_equal_reference(w):
    g, rg = geo.parse_wkt(w), ref_geo.parse_wkt(w)
    assert (g.kind, g.bbox, g.holes) == (rg.kind, rg.bbox, rg.holes)
    for a, b in zip(g.rings, rg.rings):
        np.testing.assert_array_equal(a, b)
    assert geo.st_area(w) == ref_geo.st_area(w)
    assert geo.st_x(w) == ref_geo.st_x(w) and geo.st_y(w) == ref_geo.st_y(w)


def test_parse_errors():
    for bad in ("LINESTRING (0 0, 1 1)", "POLYGON ((0 0, x 1))"):
        with pytest.raises(ValueError):
            geo.parse_wkt(bad)
        with pytest.raises(ValueError):
            ref_geo.parse_wkt(bad)


def test_dictionary_table_is_shared_and_freed_with_its_dictionary():
    """One geometry table per dictionary, reused by every query over it,
    and dropped (its device copies with it) when the dictionary goes."""
    import gc

    from presto_tpu_torch.page import Dictionary

    d = Dictionary([SQUARE, "POLYGON ((0 0, x 1))", HOLED])
    table = geo.dictionary_table(d)
    assert geo.dictionary_table(d) is table
    assert [g is None for g in table.geoms] == [False, True, False]
    assert table.on("cpu") is table.on("cpu")
    before = len(geo._DICT_TABLES)
    del d, table
    gc.collect()
    assert len(geo._DICT_TABLES) == before - 1
