"""Geospatial support: WKT geometries and their host functions.

Counterpart of the host half of ``presto_tpu/geo.py`` (``Geometry`` :35,
``parse_wkt`` :68, ``_split_top``, ``_parse_poly_body``, ``st_area``
:175, ``st_x`` :185, ``st_y`` :190).
Geometries are WKT strings riding dictionary-coded VARCHAR columns: each
distinct value parses once on the host.  The per-row device work, the
point-in-polygon test of ``ST_Contains`` (the reference's
``points_in_geometry`` :137 and ``bbox_mask`` :166), is K18
``geo_contains`` (``kernels/geo_contains.py``) over the flattened table
that :class:`GeometryTable` builds from parsed geometries;
``ST_Distance`` lowers to K1's double opcodes
(``expr/compile.py``).
"""

from __future__ import annotations

import math
import re
import weakref
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

_WKT_CACHE: Dict[str, "Geometry"] = {}


class Geometry:
    """Parsed geometry: kind + rings (list of (nv, 2) float arrays).
    POINT -> one 1-vertex ring; POLYGON -> outer ring + holes;
    MULTIPOLYGON -> every part's rings, flattened, with hole flags."""

    __slots__ = ("kind", "rings", "holes", "bbox")

    def __init__(self, kind: str, rings: List[np.ndarray], holes: List[bool]):
        self.kind = kind
        self.rings = rings
        self.holes = holes
        if rings:
            allv = np.concatenate(rings, axis=0)
            self.bbox = (float(allv[:, 0].min()), float(allv[:, 1].min()),
                         float(allv[:, 0].max()), float(allv[:, 1].max()))
        else:
            self.bbox = (math.inf, math.inf, -math.inf, -math.inf)

    @property
    def point(self) -> Tuple[float, float]:
        assert self.kind == "POINT"
        return float(self.rings[0][0, 0]), float(self.rings[0][0, 1])


def _parse_ring(text: str) -> np.ndarray:
    pts = []
    for pair in text.split(","):
        xy = pair.strip().split()
        pts.append((float(xy[0]), float(xy[1])))
    return np.asarray(pts, dtype=np.float64)


def parse_wkt(wkt: str) -> Geometry:
    """POINT / POLYGON / MULTIPOLYGON subset of GeoFunctions'
    ST_GeometryFromText surface; ValueError on anything else."""
    cached = _WKT_CACHE.get(wkt)
    if cached is not None:
        return cached
    s = wkt.strip()
    m = re.match(r"(?is)^\s*POINT\s*\(\s*([-\d.eE]+)\s+([-\d.eE]+)\s*\)\s*$", s)
    if m:
        g = Geometry("POINT", [np.asarray([[float(m.group(1)), float(m.group(2))]])], [False])
        _WKT_CACHE[wkt] = g
        return g
    m = re.match(r"(?is)^\s*POLYGON\s*\((.*)\)\s*$", s)
    if m:
        rings, holes = _parse_poly_body(m.group(1))
        g = Geometry("POLYGON", rings, holes)
        _WKT_CACHE[wkt] = g
        return g
    m = re.match(r"(?is)^\s*MULTIPOLYGON\s*\((.*)\)\s*$", s)
    if m:
        rings, holes = [], []
        for poly in _split_top(m.group(1)):
            poly = poly.strip()
            if poly.startswith("("):
                poly = poly[1:-1]
            r, h = _parse_poly_body(poly)
            rings.extend(r)
            holes.extend(h)
        g = Geometry("MULTIPOLYGON", rings, holes)
        _WKT_CACHE[wkt] = g
        return g
    raise ValueError(f"unsupported WKT: {wkt[:40]!r}")


def _split_top(s: str) -> List[str]:
    out, depth, cur = [], 0, []
    for ch in s:
        if ch == "(":
            depth += 1
        elif ch == ")":
            depth -= 1
        if ch == "," and depth == 0:
            out.append("".join(cur))
            cur = []
        else:
            cur.append(ch)
    if cur:
        out.append("".join(cur))
    return out


def _parse_poly_body(body: str):
    """'(ring1),(ring2)...' -> rings + hole flags (first ring = shell)."""
    rings, holes = [], []
    for i, ring in enumerate(_split_top(body)):
        ring = ring.strip()
        if ring.startswith("("):
            ring = ring[1:-1]
        rings.append(_parse_ring(ring))
        holes.append(i > 0)
    return rings, holes


def parse_or_none(wkt: Optional[str]) -> Optional[Geometry]:
    """A dictionary value's geometry, None where it does not parse (the
    reference's ``run_contains_col`` and ``_geo_float_lut`` give such
    rows NULL)."""
    if wkt is None:
        return None
    try:
        return parse_wkt(wkt)
    except Exception:
        return None


# ---------------------------------------------------------------------------
# host-side geometry scalar ops (per distinct WKT; K1's value tables)
# ---------------------------------------------------------------------------

def st_area(wkt: str) -> float:
    g = parse_wkt(wkt)
    total = 0.0
    for ring, hole in zip(g.rings, g.holes):
        x, y = ring[:, 0], ring[:, 1]
        a = 0.5 * abs(float(np.dot(x, np.roll(y, -1)) - np.dot(np.roll(x, -1), y)))
        total += -a if hole else a
    return total


def st_x(wkt: str) -> Optional[float]:
    g = parse_wkt(wkt)
    return g.point[0] if g.kind == "POINT" else None


def st_y(wkt: str) -> Optional[float]:
    g = parse_wkt(wkt)
    return g.point[1] if g.kind == "POINT" else None


# ---------------------------------------------------------------------------
# the flattened table K18 reads
# ---------------------------------------------------------------------------

# a geometry's kind in the table
KIND_MISSING, KIND_POINT, KIND_POLYGON = -1, 0, 1


class GeometryTable:
    """Geometries flattened for K18: per geometry its kind (``KIND_*``;
    a value that did not parse is ``KIND_MISSING``), its bbox ``(x0, y0,
    x1, y1)`` and its rings ``ring_lo[g] .. ring_lo[g + 1]``; per ring
    its vertices ``vert_lo[r] .. vert_lo[r + 1]`` as parsed (the closing
    vertex repeated; the wrap edge from the last vertex to the first is
    the kernel's, as ``jnp.roll(v, -1)`` adds it); a MULTIPOLYGON's
    rings are every part's, in order.  The tensors are built once per
    device."""

    def __init__(self, geoms: Sequence[Optional[Geometry]]):
        self.geoms = list(geoms)
        kind, bbox, ring_lo, vert_lo, verts = [], [], [0], [0], []
        for g in self.geoms:
            if g is None:
                kind.append(KIND_MISSING)
                bbox.append((math.inf, math.inf, -math.inf, -math.inf))
            else:
                kind.append(KIND_POINT if g.kind == "POINT" else KIND_POLYGON)
                bbox.append(g.bbox)
                for ring in g.rings:
                    verts.append(np.asarray(ring, dtype=np.float64).reshape(-1, 2))
                    vert_lo.append(vert_lo[-1] + verts[-1].shape[0])
            ring_lo.append(len(vert_lo) - 1)
        v = np.concatenate(verts, 0) if verts else np.zeros((0, 2), np.float64)
        self.host = {"kind": np.asarray(kind, np.int32),
                     "bbox": np.asarray(bbox, np.float64).reshape(-1, 4),
                     "ring_lo": np.asarray(ring_lo, np.int64),
                     "vert_lo": np.asarray(vert_lo, np.int64),
                     "vx": np.ascontiguousarray(v[:, 0]), "vy": np.ascontiguousarray(v[:, 1])}
        self._copies: Dict[str, Dict[str, torch.Tensor]] = {}

    def __len__(self) -> int:
        return len(self.geoms)

    @property
    def vertices(self) -> int:
        return int(self.host["vx"].shape[0])

    def edges(self) -> np.ndarray:
        """Each geometry's edge count (a POINT's and a missing one's 0)."""
        h = self.host
        per_ring = np.diff(h["vert_lo"])
        ring_cum = np.concatenate([[0], np.cumsum(per_ring)])
        e = ring_cum[h["ring_lo"][1:]] - ring_cum[h["ring_lo"][:-1]]
        return np.where(h["kind"] == KIND_POLYGON, e, 0)

    def on(self, device) -> Dict[str, torch.Tensor]:
        key = str(device)
        got = self._copies.get(key)
        if got is None:
            got = self._copies[key] = {k: torch.from_numpy(v).to(device)
                                       for k, v in self.host.items()}
        return got


# dictionary -> the table of its values' geometries, freed with the
# dictionary (and with it the table's device copies)
_DICT_TABLES: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


def dictionary_table(d) -> GeometryTable:
    """The geometry table of a WKT dictionary (a value that does not
    parse is missing), built once per dictionary."""
    hit = _DICT_TABLES.get(d)
    if hit is None:
        hit = _DICT_TABLES[d] = GeometryTable([parse_or_none(v) for v in d.values])
    return hit
