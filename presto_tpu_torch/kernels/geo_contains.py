"""K18 ``geo_contains``: ST_Contains(geometry, point) per row.

:func:`geo_contains` gives, for each row's point ``(x, y)`` and its
geometry (one geometry for a WKT literal, else the row's code into a
:class:`~presto_tpu_torch.geo.GeometryTable` of a dictionary's values),
``hit = bbox_mask & points_in_geometry`` as the reference computes them
(``presto_tpu/geo.py`` :137 and :166) and ``ok``, false where the
geometry did not parse or the code lies outside the table (the
reference's ``run_contains_col`` leaves such rows NULL).  CUDA tensors
launch ``csrc/geo_contains.cu``; CPU tensors run
:func:`geo_contains_plain`, the reference's broadcast form over only
the rows carrying each geometry (and inside its bbox), which gives the
same bits.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from presto_tpu_torch.geo import GeometryTable
from presto_tpu_torch.kernels import build

# rows per broadcast block of the twin: (rows x ring vertices) temporaries
_PLAIN_BLOCK = 1 << 13

launches = 0
#: launches over a dictionary column's geometries (a row's own geometry)
column_launches = 0


def bbox_mask(bbox, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    x0, y0, x1, y1 = (float(v) for v in bbox)
    return (x >= x0) & (x <= x1) & (y >= y0) & (y <= y1)


def points_in_rings(rings, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """The reference's even-odd ray casting over ``rings`` (each an
    (nv, 2) float64 array as parsed): per ring the crossings of the
    horizontal ray right of each point, the rings' parities XORed."""
    inside = torch.zeros(x.shape[0], dtype=torch.bool, device=x.device)
    xs, ys = x[:, None], y[:, None]
    for ring in rings:
        v = torch.as_tensor(ring, dtype=torch.float64, device=x.device)
        vx, vy = v[:, 0][None, :], v[:, 1][None, :]
        vx2, vy2 = torch.roll(vx, -1, 1), torch.roll(vy, -1, 1)
        cond = (vy > ys) != (vy2 > ys)
        denom = vy2 - vy
        t = torch.where(cond, (ys - vy) / torch.where(denom == 0, torch.ones_like(denom), denom),
                        torch.zeros((), dtype=torch.float64, device=x.device))
        xint = vx + t * (vx2 - vx)
        crossings = (cond & (xint > xs)).sum(1)
        inside = inside ^ (crossings % 2 == 1)
    return inside


def geo_contains_plain(table: GeometryTable, x: torch.Tensor, y: torch.Tensor,
                       code: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """The twin: each geometry over the rows carrying it that fall in its
    bbox, in blocks of rows."""
    n, dev = x.shape[0], x.device
    hit = torch.zeros(n, dtype=torch.bool, device=dev)
    ok = torch.zeros(n, dtype=torch.bool, device=dev)
    if code is None:
        groups = [(0, torch.arange(n, device=dev))]
    else:
        c = code.to(torch.int64)
        order = torch.argsort(c, stable=True)
        sc = c[order]
        inside = (sc >= 0) & (sc < len(table))
        ids, counts = torch.unique_consecutive(sc[inside], return_counts=True)
        starts = torch.cumsum(counts, 0) - counts
        first = int(torch.nonzero(inside).flatten()[0]) if bool(inside.any()) else 0
        groups = [(int(g), order[first + int(s):first + int(s) + int(k)])
                  for g, s, k in zip(ids.tolist(), starts.tolist(), counts.tolist())]
    for gi, rows in groups:
        geom = table.geoms[gi]
        if geom is None:
            continue
        ok[rows] = True
        cand = rows[bbox_mask(geom.bbox, x[rows], y[rows])]
        if geom.kind == "POINT":
            px, py = geom.point
            hit[cand] = (x[cand] == px) & (y[cand] == py)
            continue
        for i in range(0, cand.shape[0], _PLAIN_BLOCK):
            blk = cand[i:i + _PLAIN_BLOCK]
            hit[blk] = points_in_rings(geom.rings, x[blk], y[blk])
    return hit, ok


def geo_contains(table: GeometryTable, x: torch.Tensor, y: torch.Tensor,
                 code: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(hit, ok)`` per row: the point ``(x[r], y[r])`` (float64) in the
    geometry ``code[r]`` of ``table`` (int32 or int64 codes), or in its
    only geometry when ``code`` is None.  CPU tensors take the plain
    version; CUDA tensors launch the kernel."""
    global launches, column_launches
    n = x.shape[0]
    if x.dtype != torch.float64 or y.dtype != torch.float64 or x.shape != (n,) \
            or y.shape != (n,):
        raise ValueError("geo_contains: x and y must be (n,) float64")
    if code is not None and (code.shape != (n,) or code.dtype not in (torch.int32,
                                                                      torch.int64)):
        raise ValueError("geo_contains: codes must be (n,) int32 or int64")
    if len(table) < 1:
        raise ValueError("geo_contains: an empty geometry table")
    if not x.is_cuda:
        return geo_contains_plain(table, x, y, code)
    build.require_cuda([x, y] + ([code] if code is not None else []), "geo_contains")
    t = table.on(x.device)
    hit = torch.empty(n, dtype=torch.bool, device=x.device)
    ok = torch.empty(n, dtype=torch.bool, device=x.device)
    smem = int(table.host["vert_lo"][table.host["ring_lo"][1]]) if code is None else 0
    fn = build.library().k18_geo_contains
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_int, ctypes.c_longlong] + [ctypes.c_void_p] * 6 + \
        [ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
    err = fn(n, x.data_ptr(), y.data_ptr(), code.data_ptr() if code is not None else None,
             1 if code is not None and code.dtype == torch.int32 else 2, len(table),
             t["kind"].data_ptr(), t["bbox"].data_ptr(), t["ring_lo"].data_ptr(),
             t["vert_lo"].data_ptr(), t["vx"].data_ptr(), t["vy"].data_ptr(), smem,
             hit.data_ptr(), ok.data_ptr(), build.stream_of(x))
    build.check(err, "geo_contains")
    launches += 1
    column_launches += int(code is not None)
    return hit, ok

