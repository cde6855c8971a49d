"""ST_* expressions: the compiler's geospatial half.

Counterpart of ``_compile_geo`` (``presto_tpu/expr/compile.py`` :1679),
``_geo_float_lut`` (:1750), ``_point_accessor`` (:1783) and
``_unwrap_geomtext`` (:3506).  Geometries are WKT strings riding
dictionary varchar columns (``presto_tpu_torch/geo.py`` parses each
distinct value once):

- ``st_geometryfromtext`` is transparent (a literal parses at compile
  time, so a bad WKT fails there);
- ``st_area``, ``st_x`` and ``st_y`` are a double per dictionary value
  on K1's DVLUT (a literal folds to a constant), lowered by
  :func:`emit_geo_value`;
- ``st_distance`` lowers to K1's double opcodes, ``sqrt((x1 - x2)^2 +
  (y1 - y2)^2)`` with each square a DMUL as jnp's ``** 2``
  (:func:`emit_distance`);
- ``st_contains`` of a WKT literal or a dictionary geometry column and a
  point (``ST_Point(x, y)`` or a dictionary POINT column) is a *bridge*:
  K18 ``geo_contains`` computes it, and it enters the enclosing K1
  program as one more boolean column of the page (as the raw half's
  bridges do, ``expr/rawstrings.py``).

A bare ``ST_Point`` and a geometry that is neither a literal nor a
dictionary column raise the reference's ValueError.
"""

from __future__ import annotations

from typing import List

from presto_tpu_torch import NotPorted
from presto_tpu_torch.expr.ir import Call, ColumnRef, Expr, LambdaExpr, LambdaVar, Literal
from presto_tpu_torch.page import Block, Page
from presto_tpu_torch.types import BOOLEAN, DOUBLE

GEO_FNS = ("st_geometryfromtext", "st_point", "st_distance", "st_contains", "st_area",
           "st_x", "st_y")


def unwrap_geomtext(e: Expr) -> Expr:
    """ST_GeometryFromText is representation-transparent: peel it."""
    while isinstance(e, Call) and e.fn == "st_geometryfromtext":
        e = e.args[0]
    return e


def involves_contains(e: Expr) -> bool:
    """Whether ``e`` holds an ``st_contains`` call (a K18 bridge)."""
    if isinstance(e, (LambdaExpr, LambdaVar)) or not isinstance(e, Call):
        return False
    return e.fn == "st_contains" or any(involves_contains(a) for a in e.args)


def _host_fn(fn: str):
    from presto_tpu_torch import geo

    host = {"st_area": geo.st_area, "st_x": geo.st_x, "st_y": geo.st_y}[fn]

    def safe(v):
        try:
            return host(v)
        except Exception:
            return None

    return safe


def _geo_dictionary(dictionaries, arg: Expr):
    """The dictionary of a geometry column (None for a raw varchar or a
    column without one)."""
    from presto_tpu_torch.expr.compile import expr_dictionary

    if not arg.type.is_string or arg.type.is_raw_string:
        return None
    return expr_dictionary(arg, dictionaries)


def emit_geo_value(lw, arg: Expr, fn: str) -> bool:
    """Push ``fn`` (st_area, st_x or st_y) of the geometry ``arg``: a
    literal's value as a constant (NULL where the function gives none),
    a dictionary column's through a double table over its values
    (DVLUT, NULL where a value gives none or does not parse)."""
    import torch

    from presto_tpu_torch.expr.compile import value_tables
    from presto_tpu_torch.kernels import expr_eval as k1

    arg = unwrap_geomtext(arg)
    if isinstance(arg, Literal):
        val = _host_fn(fn)(str(arg.value)) if arg.value is not None else None
        if val is None:
            lw._push(k1.NULL)
        else:
            lw._push(k1.DLIT, lw._const(k1.double_bits(float(val))))
        return True
    d = _geo_dictionary(lw.dictionaries, arg)
    if d is None:
        raise ValueError("geometry argument needs a WKT literal or dictionary varchar column")
    return lw._push_value_tables(arg, value_tables(d, ("geo_" + fn,), _host_fn(fn),
                                                   torch.float64), k1.DVLUT)


def emit_point_axis(lw, e: Expr, axis: int) -> bool:
    """Push the x (axis 0) or y (axis 1) of a point operand: an
    ``ST_Point(x, y)`` argument as a double (``_to_double``), or ST_X /
    ST_Y of a WKT literal or a dictionary POINT column."""
    e = unwrap_geomtext(e)
    if isinstance(e, Call) and e.fn == "st_point":
        return lw._emit_double(e.args[axis])
    return emit_geo_value(lw, e, ("st_x", "st_y")[axis])


def emit_distance(lw, e: Call) -> bool:
    """``st_distance(a, b)``: the reference's ``point_distance``,
    ``sqrt((x1 - x2) ** 2 + (y1 - y2) ** 2)``, each square one DMUL of
    the difference (computed twice), on K1's double opcodes."""
    from presto_tpu_torch.kernels import expr_eval as k1

    a, b = e.args
    const = True
    for axis in (0, 1):
        for _ in range(2):
            const &= emit_point_axis(lw, a, axis) & emit_point_axis(lw, b, axis)
            lw._push(k1.DSUB)
        lw._push(k1.DMUL)
    lw._push(k1.DADD)
    lw._push(k1.DUN, k1.DUN_FNS.index("sqrt"))
    return const


def emit_geo(lw, e: Call) -> bool:
    """The K1 lowering of an ST_* call other than st_contains."""
    fn = e.fn
    if fn == "st_geometryfromtext":
        from presto_tpu_torch import geo

        arg = e.args[0]
        if isinstance(arg, Literal) and arg.value is not None:
            geo.parse_wkt(str(arg.value))  # fail at compile, not per row
        return lw.emit(arg)
    if fn == "st_point":
        raise ValueError("ST_Point is only usable inside ST_Distance / ST_Contains")
    if fn in ("st_area", "st_x", "st_y"):
        return emit_geo_value(lw, e.args[0], fn)
    if fn == "st_distance":
        return emit_distance(lw, e)
    raise NotPorted(f"expression {fn} outside a filter or projection")


def _split(e: Expr, base: int, bridges: List[Call]) -> Expr:
    """``e`` with each st_contains call replaced by a boolean column
    ``base + k`` (k: its place in ``bridges``)."""
    if not isinstance(e, Call):
        return e
    if e.fn == "st_contains":
        bridges.append(e)
        return ColumnRef(type=BOOLEAN, index=base + len(bridges) - 1, name="$st_contains")
    return Call(type=e.type, fn=e.fn, args=tuple(_split(a, base, bridges) for a in e.args))


def _as_double(e: Expr) -> Expr:
    return e if e.type.name == "double" else Call(type=DOUBLE, fn="cast_double", args=(e,))


class GeoCompiler:
    """The geospatial half of :class:`ExprCompiler` over one input schema."""

    def __init__(self, compiler):
        self.c = compiler

    def contains(self, e: Call):
        """``page -> (hit, valid)`` of ``st_contains(geometry, point)`` by
        K18: valid where the point's coordinates are, and for a column
        where its geometry is and parsed."""
        from presto_tpu_torch import geo
        from presto_tpu_torch.kernels import geo_contains as k18

        garg = unwrap_geomtext(e.args[0])
        pt = unwrap_geomtext(e.args[1])
        if isinstance(pt, Call) and pt.fn == "st_point":
            xe, ye = _as_double(pt.args[0]), _as_double(pt.args[1])
        else:
            xe, ye = (Call(type=DOUBLE, fn=f, args=(pt,)) for f in ("st_x", "st_y"))
        xf, yf = self.c.compile(xe), self.c.compile(ye)
        if isinstance(garg, Literal):
            table = geo.GeometryTable([geo.parse_wkt(str(garg.value))])

            def run_lit(page):
                (x, vx), (y, vy) = xf(page), yf(page)
                hit, _ = k18.geo_contains(table, x, y)
                return hit, vx & vy

            return run_lit
        d = _geo_dictionary(self.c.dictionaries, garg)
        if d is None:
            raise ValueError("ST_Contains geometry must be a WKT literal or "
                             "dictionary varchar column")
        cf = self.c.compile(garg)
        table = geo.dictionary_table(d)

        def run_col(page):
            (code, vg), (x, vx), (y, vy) = cf(page), xf(page), yf(page)
            hit, ok = k18.geo_contains(table, x, y, code)
            return hit, vg & vx & vy & ok

        return run_col

    def with_bridges(self, exprs):
        """``(rewritten exprs, page -> page with the bridge columns,
        dictionaries)``."""
        c = self.c
        base = len(c.input_types)
        bridges: List[Call] = []
        rewritten = [_split(x, base, bridges) for x in exprs]
        fns = [self.contains(b) for b in bridges]

        def extend(page: Page) -> Page:
            extra = tuple(Block(*f(page), BOOLEAN) for f in fns)
            return Page(page.blocks + extra, page.row_mask)

        return rewritten, extend, c.dictionaries + [None] * len(bridges)

    def scalar(self, e: Expr):
        """``page -> (data, valid)`` of a scalar ``e``: its bridges, then
        one K1 program over the page and their columns."""
        from presto_tpu_torch.expr.compile import ExprCompiler, _Lowering, _out_kind

        (rewritten,), extend, dicts = self.with_bridges([e])
        if isinstance(rewritten, ColumnRef) and rewritten.index >= len(self.c.input_types):
            i = rewritten.index

            def run_bridge(page):
                b = extend(page).blocks[i]
                return b.data, b.valid

            return run_bridge
        lw = _Lowering(dicts)
        lw.emit(rewritten)
        run = ExprCompiler.run_program(lw.program(_out_kind(e.type)), list(lw.columns))
        return lambda page: run(extend(page))

    def filter(self, e: Expr):
        """``page -> row mask`` of a predicate over st_contains bridges."""
        from presto_tpu_torch.expr.compile import _Lowering, _out_kind
        from presto_tpu_torch.kernels import expr_eval as k1

        (rewritten,), extend, dicts = self.with_bridges([e])
        lw = _Lowering(dicts)
        lw.emit(rewritten)
        prog = lw.program(_out_kind(e.type))
        columns = list(lw.columns)

        def run(page):
            p = extend(page)
            cols = [(p.blocks[i].data, p.blocks[i].valid) for i in columns]
            return k1.expr_eval(prog, cols, page.capacity, row_mask=page.row_mask)

        return run
