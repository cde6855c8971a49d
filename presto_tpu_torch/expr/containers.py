"""ARRAY, MAP and ROW expressions: the compiler's container half.

Counterpart of the container branches of ``presto_tpu/expr/compile.py``
(``_compile_container`` :1806, ROW construction, casts and field access
:934, ``_compile_split`` :1476 and the lambdas :2116-:2355).  Where the
reference builds one closure of jnp ops, the port splits an expression
that involves containers at its scalar boundary:

- a container-valued expression evaluates to a ``(matrix, valid)`` pair
  through K12 ``container_eval`` launches (one opcode per function),
  its scalar operands through K1;
- a scalar call over a container (cardinality, element_at, contains,
  array_sum, any_match, reduce, a ROW field, ...) is a *bridge*: K12
  computes it, and it enters the enclosing K1 program as one more
  loaded column of the page, so K1 gains no container lane;
- a lambda body runs as a K1 program over a page of the container's
  live elements, flattened by K13 ``unnest_expand`` (the outer columns
  the body captures gathered beside them); K12 assembles, compacts or
  tests the body's lanes back per row (``assemble``, ``compact``,
  ``compact_pairs``, ``transform_keys``, ``match``).  ``reduce`` runs its
  combiner once per slot over the whole page, as the reference does.

``split`` gathers rows of a host table over the column's dictionary
(every value's parts as codes into one parts dictionary, built once per
dictionary, delimiter and slot count, as the reference caches it).  The
setdigest functions (``jaccard_index``, ``intersection_cardinality``,
``hash_counts``) and the sketch types' cardinality raise
:class:`NotPorted`.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch

from presto_tpu_torch import NotPorted
from presto_tpu_torch.expr.ir import Call, ColumnRef, Expr, LambdaExpr, LambdaVar, Literal
from presto_tpu_torch.kernels import container_eval as k12
from presto_tpu_torch.kernels import unnest_expand as k13
from presto_tpu_torch.ops.container import is_container
from presto_tpu_torch.page import Block, Dictionary, Page, _torch_dtype
from presto_tpu_torch.types import BIGINT, BOOLEAN, ArrayType, Type, common_super_type

# the reference's _CONTAINER_FNS, and the ROW functions
CONTAINER_FNS = frozenset({
    "array_construct", "subscript", "element_at", "cardinality",
    "jaccard_index", "intersection_cardinality", "hash_counts",
    "contains", "array_position", "array_min", "array_max", "array_sum",
    "array_average", "array_sort", "array_distinct", "map_keys",
    "map_values", "map", "map_construct",
    "array_transform", "array_filter", "any_match", "all_match",
    "none_match", "sequence", "slice", "repeat", "array_concat",
    "array_intersect", "array_union", "array_except", "arrays_overlap",
    "array_remove", "map_concat",
    "map_filter", "transform_keys", "transform_values", "zip_with",
    "reduce", "split", "row_construct", "row_field", "retype_row",
})
# still with the reference: the setdigest family
DEFERRED_FNS = ("jaccard_index", "intersection_cardinality", "hash_counts")
_REDUCE = {"array_min": k12.R_MIN, "array_max": k12.R_MAX, "array_sum": k12.R_SUM,
           "array_average": k12.R_AVG}
_MATCH = {"any_match": k12.M_ANY, "none_match": k12.M_NONE, "all_match": k12.M_ALL}

def involves_containers(e: Expr) -> bool:
    """Whether ``e`` needs the container half: a container-typed node, a
    container function, or a lambda."""
    if isinstance(e, (LambdaExpr, LambdaVar)):
        return True
    if is_container(e.type):
        return True
    if isinstance(e, Call):
        return e.fn in CONTAINER_FNS or any(involves_containers(a) for a in e.args)
    return False


# ---------------------------------------------------------------------------
# dictionaries
# ---------------------------------------------------------------------------

# (id(inner dictionary), delimiter, slots) -> (inner, parts dictionary,
# numpy code table); the reference's ExprCompiler._SPLIT_CACHE
_SPLIT_CACHE: dict = {}
# the same tables on a device: key + (device,) -> tensor
_SPLIT_TABLES: dict = {}


def split_parts(d: Dictionary, delim: str, cap: int):
    """The parts dictionary of ``split(col, delim)`` over ``d`` and the
    ``(len(d), 1 + cap)`` table of each value's part codes (the
    reference's ``split_parts``: the slot count acts as split's limit,
    the last part keeping the unsplit remainder)."""
    import numpy as np

    key = (id(d), delim, cap)
    got = _SPLIT_CACHE.get(key)
    if got is not None:
        return got[1], got[2]
    parts_index: dict = {}
    values: list = []

    def code_of(p):
        c = parts_index.get(p)
        if c is None:
            c = parts_index[p] = len(values)
            values.append(p)
        return c

    lut = np.zeros((len(d.values), 1 + cap), dtype=np.int32)
    for i, v in enumerate(d.values):
        ps = v.split(delim, cap - 1)
        lut[i, 0] = len(ps)
        for j, p in enumerate(ps):
            lut[i, 1 + j] = code_of(p)
    pd = Dictionary(values or [""])
    _SPLIT_CACHE[key] = (d, pd, lut)
    return pd, lut


def container_dictionary(e: Expr, dictionaries) -> Optional[Dictionary]:
    """Dictionary provenance of a container or container-function
    expression (the reference's ``expr_dictionary`` rules): a column's
    own, ``split``'s parts dictionary, an all-literal string array's
    shared dictionary, an element of a string array its array's; None
    for any other."""
    from presto_tpu_torch.expr.compile import expr_dictionary, literal_array_dictionary

    if isinstance(e, ColumnRef):
        return dictionaries[e.index]
    if not isinstance(e, Call):
        return None
    if e.fn == "split":
        inner = expr_dictionary(e.args[0], dictionaries)
        delim = e.args[1]
        if inner is None or not isinstance(delim, Literal) or delim.value is None:
            return None
        return split_parts(inner, delim.value, e.type.max_elems)[0]
    if e.fn in ("subscript", "element_at") and e.args[0].type.is_array \
            and e.args[0].type.element is not None and e.args[0].type.element.is_string:
        return container_dictionary(e.args[0], dictionaries)
    if e.fn == "array_construct" and e.type.is_array and e.type.element is not None \
            and e.type.element.is_string and all(isinstance(a, Literal) for a in e.args):
        return literal_array_dictionary([a.value for a in e.args if a.value is not None])
    if e.fn == "try":
        return container_dictionary(e.args[0], dictionaries)
    return None


# ---------------------------------------------------------------------------
# the split at the scalar boundary
# ---------------------------------------------------------------------------

def _split_bridges(e: Expr, base: int, bridges: List[Call]) -> Expr:
    """``e`` with each scalar call over a container replaced by a column
    ``base + k`` (k: its place in ``bridges``)."""
    if isinstance(e, (ColumnRef, Literal)):
        return e
    if isinstance(e, LambdaVar):
        raise NotPorted("a lambda variable outside its lambda")
    if not isinstance(e, Call):
        raise NotPorted(f"expression node {type(e).__name__}")
    if is_container(e.type):
        raise NotPorted(f"expression {e.fn} producing {e.type} inside a scalar")
    if any(is_container(a.type) or isinstance(a, LambdaExpr) for a in e.args):
        bridges.append(e)
        return ColumnRef(type=e.type, index=base + len(bridges) - 1, name=f"${e.fn}")
    return Call(type=e.type, fn=e.fn, args=tuple(_split_bridges(a, base, bridges)
                                                 for a in e.args))


class ContainerCompiler:
    """The container half of :class:`ExprCompiler` over one input schema."""

    def __init__(self, compiler):
        self.c = compiler

    # -- scalars ---------------------------------------------------------------
    def scalar(self, e: Expr, to_t: Optional[Type] = None):
        """``page -> (data, valid)`` of a scalar ``e`` (in ``to_t`` when
        given, the reference's ``_coerce``): its bridges, then one K1
        program over the page and their columns."""
        from presto_tpu_torch.expr.compile import ExprCompiler, _Lowering, _out_kind

        c = self.c
        base = len(c.input_types)
        bridges: List[Call] = []
        rewritten = _split_bridges(e, base, bridges)
        fns = [self.bridge(b) for b in bridges]
        dicts = c.dictionaries + [self._bridge_dictionary(b) for b in bridges]
        if to_t is None and isinstance(rewritten, ColumnRef) and rewritten.index >= base:
            return fns[rewritten.index - base]
        lw = _Lowering(dicts)
        if to_t is None or to_t == e.type:
            lw.emit(rewritten)
        else:
            lw._emit_coerced(rewritten, to_t)
        run = ExprCompiler.run_program(lw.program(_out_kind(to_t or e.type)), list(lw.columns))
        if not bridges:
            return run
        types = [b.type for b in bridges]

        def go(page):
            extra = tuple(Block(*f(page), t, d) for f, t, d in zip(fns, types, dicts[base:]))
            return run(Page(page.blocks + extra, page.row_mask))

        return go

    def filter(self, e: Expr):
        """``page -> row mask`` of a predicate that involves containers:
        its bridges, then K1 with the row mask."""
        from presto_tpu_torch.expr.compile import _Lowering, _out_kind
        from presto_tpu_torch.kernels import expr_eval as k1

        c = self.c
        base = len(c.input_types)
        bridges: List[Call] = []
        rewritten = _split_bridges(e, base, bridges)
        fns = [self.bridge(b) for b in bridges]
        dicts = c.dictionaries + [self._bridge_dictionary(b) for b in bridges]
        lw = _Lowering(dicts)
        lw.emit(rewritten)
        prog = lw.program(_out_kind(e.type))
        columns = list(lw.columns)
        types = [b.type for b in bridges]

        def run(page):
            extra = tuple(Block(*f(page), t, d) for f, t, d in zip(fns, types, dicts[base:]))
            p = Page(page.blocks + extra, page.row_mask)
            cols = [(p.blocks[i].data, p.blocks[i].valid) for i in columns]
            if prog.n_cols == 0:
                keep = prog.ops[0] == k1.LIT and prog.consts[prog.args[0]] != 0
                return page.row_mask & keep
            return k1.expr_eval(prog, cols, page.capacity, row_mask=page.row_mask)

        return run

    def any(self, e: Expr):
        return self.container(e) if is_container(e.type) else self.scalar(e)

    def _bridge_dictionary(self, b: Call) -> Optional[Dictionary]:
        if not b.type.is_string:
            return None
        return container_dictionary(b, self.c.dictionaries)

    def _elem_dictionary(self, e: Expr) -> Optional[Dictionary]:
        return container_dictionary(e, self.c.dictionaries)

    # -- scalar calls over containers --------------------------------------------
    def bridge(self, e: Call):
        fn = e.fn
        out_dt = _torch_dtype(e.type)
        if fn in DEFERRED_FNS:
            raise NotPorted(f"expression {fn}")
        if fn in ("is_null", "not_null") and is_container(e.args[0].type):
            arr = self.container(e.args[0])
            isnull = fn == "is_null"

            def run_null(page):
                _, v = arr(page)
                return (~v if isnull else v.clone()), torch.ones_like(v)

            return run_null
        t0 = e.args[0].type
        if t0.name in ("hll", "setdigest"):
            raise NotPorted(f"expression {fn} of {t0}")
        if fn in _MATCH:
            return self._array_lambda(e)
        if fn == "reduce":
            return self._reduce(e)
        arr = self.container(e.args[0])
        if fn == "row_field":
            i = int(e.args[1].value)

            def run_field(page):
                d, v = arr(page)
                out, ov = k12.container_eval(k12.ROW_FIELD, d, v, p=[i - 1])
                return out.to(out_dt), ov

            return run_field
        if fn == "cardinality":
            return lambda page: k12.container_eval(k12.CARD, *arr(page))
        if fn in ("subscript", "element_at"):
            idx = self.any(e.args[1])
            is_map = t0.is_map
            m = t0.max_elems

            def run_sub(page):
                d, v = arr(page)
                x, xv = idx(page)
                if is_map:
                    out, ov = k12.container_eval(k12.MAP_GET, d, v, x=x, xv=xv,
                                                 p=[0, 0, 0, 0, 0, m])
                else:
                    out, ov = k12.container_eval(k12.SUBSCRIPT, d, v, x=x, xv=xv)
                return out.to(out_dt), ov

            return run_sub
        if fn in ("contains", "array_position"):
            xf = self.any(e.args[1])
            op = k12.CONTAINS if fn == "contains" else k12.POSITION
            return lambda page: self._with_lane(op, arr, xf, page)
        if fn in _REDUCE:
            mode = _REDUCE[fn]

            def run_red(page):
                out, ov = k12.container_eval(k12.REDUCE, *arr(page), p=[mode])
                return out.to(out_dt), ov

            return run_red
        if fn == "arrays_overlap":
            b_f = self.container(e.args[1])
            tb = e.args[1].type
            cmp_t = common_super_type(t0.element, tb.element)

            def run_overlap(page):
                (d, v), (bd, bv) = arr(page), b_f(page)
                dc = self._coerce(d, t0, ArrayType(cmp_t, t0.max_elems))
                bc = self._coerce(bd, tb, ArrayType(cmp_t, tb.max_elems))
                return k12.container_eval(k12.OVERLAP, d, v, b=bc, bv=bv, c=dc)

            return run_overlap
        raise NotPorted(f"expression {fn}")

    @staticmethod
    def _with_lane(op, arr, xf, page):
        d, v = arr(page)
        x, xv = xf(page)
        return k12.container_eval(op, d, v, x=x, xv=xv)

    # -- container-valued expressions -----------------------------------------
    def container(self, e: Expr):
        """``page -> (matrix, valid)`` of a container-valued ``e``."""
        t = e.type
        if isinstance(e, ColumnRef):
            i = e.index
            return lambda page: (page.blocks[i].data, page.blocks[i].valid)
        if isinstance(e, Literal):
            if e.value is not None:
                raise NotPorted(f"{t} literals")
            dt = _torch_dtype(t)

            def run_null(page):
                n = page.capacity
                return (torch.zeros((n,) + t.value_shape, dtype=dt, device=page.device),
                        torch.zeros(n, dtype=torch.bool, device=page.device))

            return run_null
        if not isinstance(e, Call):
            raise NotPorted(f"expression node {type(e).__name__}")
        fn = e.fn
        if fn in ("try", "retype_row"):
            return self.container(e.args[0])
        if fn in DEFERRED_FNS:
            raise NotPorted(f"expression {fn}")
        if fn == "row_construct":
            return self._construct(e, e.args, [f for f in t.fields], has_len=False)
        if fn == "array_construct":
            return self._array_construct(e)
        if fn in ("map", "map_construct"):
            return self._map_construct(e)
        if fn == "sequence":
            lo = int(e.args[0].value)
            step = int(e.args[2].value) if len(e.args) > 2 else 1
            m = t.max_elems

            def run_seq(page):
                return (k12.container_eval(k12.SEQUENCE, x=page.row_mask, out_m=m,
                                           out_dtype=torch.int64, p=[lo, step]),
                        torch.ones(page.capacity, dtype=torch.bool, device=page.device))

            return run_seq
        if fn == "repeat":
            val = self.any(e.args[0])
            count = int(e.args[1].value)
            m, dt = t.max_elems, _torch_dtype(t)

            def run_repeat(page):
                x, xv = val(page)
                return (k12.container_eval(k12.REPEAT, x=x, xv=xv, out_m=m, out_dtype=dt,
                                           p=[count]),
                        torch.ones(page.capacity, dtype=torch.bool, device=page.device))

            return run_repeat
        if fn == "split":
            return self._split(e)
        if fn in ("array_transform", "array_filter"):
            return self._array_lambda(e)
        if fn in ("map_filter", "transform_keys", "transform_values"):
            return self._map_lambda(e)
        if fn == "zip_with":
            return self._zip_with(e)
        arr = self.container(e.args[0])
        t0 = e.args[0].type
        if fn in ("array_sort", "array_distinct"):
            op = k12.SORT if fn == "array_sort" else k12.DISTINCT

            def run_sort(page):
                d, v = arr(page)
                return k12.container_eval(op, d), v

            return run_sort
        if fn in ("map_keys", "map_values"):
            half, m, dt = int(fn == "map_values"), t0.max_elems, _torch_dtype(t)

            def run_half(page):
                d, v = arr(page)
                return k12.container_eval(k12.MAP_HALF, d, out_dtype=dt,
                                          p=[half, 0, 0, 0, 0, m]), v

            return run_half
        if fn == "slice":
            start_e, len_e = e.args[1], e.args[2]
            if not (isinstance(start_e, Literal) and isinstance(len_e, Literal)):
                raise ValueError("slice() start/length must be literals")
            start, ln = int(start_e.value), int(len_e.value)

            def run_slice(page):
                d, v = arr(page)
                return k12.container_eval(k12.SLICE, d, p=[start, ln]), v

            return run_slice
        if fn in ("array_concat", "array_union"):
            b_f = self.container(e.args[1])
            tb = e.args[1].type

            def run_cat(page):
                (d, v), (bd, bv) = arr(page), b_f(page)
                out = k12.container_eval(k12.CONCAT, self._coerce(d, t0, t),
                                         b=self._coerce(bd, tb, t), out_m=t.max_elems)
                if fn == "array_union":
                    out = k12.container_eval(k12.DISTINCT, out)
                return out, v & bv

            return run_cat
        if fn in ("array_intersect", "array_except"):
            b_f = self.container(e.args[1])
            tb = e.args[1].type
            cmp_t = common_super_type(t0.element, tb.element)
            mode = k12.S_INTERSECT if fn == "array_intersect" else k12.S_EXCEPT

            def run_setop(page):
                (d, v), (bd, bv) = arr(page), b_f(page)
                dc = self._coerce(d, t0, ArrayType(cmp_t, t0.max_elems))
                bc = self._coerce(bd, tb, ArrayType(cmp_t, tb.max_elems))
                out = k12.container_eval(k12.SETOP, self._coerce(d, t0, t, plain=True), b=bc,
                                         c=dc, out_m=t.max_elems, p=[mode])
                return k12.container_eval(k12.DISTINCT, out), v & bv

            return run_setop
        if fn == "array_remove":
            xf = self.any(e.args[1])

            def run_remove(page):
                d, v = arr(page)
                x, xv = xf(page)
                out, ov = k12.container_eval(k12.REMOVE, d, v, x=x, xv=xv)
                return out, v & xv

            return run_remove
        if fn == "map_concat":
            b_f = self.container(e.args[1])
            tb = e.args[1].type

            def run_mconcat(page):
                (d, v), (bd, bv) = arr(page), b_f(page)
                a2, b2 = self._coerce(d, t0, t), self._coerce(bd, tb, t)
                return (k12.container_eval(k12.MAP_CONCAT, a2, b=b2, out_m=t.max_elems,
                                           p=[0, 0, 0, 0, tb.max_elems, t0.max_elems]),
                        v & bv)

            return run_mconcat
        raise NotPorted(f"expression {fn}")

    def _construct(self, e: Call, args, elem_types, has_len: bool):
        """ARRAY[...] / ROW(...): each element as a K1 lane in its slot's
        type, stacked (glue) and stored by K12's CONSTRUCT (NULL as the
        sentinel)."""
        t = e.type
        dt = _torch_dtype(t)
        lanes = [self.scalar(a, to_t=et) for a, et in zip(args, elem_types)]
        m = t.max_elems if has_len else len(args)

        def run(page):
            got = [f(page) for f in lanes]
            n = page.capacity
            if got:
                y = torch.stack([k12.lane_to(d.reshape(n), dt) for d, _ in got], 1)
                yv = torch.stack([v.reshape(n) for _, v in got], 1)
            else:
                y = torch.zeros((n, 0), dtype=dt, device=page.device)
                yv = torch.zeros((n, 0), dtype=torch.bool, device=page.device)
            out = k12.container_eval(k12.CONSTRUCT, y=y.contiguous(), yv=yv.contiguous(),
                                     out_m=m, p=[int(has_len)])
            valid = torch.ones(n, dtype=torch.bool, device=page.device) if has_len \
                else page.row_mask.clone()
            return out, valid

        return run

    def _array_construct(self, e: Call):
        from presto_tpu_torch.expr.compile import literal_array_dictionary

        elem_t = e.type.element
        if elem_t is not None and elem_t.is_string:
            if not all(isinstance(a, Literal) for a in e.args):
                raise NotPorted("ARRAY of non-literal strings")
            dic = literal_array_dictionary([a.value for a in e.args if a.value is not None])
            codes = [Literal(type=BIGINT, value=None if a.value is None else dic.code_of(a.value))
                     for a in e.args]
            return self._construct(e, codes, [BIGINT] * len(codes), has_len=True)
        return self._construct(e, e.args, [elem_t] * len(e.args), has_len=True)

    def _map_construct(self, e: Call):
        t = e.type
        kf, vf = self.container(e.args[0]), self.container(e.args[1])
        dt = _torch_dtype(t)

        def run(page):
            (kd, kv), (vd, vv) = kf(page), vf(page)
            kd = kd if kd.dtype == dt else self._cast_matrix(kd, dt)
            vd = vd if vd.dtype == dt else self._cast_matrix(vd, dt)
            return k12.container_eval(k12.CONSTRUCT_MAP, kd, b=vd, out_m=t.max_elems), kv & vv

        return run

    @staticmethod
    def _cast_matrix(d: torch.Tensor, dt: torch.dtype) -> torch.Tensor:
        """An array matrix in another storage (a plain cast, the
        reference's ``astype``)."""
        return k12.container_eval(k12.COERCE, d, out_dtype=dt,
                                  p=[k12.C_ASTYPE, 0, 0, 0, 0, d.shape[1] - 1])

    @staticmethod
    def _coerce(d: torch.Tensor, from_t: Type, to_t: Type, plain: bool = False) -> torch.Tensor:
        """``d`` (of ``from_t``) with its slots in ``to_t``'s element types
        and storage (the reference's ``coerce_slots``; ``plain``: a cast
        only); the matrix itself when nothing changes."""
        dt = _torch_dtype(to_t)
        is_map = from_t.is_map
        m = from_t.max_elems
        if plain:
            kc = vc = (k12.C_ASTYPE, 0)
        elif is_map:
            kc = conv_of(from_t.key_element, to_t.key_element)
            vc = conv_of(from_t.element, to_t.element)
        else:
            kc = conv_of(from_t.element, to_t.element)
            vc = (k12.C_CAST, 0)
        if d.dtype == dt and _identity(kc) and _identity(vc):
            return d
        return k12.container_eval(k12.COERCE, d, out_dtype=dt,
                                  p=[kc[0], kc[1], vc[0], vc[1], int(is_map), m])

    def _split(self, e: Call):
        from presto_tpu_torch.expr.compile import expr_dictionary

        col = e.args[0]
        d = expr_dictionary(col, self.c.dictionaries)
        if d is None:
            raise ValueError(f"no dictionary for string column {col}")
        delim = e.args[1]
        if not isinstance(delim, Literal) or delim.value is None:
            raise ValueError("split delimiter must be a literal")
        cap = e.type.max_elems
        key = (id(d), delim.value, cap)
        _, table_np = split_parts(d, delim.value, cap)
        codes = self.scalar(col)
        dt = _torch_dtype(e.type)

        def run(page):
            tk = key + (str(page.device),)
            table = _SPLIT_TABLES.get(tk)
            if table is None:
                table = _SPLIT_TABLES[tk] = (d, torch.from_numpy(table_np).to(dt).to(page.device))
            x, xv = codes(page)
            return k12.container_eval(k12.TABLE, table[1], x=x, xv=xv)

        return run

    # -- lambdas ------------------------------------------------------------------
    def _flatten(self, page: Page, args, refs: List[int]):
        """K13 over the page's live rows: the captured columns ``refs``
        and each container argument's element lanes, the offsets."""
        outer = [(page.blocks[i].data, page.blocks[i].valid) for i in refs]
        outer_out, elems, _, total, off = k13.unnest_expand(page.row_mask, args, outer)
        blocks = [Block(d, v, page.blocks[i].type, page.blocks[i].dictionary)
                  for (d, v), i in zip(outer_out, refs)]
        mask = torch.ones(max(total, 1), dtype=torch.bool, device=page.device)
        if total == 0:
            mask[0] = False
        return blocks, elems, mask, off

    def _body(self, page: Page, body: Expr, refs: List[int], var_blocks, slots, blocks, mask):
        """The lambda body's K1 lanes over the flattened page: captured
        column ``refs[k]`` is column k, the lambda's variables follow."""
        from presto_tpu_torch.expr.compile import ExprCompiler

        mapping = {i: k for k, i in enumerate(refs)}
        var_at = {s: len(refs) + k for k, s in enumerate(slots)}
        body2 = _rebind(body, mapping, var_at)
        epage = Page(tuple(blocks) + tuple(var_blocks), mask)
        return ExprCompiler.for_page(epage).compile(body2)(epage)

    def _array_lambda(self, e: Call):
        fn = e.fn
        arr = self.container(e.args[0])
        t0 = e.args[0].type
        lam = e.args[1]
        m, elem_t = t0.max_elems, t0.element
        edict = self._elem_dictionary(e.args[0]) if elem_t.is_string else None
        refs = _column_refs(lam.body)
        out_t = e.type
        edt = _torch_dtype(elem_t)

        def run(page):
            d, v = arr(page)
            blocks, elems, mask, off = self._flatten(page, [(d, v, m, [(1, edt)])], refs)
            (ed, ev), = elems
            bd, bv = self._body(page, lam.body, refs, [Block(ed, ev, elem_t, edict)],
                                [lam.params[0].slot], blocks, mask)
            if fn == "array_transform":
                dt = _torch_dtype(out_t)
                return k12.container_eval(k12.ASSEMBLE, y=k12.lane_to(bd, dt), yv=bv, off=off,
                                          out_m=m), v
            if fn == "array_filter":
                return k12.container_eval(k12.COMPACT, d, y=bd.to(torch.bool), yv=bv, off=off,
                                          out_m=m), v
            return k12.container_eval(k12.MATCH, av=v, y=bd.to(torch.bool), yv=bv, off=off,
                                      p=[_MATCH[fn], m])

        return run

    def _map_lambda(self, e: Call):
        fn = e.fn
        mp = self.container(e.args[0])
        t0 = e.args[0].type
        lam = e.args[1]
        m, kt, vt = t0.max_elems, t0.key_element, t0.element
        refs = _column_refs(lam.body)
        out_t = e.type
        slots = [lam.params[0].slot, lam.params[1].slot]

        def run(page):
            d, v = mp(page)
            args = [(d, v, m, [(1, _torch_dtype(kt)), (1 + m, _torch_dtype(vt))])]
            blocks, elems, mask, off = self._flatten(page, args, refs)
            (kd, kv), (vd, vv) = elems
            bd, bv = self._body(page, lam.body, refs, [Block(kd, kv, kt), Block(vd, vv, vt)],
                                slots, blocks, mask)
            if fn == "map_filter":
                return k12.container_eval(k12.COMPACT_PAIRS, d, y=bd.to(torch.bool), yv=bv,
                                          off=off, out_m=m, p=[0, 0, 0, 0, 0, m]), v
            dt = _torch_dtype(out_t)
            if fn == "transform_values":
                return k12.container_eval(k12.ASSEMBLE, d, y=k12.lane_to(bd, dt), yv=bv,
                                          off=off, out_m=m,
                                          p=[1, k12._KIND[d.dtype]]), v
            d2 = d if d.dtype == dt else self._coerce(d, t0, out_t, plain=True)
            return k12.container_eval(k12.TKEYS, d2, y=k12.lane_to(bd, dt), yv=bv, off=off,
                                      out_m=m, p=[0, 0, 0, 0, 0, m]), v

        return run

    def _zip_with(self, e: Call):
        a1, a2 = self.container(e.args[0]), self.container(e.args[1])
        t1, t2 = e.args[0].type, e.args[1].type
        lam = e.args[2]
        out_t = e.type
        m = out_t.max_elems
        refs = _column_refs(lam.body)
        slots = [lam.params[0].slot, lam.params[1].slot]
        e1, e2 = t1.element, t2.element

        def run(page):
            (d1, v1), (d2, v2) = a1(page), a2(page)
            args = [(d1, v1, t1.max_elems, [(1, _torch_dtype(e1))]),
                    (d2, v2, t2.max_elems, [(1, _torch_dtype(e2))])]
            blocks, elems, mask, off = self._flatten(page, args, refs)
            (xd, xv), (yd, yv) = elems
            bd, bv = self._body(page, lam.body, refs, [Block(xd, xv, e1), Block(yd, yv, e2)],
                                slots, blocks, mask)
            dt = _torch_dtype(out_t)
            return k12.container_eval(k12.ASSEMBLE, y=k12.lane_to(bd, dt), yv=bv, off=off,
                                      out_m=m), v1 & v2

        return run

    def _reduce(self, e: Call):
        """reduce(arr, init, (s, x) -> comb, s -> out): the combiner once per
        slot over the whole page, where the slot is live (K12's SLOT gives
        the element and whether it is live; K1 computes ``if(live, comb,
        s)``), then the output lambda."""
        from presto_tpu_torch.expr.compile import ExprCompiler, _lane

        arr = self.container(e.args[0])
        init = self.any(e.args[1])
        t0, st = e.args[0].type, e.args[1].type
        comb_lam, out_lam = e.args[2], e.args[3]
        body_t = comb_lam.body.type
        # the state's type across the loop: the init's, or the combiner's
        # where a wider integer lane carries it (cast back at the end, as
        # the reference's astype)
        loop_t = st
        if body_t != st and not (st.name == "bigint" and _lane(body_t) == "short"
                                 and not body_t.is_decimal):
            if _lane(st) == "short" and _lane(body_t) == "short" and not st.is_decimal \
                    and not body_t.is_decimal:
                loop_t = body_t
            elif not (_lane(st) == "double" and _lane(body_t) != "long"):
                raise NotPorted(f"reduce with a {body_t} combiner over a {st} state")
        m, elem_t = t0.max_elems, t0.element
        out_t = e.type
        c = self.c
        nb = len(c.input_types)
        s_slot, x_slot = comb_lam.params[0].slot, comb_lam.params[1].slot
        has = ColumnRef(type=BOOLEAN, index=nb + 2, name="$live")
        state = ColumnRef(type=loop_t, index=nb, name="$s")
        step_e = Call(type=loop_t, fn="if", args=(
            has, _rebind(comb_lam.body, None, {s_slot: nb, x_slot: nb + 1}, loop_t), state))
        edict = self._elem_dictionary(e.args[0]) if elem_t.is_string else None
        step = ExprCompiler(c.input_types + [loop_t, elem_t, BOOLEAN],
                            c.dictionaries + [None, edict, None]).compile(step_e)
        out_e = _rebind(out_lam.body, None, {out_lam.params[0].slot: nb}, loop_t)
        final = ExprCompiler(c.input_types + [loop_t], c.dictionaries + [None]).compile(out_e)
        loop_dt, edt, out_dt = _torch_dtype(loop_t), _torch_dtype(elem_t), _torch_dtype(out_t)
        conv = ContainerCompiler(ExprCompiler(c.input_types + [st], c.dictionaries + [None])
                                 ).scalar(ColumnRef(type=st, index=nb), to_t=loop_t)

        def run(page):
            d, v = arr(page)
            sd, sv = init(page)
            n = page.capacity
            sd, sv = conv(Page(page.blocks + (Block(sd.expand(n).contiguous(),
                                                    sv.expand(n).contiguous(), st),),
                               page.row_mask))
            for i in range(m):
                ed, ev, live = k12.container_eval(k12.SLOT, d, p=[i])
                ones = torch.ones_like(live)
                sd, sv = step(Page(page.blocks + (Block(sd.to(loop_dt), sv, loop_t),
                                                  Block(ed.to(edt), ev, elem_t, edict),
                                                  Block(live, ones, BOOLEAN)), page.row_mask))
            od, ov = final(Page(page.blocks + (Block(sd.to(loop_dt), sv, loop_t),),
                                page.row_mask))
            return od.to(out_dt), v & ov

        return run


def conv_of(from_t: Type, to_t: Type) -> Tuple[int, int]:
    """COERCE's conversion of one element type into another (the
    reference's ``coerce_slots``) and its factor parameter."""
    if from_t.is_decimal or to_t.is_decimal:
        fs = from_t.scale or 0
        ts = to_t.scale or 0 if to_t.is_decimal else 0
        if to_t.name == "double":
            return k12.C_DEC2DBL, k12.double_bits(10.0 ** fs)
        if to_t.is_decimal:
            if from_t.name == "double":
                return k12.C_DBL2DEC, k12.double_bits(10.0 ** ts)
            if ts >= fs:
                return k12.C_UP, 10 ** (ts - fs)
            return k12.C_DOWN, 10 ** (fs - ts)
    return k12.C_CAST, 0


def _identity(conv: Tuple[int, int]) -> bool:
    return conv[0] in (k12.C_CAST, k12.C_ASTYPE) or (conv[0] == k12.C_UP and conv[1] == 1)


def _column_refs(e: Expr) -> List[int]:
    """The page columns an expression (lambda bodies included) reads."""
    out: set = set()

    def walk(x):
        if isinstance(x, ColumnRef):
            out.add(x.index)
        elif isinstance(x, Call):
            for a in x.args:
                walk(a)
        elif isinstance(x, LambdaExpr):
            walk(x.body)

    walk(e)
    return sorted(out)


def _rebind(e: Expr, mapping: Optional[Dict[int, int]], var_at: Dict[int, int],
            var_type: Optional[Type] = None) -> Expr:
    """``e`` with page columns renumbered by ``mapping`` (None: kept) and
    this lambda's variables (slots in ``var_at``) as columns; an inner
    lambda's own variables stay for its own compile.  The first variable
    takes ``var_type`` when given (reduce's state lane)."""
    if isinstance(e, ColumnRef):
        return e if mapping is None else ColumnRef(type=e.type, index=mapping[e.index],
                                                   name=e.name)
    if isinstance(e, LambdaVar):
        if e.slot not in var_at:
            return e
        t = var_type if var_type is not None and var_at[e.slot] == min(var_at.values()) \
            else e.type
        return ColumnRef(type=t, index=var_at[e.slot], name=f"λ{e.slot}")
    if isinstance(e, LambdaExpr):
        return LambdaExpr(type=e.type, params=e.params,
                          body=_rebind(e.body, mapping, var_at, var_type))
    if isinstance(e, Call):
        return Call(type=e.type, fn=e.fn, args=tuple(_rebind(a, mapping, var_at, var_type)
                                                     for a in e.args))
    return e
