"""Raw (non-dictionary) VARCHAR expressions: the compiler's raw half.

Counterpart of the raw branches of ``presto_tpu/expr/compile.py``
(``_compile_raw_cmp`` :2763, ``_compile_raw_transform`` :2799,
``_compile_raw_bool`` :2842, ``_compile_raw_int_fn`` :2870,
``_compile_raw_concat`` :2903, IN over raw :2956, ``nullif`` over raw
:1253, a raw literal in a raw-result context :2462, ``greatest`` /
``least`` over raw :2548, CASE and coalesce with raw branches, and
``approx_distinct`` over raw :1594).  Like the container half
(``expr/containers.py``), the port splits an expression at its scalar
boundary:

- a raw-valued expression evaluates to a ``((n, W) uint8, valid)``
  pair through K17 ``raw_string_eval`` launches (substr, upper, lower,
  concat, and the row selects of CASE, coalesce, nullif, greatest and
  least), its scalar operands through K1;
- a scalar call over a raw value (a comparison, IN, LIKE, starts_with,
  ends_with, length, strpos, codepoint, IS NULL, and the byte hash that
  ``hll_bucket`` / ``hll_rho`` and the key and checksum lanes read) is
  a *bridge*: K17 computes it, and it enters the enclosing K1 program
  as one more loaded column of the page.

LIKE, length, strpos and codepoint run in K17 on the card, where the
reference runs them on the host.  ``regexp_like`` and the transforms
other than substr, upper, lower and concat keep the reference's host
path: the rows decode, the Python function runs on each, and the
results encode back (``host_runs`` counts its calls; each logs its
time).  The reference's refusals stay: a raw string against a
dictionary string, a concat that mixes them, and the functions it does
not run over raw values raise ValueError.
"""

from __future__ import annotations

import logging
import re
import time
from typing import List, Optional

import torch

from presto_tpu_torch import NotPorted
from presto_tpu_torch.expr.host_fns import STRING_TRANSFORM_FNS, _string_transform
from presto_tpu_torch.expr.ir import Call, ColumnRef, Expr, LambdaExpr, LambdaVar, Literal
from presto_tpu_torch.ops import rawstring as rs
from presto_tpu_torch.page import Block, Page
from presto_tpu_torch.types import BIGINT, Type

log = logging.getLogger(__name__)

#: calls of the host path (regexp_like, the host transforms)
host_runs = 0

# the internal call of a raw value's FNV-1a hash lane (bigint)
HASH_FN = "$hash_bytes"
_CMP = ("eq", "ne", "lt", "le", "gt", "ge")
_SWAPPED = {"lt": "gt", "le": "ge", "gt": "lt", "ge": "le"}
_LUT_FNS = ("json_array_length", "url_extract_port", "from_base", "date_parse",
            "from_iso8601_date", "levenshtein_distance", "hamming_distance", "json_size")


def involves_raw(e: Expr) -> bool:
    """Whether ``e`` has a raw-string-typed node (a string literal is
    dictionary-typed until it meets a raw column)."""
    if isinstance(e, (LambdaExpr, LambdaVar)):
        return False
    if e.type is not None and e.type.is_raw_string:
        return True
    return isinstance(e, Call) and any(involves_raw(a) for a in e.args)


def hash_call(e: Expr) -> Call:
    """The bigint FNV-1a hash lane of the raw value ``e``."""
    return Call(type=BIGINT, fn=HASH_FN, args=(e,))


def _split(e: Expr, base: int, bridges: List[Call]) -> Expr:
    """``e`` with each scalar call over a raw value replaced by a column
    ``base + k`` (k: its place in ``bridges``); ``hll_bucket`` /
    ``hll_rho`` of a raw value read its hash lane."""
    if isinstance(e, (ColumnRef, Literal)):
        if e.type.is_raw_string:
            raise NotPorted("a raw varchar value inside a scalar expression")
        return e
    if not isinstance(e, Call):
        raise NotPorted(f"expression node {type(e).__name__}")
    if e.type.is_raw_string:
        raise NotPorted(f"raw varchar {e.fn} inside a scalar expression")
    if e.fn in ("hll_bucket", "hll_rho") and e.args[0].type.is_raw_string:
        bridges.append(hash_call(e.args[0]))
        lane = ColumnRef(type=BIGINT, index=base + len(bridges) - 1, name=HASH_FN)
        return Call(type=e.type, fn=e.fn, args=(lane,) + tuple(e.args[1:]))
    if any(a.type.is_raw_string for a in e.args):
        bridges.append(e)
        return ColumnRef(type=e.type, index=base + len(bridges) - 1, name=f"${e.fn}")
    return Call(type=e.type, fn=e.fn, args=tuple(_split(a, base, bridges) for a in e.args))


def _on_host(x, f, what: str, width: Optional[int] = None):
    """The reference's host path: each row of ``x``'s value decoded, the
    Python function ``f`` applied, and the results (booleans; or strings
    encoded at ``width`` bytes, a None result NULL) moved back to the
    page's device."""
    def run_host(page):
        global host_runs
        d, v = x(page)
        t0 = time.perf_counter()
        vals = [f(s) for s in rs.decode_strings(d.cpu().numpy())]
        if width is None:
            out = torch.tensor(vals, dtype=torch.bool).to(d.device)
        else:
            out = torch.from_numpy(rs.encode_strings(["" if y is None else y for y in vals],
                                                     width)).to(d.device)
            v = v & ~torch.tensor([y is None for y in vals], dtype=torch.bool).to(d.device)
        host_runs += 1
        log.info("raw varchar %s on the host: %d rows in %.3f ms", what, len(vals),
                 (time.perf_counter() - t0) * 1e3)
        return out, v

    return run_host


def _literal_value(e: Expr, what: str):
    if not isinstance(e, Literal) or e.value is None:
        raise NotPorted(f"{what} with a non-literal argument")
    return e.value


class RawCompiler:
    """The raw half of :class:`ExprCompiler` over one input schema."""

    def __init__(self, compiler):
        self.c = compiler

    def any(self, e: Expr):
        return self.value(e) if e.type.is_raw_string else self.scalar(e)

    # -- scalars ---------------------------------------------------------------
    def with_bridges(self, exprs):
        """``(rewritten exprs, page -> page with the bridge columns,
        dictionaries)``."""
        c = self.c
        base = len(c.input_types)
        bridges: List[Call] = []
        rewritten = [_split(e, base, bridges) for e in exprs]
        fns = [self.bridge(b) for b in bridges]
        types = [b.type for b in bridges]
        dicts = c.dictionaries + [None] * len(bridges)

        def extend(page: Page) -> Page:
            extra = tuple(Block(*f(page), t) for f, t in zip(fns, types))
            return Page(page.blocks + extra, page.row_mask)

        return rewritten, extend, dicts

    def scalar(self, e: Expr, to_t: Optional[Type] = None):
        """``page -> (data, valid)`` of a scalar ``e`` (in ``to_t`` when
        given): its bridges, then one K1 program over the page and their
        columns."""
        from presto_tpu_torch.expr.compile import ExprCompiler, _Lowering, _out_kind

        (rewritten,), extend, dicts = self.with_bridges([e])
        base = len(self.c.input_types)
        if to_t is None and isinstance(rewritten, ColumnRef) and rewritten.index >= base:
            i = rewritten.index

            def run_bridge(page):
                b = extend(page).blocks[i]
                return b.data, b.valid

            return run_bridge
        lw = _Lowering(dicts)
        if to_t is None or to_t == e.type:
            lw.emit(rewritten)
        else:
            lw._emit_coerced(rewritten, to_t)
        run = ExprCompiler.run_program(lw.program(_out_kind(to_t or e.type)), list(lw.columns))
        return lambda page: run(extend(page))

    def filter(self, e: Expr):
        """``page -> row mask`` of a predicate over raw values."""
        from presto_tpu_torch.expr.compile import _Lowering, _out_kind
        from presto_tpu_torch.kernels import expr_eval as k1

        (rewritten,), extend, dicts = self.with_bridges([e])
        lw = _Lowering(dicts)
        lw.emit(rewritten)
        prog = lw.program(_out_kind(e.type))
        columns = list(lw.columns)

        def run(page):
            p = extend(page)
            if prog.n_cols == 0:
                keep = prog.ops[0] == k1.LIT and prog.consts[prog.args[0]] != 0
                return page.row_mask & keep
            cols = [(p.blocks[i].data, p.blocks[i].valid) for i in columns]
            return k1.expr_eval(prog, cols, page.capacity, row_mask=page.row_mask)

        return run

    # -- scalar calls over raw values -------------------------------------------
    def bridge(self, e: Call):
        fn = e.fn
        if fn == HASH_FN:
            x = self.value(e.args[0])

            def run_hash(page):
                d, v = x(page)
                return rs.hash_bytes(d), v

            return run_hash
        if fn in ("is_null", "not_null"):
            x = self.value(e.args[0])
            isnull = fn == "is_null"

            def run_null(page):
                _, v = x(page)
                return (~v if isnull else v.clone()), torch.ones_like(v)

            return run_null
        if fn in _CMP:
            return self._cmp(e)
        if fn == "in":
            return self._in(e)
        if fn in ("like", "regexp_like", "starts_with", "ends_with"):
            return self._bool(e)
        if fn in ("length", "strpos", "codepoint"):
            return self._int_fn(e)
        if fn in ("cast_double", "cast_bigint"):
            raise ValueError(f"{fn} is unsupported over raw varchar columns "
                             "(dictionary varchar parses via a value LUT)")
        if fn in _LUT_FNS:
            raise ValueError(f"{fn} is unsupported over raw varchar columns "
                             "(dictionary varchar runs it as a value LUT)")
        if fn.startswith("st_"):  # a geometry is a WKT literal or a dictionary's value
            raise ValueError("geometry argument needs a WKT literal or dictionary varchar "
                             "column")
        raise NotPorted(f"{fn} over raw varchar")

    def _cmp(self, e: Call):
        lhs, rhs = e.args
        op = e.fn
        if isinstance(rhs, Literal) or isinstance(lhs, Literal):
            col, lit = (lhs, rhs) if isinstance(rhs, Literal) else (rhs, lhs)
            if col is rhs:
                op = _SWAPPED.get(op, op)
            if lit.value is None:
                raise NotPorted("comparison of a raw varchar with NULL")
            x = self.value(col)
            width = col.type.value_shape[0]
            text = str(lit.value)
            rows = {}

            def run_lit(page):
                d, v = x(page)
                key = d.device
                if key not in rows:
                    rows[key] = rs.encode_literal(text, max(width, len(text.encode())), d.device)
                return rs.compare_op(d, rows[key], op), v

            return run_lit
        if not (lhs.type.is_raw_string and rhs.type.is_raw_string):
            raise ValueError("raw-vs-dictionary string comparison unsupported")
        a, b = self.value(lhs), self.value(rhs)

        def run_cols(page):
            (da, va), (db, vb) = a(page), b(page)
            return rs.compare_op(da, db, op), va & vb

        return run_cols

    def _in(self, e: Call):
        col = e.args[0]
        values = [_literal_value(v, "IN over raw strings") for v in e.args[1:]]
        x = self.value(col)
        width = col.type.value_shape[0]
        rows = {}

        def run_in(page):
            d, v = x(page)
            if d.device not in rows:
                rows[d.device] = rs.literal_rows([str(s) for s in values], width, d.device)
            return rs.isin(d, rows[d.device]), v

        return run_in

    def _bool(self, e: Call):
        fn = e.fn
        x = self.value(e.args[0])
        arg = _literal_value(e.args[1], fn)
        if fn == "regexp_like":
            rx = re.compile(arg)
            return _on_host(x, lambda s: rx.search(s) is not None, fn)
        run_k17 = {"like": rs.like, "starts_with": rs.starts_with,
                   "ends_with": rs.ends_with}[fn]

        def run_b(page):
            d, v = x(page)
            return run_k17(d, arg), v

        return run_b

    def _int_fn(self, e: Call):
        fn = e.fn
        x = self.value(e.args[0])
        if fn == "strpos":
            needle = str(_literal_value(e.args[1], "strpos"))

            def run_strpos(page):
                d, v = x(page)
                return rs.strpos(d, needle), v

            return run_strpos
        run_k17 = rs.char_lengths if fn == "length" else rs.codepoint

        def run_i(page):
            d, v = x(page)
            return run_k17(d), v

        return run_i

    # -- raw values ----------------------------------------------------------------
    def value(self, e: Expr):
        """``page -> ((n, W) uint8, valid)`` of a raw-valued ``e``."""
        if isinstance(e, ColumnRef):
            i = e.index
            return lambda page: (page.blocks[i].data, page.blocks[i].valid)
        if not isinstance(e, Call):
            raise NotPorted(f"raw varchar {type(e).__name__}")
        fn = e.fn
        if fn in ("try", "cast_char", "cast_varchar") and len(e.args) == 1 \
                and e.args[0].type.is_raw_string:
            return self.value(e.args[0])
        if fn == "concat":
            return self._concat(e)
        if fn in ("case", "if"):
            return self._case(e)
        if fn == "coalesce":
            return self._coalesce(e)
        if fn == "nullif":
            return self._nullif(e)
        if fn in ("greatest", "least"):
            return self._greatest_least(e)
        if fn in STRING_TRANSFORM_FNS:
            return self._transform(e)
        raise NotPorted(f"raw varchar {fn}")

    def _operand(self, e: Expr, width: int):
        """An argument in a raw-result context: a string literal as one
        row of ``width`` bytes (NULL: invalid), else its value."""
        if isinstance(e, Literal):
            null = e.value is None
            text = "" if null else str(e.value)
            rows = {}

            def run_lit(page):
                dev = page.device
                if dev not in rows:
                    rows[dev] = rs.encode_literal(text, width, dev)
                return rows[dev], torch.full((page.capacity,), not null, dtype=torch.bool,
                                             device=dev)

            return run_lit
        if not e.type.is_raw_string:
            raise ValueError(f"a raw varchar result over {e.type}")
        return self.value(e)

    @staticmethod
    def _full(d: torch.Tensor, n: int) -> torch.Tensor:
        return d.expand(n, -1).contiguous() if d.shape[0] != n else d

    def _transform(self, e: Call):
        cols = [a for a in e.args if not isinstance(a, Literal)]
        if len(cols) != 1:
            raise KeyError(f"cannot compile string transform {e}")
        x = self.value(cols[0])
        if e.fn == "substr":
            start = int(_literal_value(e.args[1], "substr"))
            length = int(_literal_value(e.args[2], "substr")) if len(e.args) > 2 else None

            def run_substr(page):
                d, v = x(page)
                return rs.substr_chars(d, start, length), v

            return run_substr
        if e.fn in ("upper", "lower"):
            up = e.fn == "upper"

            def run_case_map(page):
                d, v = x(page)
                return rs.change_case(d, up), v

            return run_case_map
        tf = _string_transform(e)
        if tf is None:
            raise KeyError(f"cannot compile string transform {e}")
        return _on_host(x, tf[0], e.fn, width=e.type.value_shape[0])

    def _concat(self, e: Call):
        parts = []
        for a in e.args:
            if isinstance(a, Literal):
                text = str(a.value)
                parts.append(self._operand(a, len(text.encode()) or 1))
            elif a.type.is_raw_string:
                parts.append(self.value(a))
            else:
                raise ValueError("concat mixes raw and dictionary strings")

        def run_concat(page):
            n = page.capacity
            data, valid = parts[0](page)
            data = self._full(data, n)
            for p in parts[1:]:
                d, v = p(page)
                data = rs.concat(data, d)
                valid = valid & v
            return data, valid

        return run_concat

    @staticmethod
    def _width(t: Type, branches) -> int:
        """The byte width of a select's output: the widest raw branch,
        at least the type's."""
        return max([a.type.value_shape[0] for a in branches if a.type.is_raw_string]
                   + [t.value_shape[0]])

    def _case(self, e: Call):
        args = e.args
        if e.fn == "if":
            args = (args[0], args[1], args[2] if len(args) > 2 else
                    Literal(type=e.type, value=None))
        width = self._width(e.type, args[1::2] + args[-1:])
        pairs = [(self.c.compile(args[i]), self._operand(args[i + 1], width))
                 for i in range(0, len(args) - 1, 2)]
        else_f = self._operand(args[-1], width)

        def run_case(page):
            n = page.capacity
            data, valid = else_f(page)
            taken = torch.zeros(n, dtype=torch.bool, device=page.device)
            for wf, tf in pairs:
                wd, wv = wf(page)
                td, tv = tf(page)
                cond = wd & wv & ~taken
                data = rs.select(cond, td, data, width)
                valid = torch.where(cond, tv, valid)
                taken = taken | (wd & wv)
            return self._full(data, n), valid

        return run_case

    def _coalesce(self, e: Call):
        width = self._width(e.type, e.args)
        parts = [self._operand(a, width) for a in e.args]

        def run_coalesce(page):
            data, valid = parts[0](page)
            for p in parts[1:]:
                d, v = p(page)
                take = ~valid & v
                data = rs.select(take, d, data, width)
                valid = valid | v
            return self._full(data, page.capacity), valid

        return run_coalesce

    def _nullif(self, e: Call):
        a_e, b_e = e.args
        if not a_e.type.is_raw_string:
            raise NotPorted(f"nullif of {a_e.type} and {b_e.type}")
        a = self.value(a_e)
        b = self._operand(b_e, a_e.type.value_shape[0])

        def run_nullif(page):
            (da, va), (db, vb) = a(page), b(page)
            _, eq = rs.compare(da, db)
            return da, va & ~(va & vb & eq)

        return run_nullif

    def _greatest_least(self, e: Call):
        width = self._width(e.type, e.args)
        parts = [self._operand(a, width) for a in e.args]
        take_max = e.fn == "greatest"

        def run_gl(page):
            data, valid = parts[0](page)
            data = self._full(data, page.capacity)
            for p in parts[1:]:
                d, v = p(page)
                sign = rs.compare_op(data, d, "sign")  # data against d
                take_d = sign < 0 if take_max else sign > 0
                data = rs.select(take_d, d, data, width)
                valid = valid & v
            return data, valid

        return run_gl

