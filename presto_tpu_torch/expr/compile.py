"""Compile Expr trees to K1 programs over Pages.

Counterpart of ``presto_tpu/expr/compile.py``.  Where the reference
builds a closure of jnp ops that XLA fuses, the port lowers an
expression on the host to a postfix :class:`Program` that the
``expr_eval`` kernel (K1) interprets, one thread per row.  Literal
sub-trees, and the decimal rescale of a literal operand, fold on the
host.  The lowering covers what TPC-H Q1, Q6, Q14 and Q3 bind:
int32/int64/bool columns, literals, ``add``/``sub``/``mul`` with the
reference's overflow-to-NULL rule, decimal rescale with its overflow
guard, comparisons, BETWEEN, three-valued AND/OR/NOT, LIKE, IN and
varchar comparisons against literals (one boolean table over the
column's dictionary), IN over integer-lane literals, CASE/IF, long x
short decimal products, double columns and literals, double ``+ - *
/`` (a zero divisor gives NULL), negation and ``abs`` (over doubles and
integer lanes), ``cast_double`` of a number, and comparisons with a
double operand, which compare both sides as doubles (``_to_double``);
for TPC-DS, ``coalesce`` (each operand coerced to the output type, the
first valid kept), ``floor``/``ceil`` and ``round`` over decimals and
doubles, ``cast_decimal`` (from a double half to even, else
``_coerce``, down-scaling by floor division), long-decimal ``+``/``-``,
a string literal (code 0 of its singleton dictionary), string-valued
CASE / IF / coalesce over the merged dictionary of their branches (each
branch's codes remapped by an int32 table), and ``=``/``<>`` of two
string columns through a shared value-id space.
``ExprCompiler.compile_key`` also maps a key column's codes to their
value's representative code where the dictionary repeats a value (the
reference's ``canonicalize_codes``).
Anything else raises :class:`NotPorted`.

``expr_dictionary`` is the torch-free type-level helper the planner
uses to derive a projection's dictionary.
"""

from __future__ import annotations

import itertools
import operator
from collections import OrderedDict
import re
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from presto_tpu_torch import NotPorted
from presto_tpu_torch.expr.host_fns import STRING_TRANSFORM_FNS, _string_transform
from presto_tpu_torch.expr.ir import Call, ColumnRef, Expr, Literal
from presto_tpu_torch.kernels import expr_eval as k1
from presto_tpu_torch.page import Dictionary, Page
from presto_tpu_torch.types import Type

CompiledExpr = Callable[[Page], Tuple[torch.Tensor, torch.Tensor]]

# string-literal singleton dictionaries: value -> Dictionary (kept so
# repeated plans share the identity-hashed dictionary)
_LITERAL_DICTS: dict = {}
# (id(inner dictionary),) + transform key -> (inner dictionary, derived
# dictionary, per-code "the transform gave NULL" flags); the inner
# dictionary is kept so its id stays unique while the entry lives; and
# ("$case", branch keys...) -> (branch dictionaries, merged dictionary,
# value -> merged code) for a string-valued case/if/coalesce
_DERIVED_DICTS: dict = {}


def _transform_column(e: Call) -> Optional[Expr]:
    """The single non-literal argument of a string transform."""
    cols = [a for a in e.args if not isinstance(a, Literal)]
    return cols[0] if len(cols) == 1 else None


def _derived_entry(e: Call, dictionaries) -> Optional[tuple]:
    """The derived-dictionary entry of a string transform over a
    dictionary column: the transform runs once per dictionary value on
    the host (a lazy dictionary is walked one run of codes at a time),
    codes stay as they are."""
    col = _transform_column(e)
    tf = _string_transform(e)
    if col is None or tf is None or not col.type.is_string or col.type.is_raw_string:
        return None
    inner = expr_dictionary(col, dictionaries)
    if inner is None:
        return None
    f, tkey = tf
    key = (id(inner),) + tkey
    if key not in _DERIVED_DICTS:
        values = [f(v) for v in inner.values]
        nulls = [v is None for v in values]
        _DERIVED_DICTS[key] = (inner, Dictionary(["" if v is None else v for v in values]),
                               nulls)
    return _DERIVED_DICTS[key]


def expr_dictionary(e: Expr, dictionaries: Sequence[Optional[Dictionary]]
                    ) -> Optional[Dictionary]:
    """Dictionary provenance of a string-typed expression: bare columns
    keep theirs, a string literal gets a singleton dictionary, a string
    transform (``STRING_TRANSFORM_FNS``) of a dictionary column derives
    a dictionary of the transformed values (the reference's
    ``expr_dictionary``; NULL results become "" there, and validity
    says NULL)."""
    if isinstance(e, ColumnRef):
        return dictionaries[e.index]
    if isinstance(e, Literal) and e.value is not None:
        if e.value not in _LITERAL_DICTS:
            _LITERAL_DICTS[e.value] = Dictionary([e.value])
        return _LITERAL_DICTS[e.value]
    if isinstance(e, Call) and e.fn == "cast_char":
        return expr_dictionary(e.args[0], dictionaries)
    if isinstance(e, Call) and e.fn in STRING_TRANSFORM_FNS:
        entry = _derived_entry(e, dictionaries)
        return None if entry is None else entry[1]
    if isinstance(e, Call) and e.fn in ("case", "if", "coalesce"):
        return merged_string_dictionary(e, dictionaries)
    if isinstance(e, Call):
        raise NotPorted(f"dictionary of string expression {e.fn}")
    return None


def _string_case_branches(e: Call) -> List[Expr]:
    """The value-producing operands of a case/if/coalesce."""
    if e.fn == "case":
        return list(e.args[1::2]) + [e.args[-1]]
    if e.fn == "if":
        return [e.args[1], e.args[2]]
    return list(e.args)


def _merged_entry(e: Call, dictionaries) -> Optional[tuple]:
    """``(branch dictionaries, merged dictionary, value -> merged code)``
    of a string-valued case/if/coalesce, built once per set of branch
    dictionaries (they are pinned: the key holds their ids)."""
    parts, key_parts = [], []
    for b in _string_case_branches(e):
        if isinstance(b, Literal):
            parts.append(("lit", b.value))
            key_parts.append(("L", b.value))
        else:
            d = expr_dictionary(b, dictionaries)
            if d is None:
                return None
            parts.append(("dict", d))
            key_parts.append(("D", id(d)))
    key = ("$case",) + tuple(key_parts)
    if key not in _DERIVED_DICTS:
        values: list = []
        seen: dict = {}
        for kind, v in parts:
            for val in ([v] if kind == "lit" else v.values):
                if val is not None and val not in seen:
                    seen[val] = len(values)
                    values.append(val)
        pins = tuple(v for kind, v in parts if kind == "dict")
        _DERIVED_DICTS[key] = (pins, Dictionary(values if values else [""]), seen)
    return _DERIVED_DICTS[key]


def merged_string_dictionary(e: Call, dictionaries) -> Optional[Dictionary]:
    """The union dictionary of a string-valued case/if/coalesce (the
    reference's ``merged_string_dictionary``): every branch's values,
    first occurrence first, each value once; one object per set of
    branch dictionaries, so the planner and the compiler share it."""
    entry = _merged_entry(e, dictionaries)
    return None if entry is None else entry[1]


_KIND_OF_NP = {np.dtype(np.bool_): k1.KIND_BOOL, np.dtype(np.int32): k1.KIND_I32,
               np.dtype(np.int64): k1.KIND_I64}


def _storage_kind(t: Type) -> int:
    """K1 storage kind of a scalar type (its int32/int64/bool lane)."""
    if t.value_shape != () or t.is_long_decimal or t.is_string \
            or t.name in ("double", "real"):
        raise NotPorted(f"expressions over {t}")
    kind = _KIND_OF_NP.get(np.dtype(t.np_dtype))
    if kind is None:
        raise NotPorted(f"expressions over {t}")
    return kind


# stack lanes of a value: an int64 lane, a double, or long-decimal limbs
SHORT, DOUBLE, LONG = "short", "double", "long"


def _lane(t: Type) -> str:
    if t.is_long_decimal and t.value_shape == (2,):
        return LONG
    if t.name == "double":
        return DOUBLE
    _storage_kind(t)
    return SHORT


def _out_kind(t: Type) -> int:
    if t.is_string and not t.is_raw_string:
        return k1.KIND_I32  # dictionary codes
    lane = _lane(t)
    if lane == DOUBLE:
        return k1.KIND_F64
    if lane == LONG:
        return k1.KIND_D128
    return _storage_kind(t)


def _scale(t: Type) -> int:
    return (t.scale or 0) if t.is_decimal else 0


def _like_to_regex(pattern: str) -> "re.Pattern":
    """SQL LIKE as a regex: % = any run, _ = any single character."""
    out = []
    for ch in pattern:
        if ch == "%":
            out.append(".*")
        elif ch == "_":
            out.append(".")
        else:
            out.append(re.escape(ch))
    return re.compile("^" + "".join(out) + "$", re.DOTALL)


# (id(dictionary), predicate key) -> (dictionary, table), least
# recently used first: one table per dictionary and predicate, shared
# by every program using it; the dictionary is kept so its id stays
# unique while the entry lives
_LUT_CACHE: "OrderedDict[tuple, tuple]" = OrderedDict()
LUT_CACHE_SIZE = 256


def dictionary_lut(d: Dictionary, key: tuple, predicate,
                   dtype: torch.dtype = torch.bool) -> k1.Lut:
    """``predicate`` over every value of ``d``, indexable by code."""
    ck = (id(d), key)
    hit = _LUT_CACHE.get(ck)
    if hit is None:
        hit = _LUT_CACHE[ck] = (d, k1.Lut((predicate(v) for v in d.values), dtype,
                                          str(key[0])))
        if len(_LUT_CACHE) > LUT_CACHE_SIZE:
            _LUT_CACHE.popitem(last=False)
    else:
        _LUT_CACHE.move_to_end(ck)
    return hit[1]


def value_id_tables(a: Dictionary, b: Dictionary) -> Tuple[k1.Lut, k1.Lut]:
    """int32 tables taking ``a``'s and ``b``'s codes to one value-id
    space (equal values, equal ids): ids in order of first appearance
    over the pair's values, the pair ordered by identity so that either
    order of the arguments shares the tables, and both pinned in the
    tables' key."""
    pair = tuple(sorted((a, b), key=id))
    canon: dict = {}

    def value_id(v):
        if not canon:  # walked only when a table is built
            for d in pair:
                for x in d.values:
                    canon.setdefault(x, len(canon))
        return canon[v]

    key = ("string_eq",) + pair
    return (dictionary_lut(a, key, value_id, torch.int32),
            dictionary_lut(b, key, value_id, torch.int32))


# id(dictionary) -> (dictionary, whether a value repeats)
_DUPLICATES: dict = {}


def has_duplicates(d: Dictionary) -> bool:
    """Whether ``d`` holds a value under two codes (cached per
    dictionary, as the reference's ``_dict_has_duplicates``)."""
    hit = _DUPLICATES.get(id(d))
    if hit is None:
        hit = _DUPLICATES[id(d)] = (d, len(set(d.values)) < len(d.values))
    return hit[1]


# id(derived dictionary) -> (dictionary, K1 table of "the transform
# gave a value" per code)
_NOT_NULL_LUTS: dict = {}

# DATEPART's selector and LCMP's comparison: the argument is the
# index here
DATE_PARTS = ("year", "month", "day", "quarter")
LCMP_OPS = ("eq", "ne", "lt", "le", "gt", "ge")

_STRING_CMP = {"eq": operator.eq, "ne": operator.ne, "lt": operator.lt,
               "le": operator.le, "gt": operator.gt, "ge": operator.ge}
_SWAPPED = {"lt": "gt", "le": "ge", "gt": "lt", "ge": "le"}


class _Lowering:
    """Builds one postfix program; ``columns`` lists the page column
    behind each LOAD slot."""

    def __init__(self, dictionaries: Sequence[Optional[Dictionary]] = ()):
        self.dictionaries = list(dictionaries)
        self.ops: List[int] = []
        self.args: List[int] = []
        self.consts: List[int] = []
        self.columns: List[int] = []
        self.luts: List[k1.Lut] = []

    def _push(self, op: int, arg: int = 0) -> None:
        self.ops.append(op)
        self.args.append(arg)

    def _const(self, v: int) -> int:
        v = int(v)
        if v in self.consts:
            return self.consts.index(v)
        self.consts.append(v)
        return len(self.consts) - 1

    def _fold(self, start: int) -> None:
        """Replace the constant instructions from ``start`` by their
        value, computed by the plain evaluator on one row."""
        if len(self.ops) - start == 1 and self.ops[start] in (k1.LIT, k1.DLIT, k1.NULL):
            return
        prog = k1.Program(tuple(self.ops[start:]), tuple(self.args[start:]),
                          tuple(self.consts), 0, k1.KIND_I64)
        d, v = k1.expr_eval_plain(prog, [], 1)
        if d.dim() > 1:
            return  # a long decimal stays as its instructions
        del self.ops[start:], self.args[start:]
        if not bool(v[0]):
            self._push(k1.NULL)
        elif d.is_floating_point():
            self._push(k1.DLIT, self._const(k1.double_bits(float(d[0]))))
        else:
            self._push(k1.LIT, self._const(int(d[0])))

    def _load(self, index: int, op: int) -> None:
        if index not in self.columns:
            self.columns.append(index)
        self._push(op, self.columns.index(index))

    def emit(self, e: Expr) -> bool:
        """Push ``e``; True when it is constant (no column read)."""
        if isinstance(e, ColumnRef):
            if e.type.is_string and not e.type.is_raw_string:
                self._load(e.index, k1.LOAD)  # dictionary codes
                return False
            lane = _lane(e.type)
            self._load(e.index, {LONG: k1.LOAD_LONG, DOUBLE: k1.LOAD_F64}.get(lane, k1.LOAD))
            return False
        if isinstance(e, Literal):
            if e.value is None:
                self._push(k1.NULL)
                return True
            if e.type.is_string and not e.type.is_raw_string:
                # code 0 of the literal's singleton dictionary
                self._push(k1.LIT, self._const(0))
                return True
            if _lane(e.type) == DOUBLE:
                self._push(k1.DLIT, self._const(k1.double_bits(e.value)))
                return True
            if _lane(e.type) != SHORT:
                raise NotPorted(f"{e.type} literals")
            self._push(k1.LIT, self._const(int(e.value)))
            return True
        if not isinstance(e, Call):
            raise NotPorted(f"expression node {type(e).__name__}")
        start = len(self.ops)
        fn = e.fn
        if fn in STRING_TRANSFORM_FNS:
            return self._emit_transform(e)
        if fn == "like":
            return self._emit_like(e)
        if fn in _STRING_CMP and any(a.type.is_string for a in e.args):
            return self._emit_string_cmp(e)
        if fn == "in" and e.args[0].type.is_string:
            return self._emit_string_in(e)
        if fn in ("case", "if", "coalesce") and e.type.is_string:
            return self._emit_string_case(e)
        if fn == "in":
            const = self._emit_in(e)
        elif fn in ("case", "if"):
            const = self._emit_case(e)
        elif fn == "coalesce":
            const = self._emit_coalesce(e)
        elif fn in ("floor", "ceil", "ceiling") and len(e.args) == 1:
            const = self._emit_floor(e)
        elif fn == "round":
            const = self._emit_round(e)
        elif fn == "cast_decimal":
            const = self._emit_cast_decimal(e)
        elif fn in ("and", "or") and len(e.args) == 2:
            const = self.emit(e.args[0]) & self.emit(e.args[1])
            self._push(k1.AND if fn == "and" else k1.OR)
        elif fn == "not":
            const = self.emit(e.args[0])
            self._push(k1.NOT)
        elif fn in LCMP_OPS and DOUBLE in (_lane(e.args[0].type), _lane(e.args[1].type)):
            # the reference's _align_pair: both sides as doubles
            const = self._emit_double(e.args[0]) & self._emit_double(e.args[1])
            self._push(k1.DCMP, LCMP_OPS.index(fn))
        elif fn in ("eq", "ne", "lt", "le", "gt", "ge") and LONG in (_lane(e.args[0].type),
                                                                  _lane(e.args[1].type)):
            const = self._emit_long_cmp(e)
        elif fn in ("eq", "ne", "lt", "le", "gt", "ge"):
            a, b = e.args
            s = self._align_scale(a.type, b.type)
            const = self._emit_scaled(a, s, check=False) & self._emit_scaled(b, s, check=False)
            self._push(getattr(k1, fn.upper()))
        elif fn == "between":
            x, lo, hi = e.args
            double = DOUBLE in (_lane(x.type), _lane(lo.type), _lane(hi.type))
            s = None if double else self._align_scale(x.type, lo.type)
            if not double and s == self._align_scale(x.type, hi.type):
                const = (self._emit_scaled(x, s, check=False)
                         & self._emit_scaled(lo, s, check=False)
                         & self._emit_scaled(hi, s, check=False))
                self._push(k1.BETWEEN)
            else:  # per-pair alignment differs: the reference's and(ge, le)
                from presto_tpu_torch.types import BOOLEAN

                return self.emit(Call(type=BOOLEAN, fn="and", args=(
                    Call(type=BOOLEAN, fn="ge", args=(x, lo)),
                    Call(type=BOOLEAN, fn="le", args=(x, hi)))))
        elif fn in ("add", "sub", "mul", "div"):
            const = self._emit_arith(e)
        elif fn in ("neg", "abs") and len(e.args) == 1:
            const = self._emit_sign(e)
        elif fn == "cast_double" and not e.args[0].type.is_string:
            const = self._emit_double(e.args[0])  # _to_double
        elif fn in DATE_PARTS:
            (x,) = e.args
            if x.type.name != "date":
                raise NotPorted(f"{fn} of {x.type}")
            const = self.emit(x)
            self._push(k1.DATEPART, DATE_PARTS.index(fn))
        elif fn in ("is_null", "not_null"):
            const = self.emit(e.args[0])
            self._push(k1.NOTNULL, int(fn == "is_null"))
        else:
            raise NotPorted(f"expression {fn}")
        if const:
            self._fold(start)
        return const

    # -- strings: one table over the dictionary ----------------------------
    def _emit_lut(self, col: Expr, key: tuple, predicate) -> bool:
        """Push ``predicate(value)`` of a dictionary column: its int32
        code indexes a boolean table (clipped as the reference clips),
        and the column's valid bit stays."""
        if not isinstance(col, ColumnRef) and not (isinstance(col, Call)
                                                   and col.fn in STRING_TRANSFORM_FNS):
            raise NotPorted(f"string predicate over {col}")
        d = expr_dictionary(col, self.dictionaries)
        if d is None:
            raise NotPorted(f"string column {col} without a dictionary")
        self.emit(col)
        self._push_lut(dictionary_lut(d, key, predicate))
        return False

    def _push_lut(self, table: k1.Lut, op: int = k1.LUT) -> None:
        if table not in self.luts:
            self.luts.append(table)
        self._push(op, next(i for i, t in enumerate(self.luts) if t is table))

    def _emit_transform(self, e: Call) -> bool:
        """A string transform of a dictionary column: the codes pass
        through unchanged (the derived dictionary holds the new values);
        where the transform gives NULL for some value, a table over the
        codes clears the valid bit (``code`` if ``table[code]`` else
        NULL), the reference's null LUT."""
        entry = _derived_entry(e, self.dictionaries)
        if entry is None:
            raise NotPorted(f"string transform {e.fn} of {e.args}")
        col = _transform_column(e)
        _, derived, nulls = entry
        if not any(nulls):
            return self.emit(col)
        self.emit(col)
        hit = _NOT_NULL_LUTS.get(id(derived))
        if hit is None:
            hit = _NOT_NULL_LUTS[id(derived)] = (derived, k1.Lut([not n for n in nulls],
                                                                 torch.bool, "not_null"))
        self._push_lut(hit[1])
        self.emit(col)
        self._push(k1.NULL)
        self._push(k1.SEL)
        return False

    def _emit_like(self, e: Call) -> bool:
        col, pat = e.args
        if not isinstance(pat, Literal) or pat.value is None:
            raise NotPorted("LIKE with a non-literal pattern")
        rx = _like_to_regex(pat.value)
        return self._emit_lut(col, ("like", pat.value), lambda v: rx.match(v) is not None)

    def _emit_string_cmp(self, e: Call) -> bool:
        lhs, rhs = e.args
        op = e.fn
        if isinstance(rhs, Literal):
            col, s = lhs, rhs.value
        elif isinstance(lhs, Literal):
            col, s = rhs, lhs.value
            op = _SWAPPED.get(op, op)
        else:
            return self._emit_string_col_cmp(e)
        cmp = _STRING_CMP[op]
        return self._emit_lut(col, (op, s), lambda v: cmp(v, s))

    def _emit_string_col_cmp(self, e: Call) -> bool:
        """``a = b`` / ``a <> b`` of two dictionary string columns (the
        reference's canonical-value-id comparison): each side's codes go
        through its own int32 table (CANON) into one value-id space
        shared by both dictionaries, then the ids compare as integers;
        NULL where either side is.  An ordered comparison stays
        unported, as the reference refuses it."""
        lhs, rhs = e.args
        if e.fn not in ("eq", "ne"):
            raise NotPorted(f"ordered comparison ({e.fn}) of two string columns")
        if lhs.type.is_raw_string or rhs.type.is_raw_string:
            raise NotPorted("comparison of raw strings")
        da, db = expr_dictionary(lhs, self.dictionaries), expr_dictionary(rhs, self.dictionaries)
        if da is None or db is None:
            raise NotPorted("comparison of two string columns without dictionaries")
        ta, tb = value_id_tables(da, db)
        for x, t in ((lhs, ta), (rhs, tb)):
            self.emit(x)
            self._push_lut(t, k1.CANON)
        self._push(k1.EQ if e.fn == "eq" else k1.NE)
        return False

    def _emit_string_case(self, e: Call) -> bool:
        """A string-valued CASE / IF / coalesce over the merged
        dictionary of its branches (the reference's
        ``_compile_string_case``): a literal branch pushes its merged
        code, any other branch remaps its codes through an int32 table
        (CANON), then the branches select as a numeric CASE does (SEL)
        or take the first valid one (COAL)."""
        entry = _merged_entry(e, self.dictionaries)
        if entry is None:
            raise NotPorted("string case branch without a dictionary")
        _, merged, index = entry
        const = True

        def branch(b: Expr) -> bool:
            if isinstance(b, Literal):
                if b.value is None:
                    self._push(k1.NULL)
                else:
                    self._push(k1.LIT, self._const(index.get(b.value, 0)))
                return True
            d = expr_dictionary(b, self.dictionaries)
            self.emit(b)
            self._push_lut(dictionary_lut(d, ("remap", id(merged)),
                                          lambda v: index.get(v, 0), torch.int32), k1.CANON)
            return False

        args = e.args
        if e.fn == "coalesce":
            const &= branch(args[0])
            for b in args[1:]:
                const &= branch(b)
                self._push(k1.COAL)
            return const
        pairs = (len(args) - 1) // 2  # if(c, t, f) is case(c, t, f)
        for i in range(pairs):
            const &= self.emit(args[2 * i])
            const &= branch(args[2 * i + 1])
        const &= branch(args[-1])
        for _ in range(pairs):
            self._push(k1.SEL)
        return const

    def _emit_string_in(self, e: Call) -> bool:
        col, values = e.args[0], e.args[1:]
        if col.type.is_raw_string:
            raise NotPorted("IN over raw strings")
        if not all(isinstance(v, Literal) for v in values):
            raise NotPorted("IN with a non-literal value")
        wanted = frozenset(v.value for v in values)
        return self._emit_lut(col, ("in", tuple(sorted(wanted, key=repr))),
                              lambda s: s in wanted)

    def _emit_in(self, e: Call) -> bool:
        """``x IN (literals)`` over an integer lane: the raw value against
        each literal's value, no scale alignment (as the reference); the
        result keeps x's valid bit.  The literals take a run of the
        constant pool."""
        col, values = e.args[0], e.args[1:]
        if _lane(col.type) != SHORT:
            raise NotPorted(f"IN over {col.type}")
        lits = []
        for v in values:
            if not isinstance(v, Literal) or isinstance(v.value, bool) \
                    or not isinstance(v.value, (int, np.integer)):
                raise NotPorted("IN with a value that is not an integer literal")
            lits.append(int(v.value))
        if not lits or len(lits) >= 1 << (31 - k1.IN_COUNT_SHIFT):
            raise NotPorted(f"IN over {len(lits)} literals")
        const = self.emit(col)
        first = len(self.consts)
        if first >= 1 << k1.IN_COUNT_SHIFT:
            raise NotPorted("IN past the constant pool's reach")
        self.consts.extend(lits)
        self._push(k1.IN, first | len(lits) << k1.IN_COUNT_SHIFT)
        return const

    # -- CASE / IF ----------------------------------------------------------
    def _emit_case(self, e: Call) -> bool:
        """``case(w1, t1, ..., else)`` / ``if(c, t, f)``: nested selects
        from the last branch out, so the first true condition wins (the
        reference's ``taken`` rule); NULL conditions are not taken."""
        args = e.args
        out_t = e.type
        if _lane(out_t) == LONG:
            raise NotPorted(f"CASE producing {out_t}")
        const = True
        pairs = (len(args) - 1) // 2
        for i in range(pairs):
            const &= self.emit(args[2 * i])
            const &= self._emit_coerced(args[2 * i + 1], out_t)
        const &= self._emit_coerced(args[-1], out_t)
        for _ in range(pairs):
            self._push(k1.SEL)
        return const

    def _emit_coalesce(self, e: Call) -> bool:
        """``coalesce(a, b, ...)``: each operand in the output type
        (``_coerce``), then COAL keeps the first valid one, left to
        right (the reference's ``run_coalesce``)."""
        const = self._emit_coerced(e.args[0], e.type)
        for x in e.args[1:]:
            const &= self._emit_coerced(x, e.type)
            self._push(k1.COAL)
        return const

    def _emit_floor(self, e: Call) -> bool:
        """floor / ceil: a scaled-int floor division by 10^scale on a
        decimal (a ceiling adds 10^scale - 1 first), floor/ceil on a
        double, the value itself on an integer."""
        (x,) = e.args
        up = e.fn != "floor"
        lane = _lane(x.type)
        if lane == LONG:
            raise NotPorted(f"{e.fn} of {x.type}")
        const = self.emit(x)
        if lane == DOUBLE:
            self._push(k1.DFLOOR, int(up))
        elif x.type.is_decimal:
            self._push(k1.SFLOOR, self._const(10 ** _scale(x.type)) * 2 + int(up))
        return const

    def _emit_round(self, e: Call) -> bool:
        """round(x[, digits]): half away from zero; a decimal drops
        ``scale - digits`` digits (SROUND), a double rounds at
        10^digits (DROUND); an integer stays."""
        x = e.args[0]
        digits = 0
        if len(e.args) > 1:
            if not isinstance(e.args[1], Literal) or e.args[1].value is None:
                raise NotPorted("round with non-literal digits")
            digits = int(e.args[1].value)
        lane = _lane(x.type)
        if lane == LONG:
            raise NotPorted(f"round of {x.type}")
        const = self.emit(x)
        if lane == DOUBLE:
            self._push(k1.DROUND, self._const(k1.double_bits(10.0 ** digits)))
        elif x.type.is_decimal:
            drop = _scale(x.type) - min(digits, _scale(x.type))
            if drop > 0:
                self._push(k1.SROUND, self._const(10 ** drop))
        return const

    def _emit_cast_decimal(self, e: Call) -> bool:
        """cast to decimal: from a double, round(d * 10^scale) half to
        even (D2S; D2L splits it into limbs for a long decimal), else
        the reference's ``_coerce``."""
        x = e.args[0]
        to_t = e.type
        if x.type.name != "double":
            return self._emit_coerced(x, to_t)
        const = self.emit(x)
        m = self._const(k1.double_bits(10.0 ** _scale(to_t)))
        if _lane(to_t) == LONG:
            if (to_t.precision or 0) > 36:
                raise NotPorted(f"cast to {to_t}")
            self._push(k1.D2L, m)
        else:
            self._push(k1.D2S, m)
        return const

    def _emit_coerced(self, e: Expr, to_t: Type) -> bool:
        """Push ``e`` in ``to_t``'s representation (the reference's
        ``_coerce`` for the integer lanes: up-scaling wraps)."""
        if e.type == to_t or (_lane(e.type) == SHORT and not to_t.is_decimal
                              and not e.type.is_decimal and to_t.name == "bigint"):
            return self.emit(e)
        if _lane(to_t) == DOUBLE:
            return self._emit_double(e)
        if _lane(to_t) == LONG and _lane(e.type) in (SHORT, LONG) \
                and (to_t.precision or 0) <= 36:
            # _to_long_limbs: two limbs, up-scaled (wrapping) to to_t's scale
            k = _scale(to_t) - _scale(e.type)
            if k < 0:
                raise NotPorted(f"coercion of {e.type} to {to_t}")
            const = self.emit(e)
            if _lane(e.type) == SHORT:
                self._push(k1.S2L)
            if k:
                self._push(k1.LSCALE, k)
            return const
        if not (to_t.is_decimal and _lane(e.type) == SHORT):
            raise NotPorted(f"coercion of {e.type} to {to_t}")
        k = _scale(to_t) - _scale(e.type)
        if k < 0:  # _rescale down: floor division
            const = self.emit(e)
            self._push(k1.SFLOOR, self._const(10 ** -k) * 2)
            return const
        return self._emit_scaled(e, to_t.scale or 0, check=False)

    # -- double lanes ---------------------------------------------------------
    def _emit_double(self, e: Expr) -> bool:
        """Push ``e`` as a double (the reference's ``_to_double``: a
        double as it is, limbs through L2D, an int64 lane through S2D,
        each divided by 10^scale)."""
        lane = _lane(e.type)
        if lane == DOUBLE:
            return self.emit(e)
        start = len(self.ops)
        const = self.emit(e)
        self._push(k1.L2D if lane == LONG else k1.S2D, _scale(e.type))
        if const:
            self._fold(start)
        return const

    def _emit_sign(self, e: Call) -> bool:
        """``neg`` / ``abs``: a double's sign (DNEG, DABS), or an integer
        lane's, NULL where the lane's least value has no negation (the
        reference's ``_ovf_neg``, at int32 width for an int32 lane)."""
        (x,) = e.args
        lane = _lane(x.type)
        if lane == LONG:
            raise NotPorted(f"{e.fn} of {x.type}")
        const = self.emit(x)
        if lane == DOUBLE:
            self._push(k1.DNEG if e.fn == "neg" else k1.DABS)
        else:
            narrow = _storage_kind(x.type) == k1.KIND_I32
            self._push(k1.NEG if e.fn == "neg" else k1.ABS, int(narrow))
        return const

    def _emit_long_cmp(self, e: Call) -> bool:
        """A comparison with a long-decimal operand (the reference's
        ``run_lcmp``): each side goes to two limbs at the common scale
        (a short side through S2L, an up-scale through LSCALE, which
        wraps as ``decimal128.rescale`` does), then LCMP compares limb
        by limb."""
        a, b = e.args
        if DOUBLE in (_lane(a.type), _lane(b.type)):
            raise NotPorted(f"comparison of {a.type} and {b.type}")
        if {a.type.name, b.type.name} & {"date", "timestamp"}:
            raise NotPorted(f"comparison of {a.type} and {b.type}")
        s = max(_scale(a.type), _scale(b.type))
        const = True
        for x in (a, b):
            const &= self.emit(x)
            if _lane(x.type) == SHORT:
                self._push(k1.S2L)
            if s > _scale(x.type):
                self._push(k1.LSCALE, s - _scale(x.type))
        self._push(k1.LCMP, LCMP_OPS.index(e.fn))
        return const

    def _align_scale(self, ta: Type, tb: Type) -> int:
        """Common scale of a comparison pair (the reference's
        ``_align_pair``); only integer-lane pairs are ported."""
        for t in (ta, tb):
            _storage_kind(t)
        if {ta.name, tb.name} == {"date", "timestamp"}:
            raise NotPorted("date/timestamp comparison")
        return max(_scale(ta), _scale(tb))

    def _emit_scaled(self, e: Expr, to_scale: int, check: bool) -> bool:
        """Push ``e`` up-scaled to ``to_scale`` (SCALE_CHK NULLs a lane
        that would wrap; SCALE wraps, as the reference's ``_rescale``)."""
        start = len(self.ops)
        const = self.emit(e)
        k = to_scale - _scale(e.type)
        if k < 0:
            raise NotPorted("decimal down-scaling")
        if k > 0:
            self._push(k1.SCALE_CHK if check else k1.SCALE, self._const(10 ** k))
            if const:
                self._fold(start)
        return const

    def _emit_arith(self, e: Call) -> bool:
        a, b = e.args
        tr = e.type
        if tr.name == "double":
            const = self._emit_double(a) & self._emit_double(b)
            self._push({"add": k1.DADD, "sub": k1.DSUB, "mul": k1.DMUL, "div": k1.DDIV}[e.fn])
            return const
        lanes = (_lane(a.type), _lane(b.type))
        if tr.is_long_decimal and e.fn in ("add", "sub") and DOUBLE not in lanes \
                and (tr.precision or 0) <= 36:
            # both sides as limbs at the result's scale, then decimal128.add/sub
            const = self._emit_coerced(a, tr) & self._emit_coerced(b, tr)
            self._push(k1.LADD, int(e.fn == "sub"))
            return const
        if tr.is_long_decimal:
            if e.fn != "mul" or sorted(lanes) != [LONG, SHORT]:
                raise NotPorted(f"{e.fn} of {a.type} and {b.type} producing {tr}")
            self.emit(a)
            self.emit(b)
            self._push(k1.MUL_LS, 0 if lanes[0] == LONG else 1)
            return False
        if lanes != (SHORT, SHORT) or e.fn == "div":
            raise NotPorted(f"{e.fn} producing {tr}")
        if tr.is_decimal:
            if e.fn == "mul":  # scale sa + sb == tr.scale, no rescale
                const = self.emit(a) & self.emit(b)
            else:
                const = (self._emit_scaled(a, tr.scale or 0, check=True)
                         & self._emit_scaled(b, tr.scale or 0, check=True))
        elif tr.name == "bigint" and not a.type.is_decimal and not b.type.is_decimal \
                and np.dtype(np.int64) in (np.dtype(a.type.np_dtype),
                                           np.dtype(b.type.np_dtype)):
            # int64 arithmetic: at least one int64 operand, as jnp promotes
            const = self.emit(a) & self.emit(b)
        else:
            raise NotPorted(f"{e.fn} producing {tr}")
        self._push({"add": k1.ADD, "sub": k1.SUB, "mul": k1.MUL}[e.fn])
        return const

    def program(self, out_kind: int) -> k1.Program:
        # keep only the constants that folding left in use; each IN
        # keeps its literals as one run
        consts: List[int] = []
        args = list(self.args)
        for i, op in enumerate(self.ops):
            if op in k1.CONST_ARG_OPS or op == k1.SFLOOR:
                idx = args[i] >> 1 if op == k1.SFLOOR else args[i]
                v = self.consts[idx]
                if v not in consts:
                    consts.append(v)
                args[i] = consts.index(v) * 2 + (args[i] & 1) if op == k1.SFLOOR \
                    else consts.index(v)
            elif op == k1.IN:
                first, count = args[i] & ((1 << k1.IN_COUNT_SHIFT) - 1), \
                    args[i] >> k1.IN_COUNT_SHIFT
                args[i] = len(consts) | count << k1.IN_COUNT_SHIFT
                consts.extend(self.consts[first:first + count])
        prog = k1.Program(tuple(self.ops), tuple(args), tuple(consts),
                          len(self.columns), out_kind, tuple(self.luts))
        if (len(prog.ops) > k1.MAX_INS or len(prog.consts) > k1.MAX_CONSTS
                or prog.n_cols > k1.MAX_COLS or prog.depth > k1.MAX_STACK
                or len(prog.luts) > k1.MAX_LUTS):
            raise NotPorted(f"expression larger than the kernel's program limits: {prog}")
        return prog


class ExprCompiler:
    """Compiles expressions against a fixed input schema (types +
    dictionaries)."""

    def __init__(self, input_types: Sequence[Type],
                 dictionaries: Sequence[Optional[Dictionary]]):
        self.input_types = list(input_types)
        self.dictionaries = list(dictionaries)

    @classmethod
    def for_page(cls, page: Page) -> "ExprCompiler":
        return cls([b.type for b in page.blocks], [b.dictionary for b in page.blocks])

    def lower(self, expr: Expr) -> Tuple[k1.Program, List[int]]:
        """The K1 program of ``expr`` and the page columns it loads."""
        lw = _Lowering(self.dictionaries)
        lw.emit(expr)
        return lw.program(_out_kind(expr.type)), lw.columns

    def compile_key(self, expr: Expr) -> CompiledExpr:
        """``expr`` as a group or join key: where its dictionary repeats a
        value, each code becomes the smallest code of the same value
        (the reference's ``canonicalize_codes``, by K1's CANON), so keys
        follow value equality; else :meth:`compile`."""
        low = self.lower_key(expr)
        if low is None:
            return self.compile(expr)
        prog, columns = low
        return lambda page: k1.expr_eval(
            prog, [(page.blocks[i].data, page.blocks[i].valid) for i in columns], page.capacity)

    def lower_key(self, expr: Expr) -> Optional[Tuple[k1.Program, List[int]]]:
        """K1's CANON program of a key column whose dictionary repeats a
        value, and the column it reads; None for any other key."""
        d = expr_dictionary(expr, self.dictionaries) if expr.type.is_string else None
        if d is None or not has_duplicates(d):
            return None
        # the table is built walking the values in code order, so the
        # first code seen for a value is its smallest code
        first: dict = {}
        codes = itertools.count()
        lw = _Lowering(self.dictionaries)
        lw.emit(expr)
        lw._push_lut(dictionary_lut(d, ("canon",),
                                    lambda v: first.setdefault(v, next(codes)),
                                    torch.int32), k1.CANON)
        return lw.program(k1.KIND_I32), list(lw.columns)

    def compile(self, expr: Expr) -> CompiledExpr:
        if isinstance(expr, ColumnRef):
            i = expr.index
            return lambda page: (page.blocks[i].data, page.blocks[i].valid)
        prog, columns = self.lower(expr)
        if prog.n_cols == 0:  # a constant: its value, computed once on the host
            d, v = k1.expr_eval_plain(prog, [], 1)

            def run_const(page):
                n = page.capacity
                return (d.to(page.device).expand((n,) + tuple(d.shape[1:])).contiguous(),
                        v.to(page.device).expand(n).contiguous())

            return run_const

        def run(page):
            cols = [(page.blocks[i].data, page.blocks[i].valid) for i in columns]
            return k1.expr_eval(prog, cols, page.capacity)

        return run


def compile_filter(expr: Expr, page: Page):
    """Compile a predicate over ``page``'s schema to ``page -> bool
    mask`` (NULL -> excluded), the PageFilter analog.  A column
    predicate runs as one K1 launch that ANDs the result into the
    page's row mask."""
    c = ExprCompiler.for_page(page)
    if isinstance(expr, ColumnRef):
        i = expr.index
        return lambda page: page.blocks[i].data & page.blocks[i].valid & page.row_mask
    prog, columns = c.lower(expr)
    if prog.n_cols == 0:
        keep = prog.ops[0] == k1.LIT and prog.consts[prog.args[0]] != 0
        return lambda page: page.row_mask & keep

    def run(page):
        cols = [(page.blocks[i].data, page.blocks[i].valid) for i in columns]
        return k1.expr_eval(prog, cols, page.capacity, row_mask=page.row_mask)

    return run
