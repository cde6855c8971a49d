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
string columns through a shared value-id space; and the function
surface: the double math family (sqrt ... truncate, sign, the NaN and
infinity tests, power, atan2, width_bucket), ``mod`` (floored over
doubles as jnp.mod, truncating over integers and decimals) and integer
``div``, the bitwise functions, ``greatest``/``least``, ``nullif``,
``cast_bigint``, ``hll_bucket``/``hll_rho`` and the date parts
day_of_week, day_of_year, week, year_of_week and last_day_of_month
(K1's family opcodes); timestamps (an int64 lane of epoch
microseconds; a date beside one goes to microseconds, as the
reference's ``_align_pair``), their date parts and time of day,
date_trunc / date_add / date_diff, the interval arithmetic the binder
lowers to ``ts_add_micros`` / ``ts_add_months`` / ``date_add_months`` /
``date_add_days``, to_unixtime / from_unixtime, CAST between dates and
timestamps, ``date_format`` (a code into one dictionary per format), the
string functions over dictionaries (an int64 or double table per
dictionary, function and literal, with a not-null table where a value
maps to NULL: length, strpos, codepoint, the JSON sizes, from_base,
date_parse, from_iso8601_date, the edit distances against a literal,
CAST of a varchar column to a number, crc32 / xxhash64 of ``to_utf8``;
the predicates regexp_like, starts_with, ends_with and is_json_scalar
as boolean tables) and ``try`` (the identity); the narrow scalar types:
SMALLINT and TINYINT lanes, REAL on the double lane rounded to float32
after each operation (the reference's float32 arithmetic, its
``_align_pair`` REAL branch), ``cast_real`` / ``cast_smallint`` /
``cast_tinyint`` (out of range NULL), integer arithmetic at its
operands' widths, interval arithmetic (int64 lanes of microseconds or
months) and IN over a double column; the wide decimals (the D38 lane:
decimal(37..38) as five base-10^9 limbs on K1's five-limb instance,
the reference's ``_to_long_limbs(..., limbs=5)`` widening of short and
long operands, add/sub, wide x int64 products, comparisons, abs, sign,
neg, greatest/least, CASE, coalesce and the casts out, and long or
wide literals as runs of constants; a wide x wide or wide x long
product, a long-decimal mod, div or round stay refused, as there).  An
expression that
involves ARRAY, MAP or ROW values, lambdas or ``split`` goes to the
container half (``expr/containers.py``: K12, K13, and K1 for the
scalar parts); raw strings to the raw half (``expr/rawstrings.py``:
K17, bridge columns); the ST_* functions to the geospatial half
(``expr/geospatial.py``: ST_Contains a K18 bridge column, ST_Area /
ST_X / ST_Y value tables, ST_Distance K1's double opcodes).
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
from presto_tpu_torch.expr.host_fns import STRING_TRANSFORM_FNS, _json_path_lookup, \
    _levenshtein, _mysql_to_strftime, _string_transform, iso_date_days, \
    mysql_datetime_micros, parse_number_strict, xxh64_signed
from presto_tpu_torch.expr.containers import CONTAINER_FNS, ContainerCompiler, \
    container_dictionary, involves_containers
from presto_tpu_torch.expr.ir import Call, ColumnRef, Expr, Literal
from presto_tpu_torch.expr.geospatial import GEO_FNS, GeoCompiler, emit_geo, involves_contains
from presto_tpu_torch.expr.rawstrings import RawCompiler, involves_raw
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
    if e.type is not None and e.type.is_raw_string:  # bytes, no dictionary
        return None
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
    if isinstance(e, Call) and e.fn == "date_format":
        fmt = e.args[1]
        if isinstance(fmt, Literal) and fmt.value is not None:
            return date_format_dictionary(fmt.value)
        return None
    if isinstance(e, Call) and e.fn == "try":
        return expr_dictionary(e.args[0], dictionaries)
    if isinstance(e, Call) and (e.fn in CONTAINER_FNS or e.type.is_array or e.type.is_map):
        return container_dictionary(e, dictionaries)
    if isinstance(e, Call):
        raise NotPorted(f"dictionary of string expression {e.fn}")
    return None


def literal_array_dictionary(values) -> Dictionary:
    """Shared dictionary of an all-literal string array
    (ARRAY['a','b']): codes are positions in the sorted distinct values,
    cached by content so the planner, the compiler and an unnest's
    channel resolve to the same dictionary (the reference's
    ``literal_array_dictionary``)."""
    key = ("$litarr", tuple(values))
    if key not in _DERIVED_DICTS:
        _DERIVED_DICTS[key] = (None, Dictionary(sorted(set(values))), [False])
    return _DERIVED_DICTS[key][1]


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


# format -> its date_format dictionary, shared by the planner's channel
# metadata and the compiler (the reference's _DATE_FMT_CACHE)
_DATE_FMT_CACHE: dict = {}
# time-of-day format codes, which a day's dictionary cannot hold
_MYSQL_TIME_CODES = frozenset("HkhIisSfpTr")


def date_format_dictionary(fmt: str) -> Dictionary:
    """The dictionary of ``date_format(x, fmt)``: one formatted string
    per epoch day from 1900-01-01 (``DATE_FMT_SPAN`` days); a value's
    code is its day minus ``DATE_FMT_BASE`` (the reference's
    ``ExprCompiler.date_format_dictionary``), built once per format."""
    got = _DATE_FMT_CACHE.get(fmt)
    if got is not None:
        return got
    import datetime as _dt

    py_fmt = _mysql_to_strftime(fmt)
    if any(c in _MYSQL_TIME_CODES for c in re.findall(r"%(.)", fmt)):
        raise ValueError("date_format supports date-valued columns (time-of-day "
                         "format codes need the timestamp's full domain)")
    base = _dt.date(1900, 1, 1)
    d = Dictionary([(base + _dt.timedelta(days=i)).strftime(py_fmt)
                    for i in range(k1.DATE_FMT_SPAN)])
    _DATE_FMT_CACHE[fmt] = d
    return d


def merged_string_dictionary(e: Call, dictionaries) -> Optional[Dictionary]:
    """The union dictionary of a string-valued case/if/coalesce (the
    reference's ``merged_string_dictionary``): every branch's values,
    first occurrence first, each value once; one object per set of
    branch dictionaries, so the planner and the compiler share it."""
    entry = _merged_entry(e, dictionaries)
    return None if entry is None else entry[1]


_KIND_OF_NP = {np.dtype(np.bool_): k1.KIND_BOOL, np.dtype(np.int32): k1.KIND_I32,
               np.dtype(np.int64): k1.KIND_I64, np.dtype(np.int16): k1.KIND_I16,
               np.dtype(np.int8): k1.KIND_I8}
# the signed width of an integer storage kind narrower than int64
_NARROW_BITS = {k1.KIND_I32: 32, k1.KIND_I16: 16, k1.KIND_I8: 8}


def _storage_kind(t: Type) -> int:
    """K1 storage kind of a scalar type (its int8/int16/int32/int64/bool
    lane)."""
    if t.value_shape != () or t.is_long_decimal or t.is_string \
            or t.name in ("double", "real"):
        raise NotPorted(f"expressions over {t}")
    kind = _KIND_OF_NP.get(np.dtype(t.np_dtype))
    if kind is None:
        raise NotPorted(f"expressions over {t}")
    return kind


# stack lanes of a value: an int64 lane, a double, long-decimal limbs
# (two base-10^18), or wide-decimal limbs (decimal(37..38): five
# base-10^9)
SHORT, DOUBLE, LONG, D38 = "short", "double", "long", "d38"
LIMBS = (LONG, D38)


def _refuse_limbs(e: Call) -> None:
    """The reference's refusal of a math function whose first operand is
    a long or wide decimal (``_compile_math``: elementwise limb math
    would be silently wrong)."""
    if e.args[0].type.is_long_decimal:
        raise ValueError(f"{e.fn} on long decimals unsupported (cast first)")


def _lane(t: Type) -> str:
    if t.is_long_decimal:
        return LONG if t.value_shape == (2,) else D38
    if t.name in ("double", "real"):  # a REAL rides the double lane as its exact value
        return DOUBLE
    _storage_kind(t)
    return SHORT


def _out_kind(t: Type) -> int:
    if t.is_string and not t.is_raw_string:
        return k1.KIND_I32  # dictionary codes
    lane = _lane(t)
    if lane == DOUBLE:
        return k1.KIND_F32 if t.name == "real" else k1.KIND_F64
    if lane == LONG:
        return k1.KIND_D128
    if lane == D38:
        return k1.KIND_D38
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


def value_tables(d: Dictionary, key: tuple, fn, dtype: torch.dtype
                 ) -> Tuple[k1.Lut, Optional[k1.Lut]]:
    """VLUT's (int64) or DVLUT's (double) table of ``fn`` over every
    value of ``d`` (None maps to 0), and the not-null table where some
    value maps to None; built once per dictionary, function and
    literal, walking the values once."""
    ck = (id(d), ("values", dtype) + key)
    hit = _LUT_CACHE.get(ck)
    if hit is None:
        vals = [fn(v) for v in d.values]
        nulls = any(v is None for v in vals)
        hit = _LUT_CACHE[ck] = (d, (
            k1.Lut((0 if v is None else v for v in vals), dtype, str(key[0])),
            k1.Lut((v is not None for v in vals), torch.bool, "not_null") if nulls else None))
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
DATE_PARTS = k1.TS_PARTS
LCMP_OPS = ("eq", "ne", "lt", "le", "gt", "ge")

_BITWISE_FNS = ("bitwise_and", "bitwise_or", "bitwise_xor", "bitwise_not",
                "bitwise_shift_left", "bitwise_shift_right", "bit_count")
# register-index width of approx_distinct's sketch (the reference's
# ExprCompiler.HLL_P: m = 4096 buckets)
HLL_P = 12

# string functions read through an int64 value table over the
# dictionary (the reference's _compile_string_lut_fn), and predicates
# through a boolean one (_compile_string_bool_lut)
STRING_VALUE_FNS = ("length", "strpos", "codepoint", "json_array_length", "url_extract_port",
                    "from_base", "date_parse", "from_iso8601_date", "levenshtein_distance",
                    "hamming_distance", "json_size")
STRING_BOOL_FNS = ("regexp_like", "starts_with", "ends_with", "is_json_scalar")
DATETIME_FNS = ("date_trunc", "date_add", "date_diff", "cast_timestamp", "cast_date",
                "to_unixtime", "from_unixtime", "ts_add_micros", "ts_add_months",
                "date_add_months", "date_add_days")
_DT = ("date", "timestamp")

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

    def _push_null(self, limbs: int) -> None:
        """A NULL of an int64 lane, or of a long (S2L) or wide (S2D38)
        decimal, so its lane has its limbs."""
        self._push(k1.NULL)
        if limbs > 1:
            self._push(k1.S2L if limbs == 2 else k1.S2D38)

    def _push_limbs(self, limbs) -> None:
        """A long (two limbs) or wide (five) literal: LIT_LONG or LIT_D38
        over a run of constants."""
        first = len(self.consts)
        self.consts.extend(int(x) for x in limbs)
        self._push(k1.LIT_LONG if len(limbs) == 2 else k1.LIT_D38, first)

    def _fold(self, start: int) -> None:
        """Replace the constant instructions from ``start`` by their
        value, computed by the plain evaluator on one row."""
        if len(self.ops) - start == 1 and self.ops[start] in (k1.LIT, k1.DLIT, k1.NULL,
                                                              k1.LIT_LONG, k1.LIT_D38):
            return
        prog = k1.Program(tuple(self.ops[start:]), tuple(self.args[start:]),
                          tuple(self.consts), 0, k1.KIND_I64, tuple(self.luts))
        d, v = k1.expr_eval_plain(prog, [], 1)
        del self.ops[start:], self.args[start:]
        if not bool(v[0]):
            self._push_null(d.shape[1] if d.dim() > 1 else 1)
        elif d.dim() > 1:  # a long or wide decimal: its limbs
            self._push_limbs(d[0].tolist())
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
            self._load(e.index, {LONG: k1.LOAD_LONG, DOUBLE: k1.LOAD_F64,
                                 D38: k1.LOAD_D38}.get(lane, k1.LOAD))
            return False
        if isinstance(e, Literal):
            if e.value is None:
                self._push_null(e.type.value_shape[0] if e.type.is_long_decimal else 1)
                return True
            if e.type.is_string and not e.type.is_raw_string:
                # code 0 of the literal's singleton dictionary
                self._push(k1.LIT, self._const(0))
                return True
            if _lane(e.type) == DOUBLE:
                v = float(np.float32(e.value)) if e.type.name == "real" else e.value
                self._push(k1.DLIT, self._const(k1.double_bits(v)))
                return True
            if _lane(e.type) in LIMBS:  # the unscaled value's limbs
                from presto_tpu_torch.ops.decimal128 import encode_py

                self._push_limbs(encode_py([int(e.value)], 1, e.type.value_shape[0])[0])
                return True
            self._push(k1.LIT, self._const(int(e.value)))
            return True
        if not isinstance(e, Call):
            raise NotPorted(f"expression node {type(e).__name__}")
        start = len(self.ops)
        fn = e.fn
        if fn == "try":  # the identity at run time: errors already NULL their lanes
            return self.emit(e.args[0])
        if fn in GEO_FNS:  # st_contains never gets here: it is a K18 bridge column
            const = emit_geo(self, e)
            if const:
                self._fold(start)
            return const
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
        if fn in STRING_VALUE_FNS:
            const = self._emit_string_value(e)
        elif fn in STRING_BOOL_FNS:
            const = self._emit_string_bool(e)
        elif fn in ("cast_bigint", "cast_double") and e.args[0].type.is_string:
            const = self._emit_string_number_cast(e)
        elif fn in ("crc32", "xxhash64"):
            const = self._emit_binary_hash(e)
        elif fn == "in":
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
        elif fn in LCMP_OPS and {e.args[0].type.name, e.args[1].type.name} == set(_DT):
            # the reference's _align_pair: the date side to microseconds
            const = self._emit_ts(e.args[0]) & self._emit_ts(e.args[1])
            self._push(getattr(k1, fn.upper()))
        elif fn in LCMP_OPS and DOUBLE in (_lane(e.args[0].type), _lane(e.args[1].type)):
            # the reference's _align_pair: both sides as doubles, or, with
            # a REAL and no double, both as float32
            emit = self._emit_double if "double" in (e.args[0].type.name, e.args[1].type.name) \
                else self._emit_real
            const = emit(e.args[0]) & emit(e.args[1])
            self._push(k1.DCMP, LCMP_OPS.index(fn))
        elif fn in ("eq", "ne", "lt", "le", "gt", "ge") and {
                _lane(e.args[0].type), _lane(e.args[1].type)} & set(LIMBS):
            const = self._emit_long_cmp(e)
        elif fn in ("eq", "ne", "lt", "le", "gt", "ge"):
            a, b = e.args
            s = self._align_scale(a.type, b.type)
            const = self._emit_scaled(a, s, check=False) & self._emit_scaled(b, s, check=False)
            self._push(getattr(k1, fn.upper()))
        elif fn == "between":
            x, lo, hi = e.args
            lanes = {_lane(x.type), _lane(lo.type), _lane(hi.type)}
            double = DOUBLE in lanes or bool(lanes & set(LIMBS)) \
                or len({x.type.name, lo.type.name, hi.type.name} & set(_DT)) == 2
            s = None if double else self._align_scale(x.type, lo.type)
            if not double and s == self._align_scale(x.type, hi.type):
                const = (self._emit_scaled(x, s, check=False)
                         & self._emit_scaled(lo, s, check=False)
                         & self._emit_scaled(hi, s, check=False))
                self._push(k1.BETWEEN)
            else:  # per-pair alignment differs (a date beside a timestamp, limbs): and(ge, le)
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
        elif fn == "cast_real" and not e.args[0].type.is_string:
            const = self._emit_cast_real(e.args[0])
        elif fn in ("cast_smallint", "cast_tinyint") and not e.args[0].type.is_string:
            const = self._emit_cast_narrow(e)
        elif fn in DATE_PARTS:
            (x,) = e.args
            if x.type.name not in _DT:
                raise NotPorted(f"{fn} of {x.type}")
            const = self.emit(x)
            self._push(k1.TSPART if x.type.name == "timestamp" else k1.DATEPART,
                       DATE_PARTS.index(fn))
        elif fn in DATETIME_FNS:
            const = self._emit_datetime(e)
        elif fn == "date_format":
            const = self._emit_date_format(e)
        elif fn in ("is_null", "not_null"):
            const = self.emit(e.args[0])
            self._push(k1.NOTNULL, int(fn == "is_null"))
        elif fn in k1.DUN_FNS:
            const = self._emit_dun(e)
        elif fn in ("power", "pow", "atan2"):
            _refuse_limbs(e)
            const = self._emit_double(e.args[0]) & self._emit_double(e.args[1])
            self._push(k1.DBIN, k1.DBIN_FNS.index("atan2" if fn == "atan2" else "power"))
        elif fn == "mod":
            const = self._emit_arith(e)
        elif fn in _BITWISE_FNS:
            const = self._emit_bitwise(e)
        elif fn in ("greatest", "least"):
            const = self._emit_greatest_least(e)
        elif fn == "nullif":
            const = self._emit_nullif(e)
        elif fn == "cast_bigint":
            const = self._emit_cast_bigint(e)
        elif fn in ("hll_bucket", "hll_rho"):
            const = self._emit_hll(e)
        elif fn == "width_bucket":
            _refuse_limbs(e)
            const = self._emit_width_bucket(e)
        else:
            raise NotPorted(f"expression {fn}")
        if const:
            self._fold(start)
        return const

    # -- the function surface: K1's family opcodes --------------------------
    def _emit_dun(self, e: Call) -> bool:
        """A function of one double (DUN): the argument as a double
        (``_to_double``), then the function by index; ``sign`` and the
        NaN / infinity tests give an integer lane."""
        (x,) = e.args
        if _lane(x.type) in LIMBS:
            if e.fn != "sign":
                raise NotPorted(f"{e.fn} of {x.type}")
            # the reference's run_lsign: -1, 0 or 1 by the limbs (D38SIGN)
            const = self._emit_wide(x, _scale(x.type))
            self._push(k1.D38SIGN, 1)
            return const
        const = self._emit_double(x)
        self._push(k1.DUN, k1.DUN_FNS.index(e.fn))
        return const

    def _emit_bitwise(self, e: Call) -> bool:
        """The reference's ``_compile_bitwise`` over int64 lanes (BITW):
        and/or/xor; ``bitwise_not`` as xor with -1; a shift or
        ``bit_count`` takes a literal ``bits`` in [2, 64] and works on
        the value's low ``bits`` bits as an unsigned field (the bits
        literal stands as bit_count's second operand, which it
        ignores)."""
        fn = e.fn
        args = list(e.args)
        for a in args:
            if _lane(a.type) != SHORT or a.type.is_decimal:
                raise NotPorted(f"{fn} over {a.type}")
        bits = 64
        if fn in ("bitwise_shift_left", "bitwise_shift_right", "bit_count"):
            blit = args.pop()
            if not isinstance(blit, Literal) or blit.value is None \
                    or not 2 <= int(blit.value) <= 64:
                raise NotPorted(f"{fn} with bits {blit}")
            bits = int(blit.value)
        op = {"bitwise_and": "and", "bitwise_or": "or", "bitwise_xor": "xor",
              "bitwise_not": "xor", "bitwise_shift_left": "shift_left",
              "bitwise_shift_right": "shift_right", "bit_count": "bit_count"}[fn]
        const = self.emit(args[0])
        if fn == "bitwise_not":
            self._push(k1.LIT, self._const(-1))
        elif fn == "bit_count":
            self._push(k1.LIT, self._const(bits))
        else:
            const &= self.emit(args[1])
        self._push(k1.BITW, k1.BITW_OPS.index(op) | bits << 4)
        return const

    def _emit_greatest_least(self, e: Call) -> bool:
        """greatest / least: every operand in the output type
        (``_coerce``), folded left to right by GL; NULL if any operand
        is (Presto).  Doubles propagate NaN and order -0.0 below 0.0, as
        jnp.maximum / jnp.minimum do."""
        out_t = e.type
        if out_t.is_string:
            raise NotPorted(f"{e.fn} over {out_t}")
        lane = _lane(out_t)
        gl = {SHORT: k1.GL_INT, DOUBLE: k1.GL_DOUBLE, LONG: k1.GL_LONG, D38: k1.GL_D38}[lane]
        const = self._emit_coerced(e.args[0], out_t)
        for x in e.args[1:]:
            const &= self._emit_coerced(x, out_t)
            self._push(k1.GL, int(e.fn == "greatest") | gl << 1)
        return const

    def _emit_nullif(self, e: Call) -> bool:
        """nullif(a, b): ``a``, NULL where ``a = b`` is true, the pair
        compared as the reference's ``_align_pair`` aligns it (the
        comparison's own lowering)."""
        from presto_tpu_torch.types import BOOLEAN

        a, b = e.args
        if a.type.is_string or b.type.is_string:
            raise NotPorted("nullif over varchar")
        const = self.emit(a)
        const &= self.emit(Call(type=BOOLEAN, fn="eq", args=(a, b)))
        self._push(k1.NULLIF)
        return const

    def _emit_cast_bigint(self, e: Call) -> bool:
        """cast to bigint: a double toward zero (XLA's saturating
        conversion, NaN to 0), a short decimal HALF_UP at its scale (the
        reference's DecimalCasts rule), a long or wide decimal's floor at
        its scale (a wide one collapsed by Horner's rule, wrapping: the
        reference's ``_narrow_to_int64``), an integer lane as it is."""
        (x,) = e.args
        if x.type.is_string:
            raise NotPorted(f"cast_bigint of {x.type}")
        lane = _lane(x.type)
        const = self.emit(x)
        if lane == DOUBLE:
            self._push(k1.CASTBI, k1.CAST_FROM_DOUBLE)
        elif lane == LONG:
            if _scale(x.type) > 18:
                raise NotPorted(f"cast_bigint of {x.type}")
            self._push(k1.CASTBI, k1.CAST_FROM_LONG | _scale(x.type) << 2)
        elif lane == D38:
            self._push_d38_int64(_scale(x.type))
        elif _scale(x.type):
            self._push(k1.CASTBI, k1.CAST_FROM_SHORT | _scale(x.type) << 2)
        return const

    def _push_d38_int64(self, scale: int) -> None:
        """The wide value on the stack floored at ``scale`` and collapsed
        to an int64 lane (D38DOWN, D38NARROW)."""
        if scale:
            self._push(k1.D38DOWN, scale)
        self._push(k1.D38NARROW, 0)

    def _emit_hll(self, e: Call) -> bool:
        """hll_bucket / hll_rho (HLL): splitmix64 of the value's lane, an
        integer as it is, a double's bits, a dictionary string's value
        id (codes of one value share it, the reference's canonical
        table), then the bucket (top P bits) or rho."""
        col = e.args[0]
        p = HLL_P
        if len(e.args) > 1:
            if not isinstance(e.args[1], Literal) or e.args[1].value is None:
                raise NotPorted(f"{e.fn} with a non-literal width")
            p = int(e.args[1].value)
        t = col.type
        if t.is_raw_string or t.name == "real" or (not t.is_string and _lane(t) in LIMBS):
            raise NotPorted(f"{e.fn} over {t}")
        if t.is_string:
            d = expr_dictionary(col, self.dictionaries)
            if d is None:
                raise NotPorted(f"{e.fn} over a string without a dictionary")
            canon: dict = {}
            self.emit(col)
            self._push_lut(dictionary_lut(d, ("hll_value",),
                                          lambda v: canon.setdefault(v, len(canon)),
                                          torch.int32), k1.CANON)
            const = False
        else:
            const = self.emit(col)
        self._push(k1.HLL, int(e.fn == "hll_rho") | p << 1)
        return const

    def _emit_width_bucket(self, e: Call) -> bool:
        """width_bucket(x, lo, hi, n) (WBUCKET): x, lo and hi as
        doubles, n as an integer lane."""
        x, lo, hi, n = e.args
        if _lane(n.type) != SHORT or n.type.is_decimal:
            raise NotPorted(f"width_bucket with {n.type} buckets")
        const = self._emit_double(x) & self._emit_double(lo) & self._emit_double(hi)
        const &= self.emit(n)
        self._push(k1.WBUCKET)
        return const

    # -- dates and timestamps ------------------------------------------------
    def _emit_ts(self, e: Expr) -> bool:
        """Push a date or timestamp as microseconds (CASTTS of a date)."""
        start = len(self.ops)
        const = self.emit(e)
        if e.type.name == "date":
            self._push(k1.CASTTS, 0)
            if const:
                self._fold(start)
        return const

    def _emit_datetime(self, e: Call) -> bool:
        """The reference's ``_compile_datetime`` (and ``date_add_days``):
        date_trunc / date_add / date_diff by a literal unit (DTRUNC,
        DTADD, DTDIFF), the casts between dates and timestamps (CASTTS),
        to_unixtime / from_unixtime (UNIXT), and the interval arithmetic
        the binder lowers to a plain wrapping add of microseconds
        (``ts_add_micros``) or of days (``date_add_days``), or to calendar
        months (DTADD's month unit)."""
        fn = e.fn

        def ts_flag(t: Type) -> int:
            return k1.DT_TS if t.name == "timestamp" else 0

        if fn in ("date_trunc", "date_add", "date_diff"):
            unit_lit = e.args[0]
            if not isinstance(unit_lit, Literal) or unit_lit.value is None:
                raise NotPorted(f"{fn} with a non-literal unit")
            unit = str(unit_lit.value).lower().rstrip("s")
            allowed = {"date_trunc": k1.DT_UNITS[2:], "date_add": k1.DT_UNITS[1:],
                       "date_diff": k1.DT_UNITS[1:]}[fn]
            args = e.args[1:]
            if unit not in allowed or any(a.type.name not in _DT for a in args[-1:]) or (
                    fn == "date_diff" and args[0].type.name not in _DT):
                raise NotPorted(f"{fn} unit {unit} of {[a.type for a in args]}")
            ui = k1.DT_UNITS.index(unit)
            if fn == "date_trunc":
                const = self.emit(args[0])
                self._push(k1.DTRUNC, ui | ts_flag(args[0].type))
                return const
            if fn == "date_diff":
                a, b = args
                const = self.emit(a) & self.emit(b)
                self._push(k1.DTDIFF, ui | (k1.DT_A_DATE if a.type.name == "date" else 0)
                           | (k1.DT_B_DATE if b.type.name == "date" else 0))
                return const
            n, x = args
            if x.type.name == "date" and unit not in ("day", "week", "month", "quarter",
                                                      "year"):
                raise NotPorted(f"date_add unit {unit} on a date")
            return self._emit_dt_add(x, n, ui | ts_flag(x.type))
        x = e.args[0]
        if fn in ("ts_add_micros", "ts_add_months", "date_add_months", "date_add_days"):
            want = "date" if fn.startswith("date") else "timestamp"
            if x.type.name != want:
                raise NotPorted(f"{fn} of {x.type}")
            unit = {"ts_add_micros": "microsecond", "date_add_days": "day"}.get(fn, "month")
            return self._emit_dt_add(x, e.args[1], k1.DT_UNITS.index(unit) | ts_flag(x.type))
        if fn == "from_unixtime":
            if _lane(x.type) in LIMBS:
                raise NotPorted(f"from_unixtime of {x.type}")
            const = self._emit_double(x)
            self._push(k1.UNIXT, k1.UNIXT_FROM)
            return const
        if x.type.name not in _DT:
            raise NotPorted(f"{fn} of {x.type}")
        const = self.emit(x)
        if fn == "to_unixtime":
            self._push(k1.UNIXT, k1.UNIXT_DATE if x.type.name == "date" else k1.UNIXT_TS)
        elif fn == "cast_timestamp" and x.type.name == "date":
            self._push(k1.CASTTS, 0)
        elif fn == "cast_date" and x.type.name == "timestamp":
            self._push(k1.CASTTS, 1)
        return const

    def _emit_dt_add(self, x: Expr, n: Expr, arg: int) -> bool:
        """DTADD of ``x`` (a date or timestamp) and ``n`` units (an
        integer lane)."""
        if _lane(n.type) != SHORT or n.type.is_decimal or n.type.name in _DT:
            raise NotPorted(f"date arithmetic with {n.type}")
        const = self.emit(x) & self.emit(n)
        self._push(k1.DTADD, arg)
        return const

    def _emit_date_format(self, e: Call) -> bool:
        """date_format(x, fmt): the day's code in the format's
        dictionary (DFMT), NULL outside the dictionary's span."""
        x, fmt = e.args
        if x.type.name not in _DT:
            raise NotPorted(f"date_format of {x.type}")
        if not isinstance(fmt, Literal) or fmt.value is None:
            raise NotPorted("date_format with a non-literal format")
        date_format_dictionary(fmt.value)  # refuses a time-of-day format now
        const = self.emit(x)
        self._push(k1.DFMT, int(x.type.name == "timestamp"))
        return const

    # -- string functions: a value table over the dictionary ----------------
    def _string_dictionary(self, col: Expr, fn: str) -> Dictionary:
        if col.type.is_raw_string or not col.type.is_string:
            raise NotPorted(f"{fn} over {col.type}")
        d = expr_dictionary(col, self.dictionaries)
        if d is None:
            raise NotPorted(f"{fn} over a string without a dictionary")
        return d

    def _push_value_tables(self, col: Expr, tables, op: int) -> bool:
        """Push VLUT / DVLUT of ``col``'s codes: the value table's slot,
        and the not-null table's slot + 1 ``<< 8`` where there is one."""
        values, not_null = tables
        const = self.emit(col)  # a string literal: code 0 of its own dictionary
        nn = 0 if not_null is None else self._lut_slot(not_null) + 1
        self._push(op, self._lut_slot(values) | nn << 8)
        return const

    def _emit_string_value(self, e: Call) -> bool:
        """The reference's ``_compile_string_lut_fn``: an int64 value per
        dictionary value (VLUT), NULL where the function gives None; a
        NULL literal argument nulls the column."""
        fn = e.fn
        col = e.args[0]
        if fn in ("levenshtein_distance", "hamming_distance") and isinstance(col, Literal):
            col = e.args[1]  # the literal may sit on either side
        d = self._string_dictionary(col, fn)
        if any(isinstance(a, Literal) and a.value is None for a in e.args):
            self._push(k1.NULL)
            return True
        lits = tuple(a.value for a in e.args if isinstance(a, Literal))
        if fn == "length":
            f = len
        elif fn == "strpos":  # 1-based, 0 where the needle is missing
            if not isinstance(e.args[1], Literal):
                raise NotPorted("strpos with a non-literal needle")
            sub = e.args[1].value
            f = lambda v: v.find(sub) + 1
        elif fn == "codepoint":
            f = lambda v: ord(v[0]) if v else None
        elif fn == "json_array_length":
            import json as _json

            def f(v):
                try:
                    got = _json.loads(v)
                except Exception:
                    return None
                return len(got) if isinstance(got, list) else None
        elif fn == "json_size":
            path = e.args[1].value

            def f(v):
                found, got = _json_path_lookup(v, path)
                if not found:
                    return None
                return len(got) if isinstance(got, (dict, list)) else 0
        elif fn == "from_base":
            radix = int(e.args[1].value)

            def f(v):
                try:
                    return int(v, radix)
                except Exception:
                    return None
        elif fn == "date_parse":
            fmt = e.args[1].value
            f = lambda v: mysql_datetime_micros(v, fmt)
        elif fn == "from_iso8601_date":
            f = iso_date_days
        elif fn in ("levenshtein_distance", "hamming_distance"):
            other = e.args[1] if isinstance(e.args[1], Literal) else e.args[0]
            if not isinstance(other, Literal):
                raise NotPorted(f"{fn} of two columns")
            lit = other.value
            if fn == "hamming_distance":
                f = lambda v: sum(a != b for a, b in zip(v, lit)) \
                    if len(v) == len(lit) else None
            else:
                f = lambda v: _levenshtein(v, lit)
        else:  # url_extract_port
            from urllib.parse import urlparse

            def f(v):
                try:
                    return urlparse(v).port
                except Exception:
                    return None
        return self._push_value_tables(col, value_tables(d, (fn,) + lits, f, torch.int64),
                                       k1.VLUT)

    def _emit_string_bool(self, e: Call) -> bool:
        """The reference's ``_compile_string_bool_lut``: regexp_like,
        starts_with, ends_with and is_json_scalar as a boolean table
        (LUT)."""
        fn, col = e.fn, e.args[0]
        d = self._string_dictionary(col, fn)
        if fn != "is_json_scalar" and (not isinstance(e.args[1], Literal)
                                       or e.args[1].value is None):
            raise NotPorted(f"{fn} with a non-literal argument")
        if fn == "regexp_like":
            rx = re.compile(e.args[1].value)
            pred = lambda v: rx.search(v) is not None
        elif fn == "starts_with":
            prefix = e.args[1].value
            pred = lambda v: v.startswith(prefix)
        elif fn == "ends_with":
            suffix = e.args[1].value
            pred = lambda v: v.endswith(suffix)
        else:
            import json as _json

            def pred(v):
                try:
                    return not isinstance(_json.loads(v), (dict, list))
                except Exception:
                    return False
        key = (fn,) + tuple(a.value for a in e.args[1:] if isinstance(a, Literal))
        const = self.emit(col)
        self._push_lut(dictionary_lut(d, key, pred))
        return const

    def _emit_string_number_cast(self, e: Call) -> bool:
        """CAST of a varchar column to bigint (VLUT) or double (DVLUT):
        each dictionary value parsed as the reference's
        ``parse_number_strict`` reads it, NULL where it does not parse."""
        col = e.args[0]
        d = self._string_dictionary(col, e.fn)
        to_double = e.fn == "cast_double"
        return self._push_value_tables(
            col, value_tables(d, ("cast_double" if to_double else "cast_bigint",),
                              lambda v: parse_number_strict(v, to_double),
                              torch.float64 if to_double else torch.int64),
            k1.DVLUT if to_double else k1.VLUT)

    def _emit_binary_hash(self, e: Call) -> bool:
        """crc32 / xxhash64 of ``to_utf8(varchar)``: each dictionary
        value's bytes hashed on the host (VLUT), as the reference's
        ``_compile_binary_hash``."""
        inner = e.args[0]
        if not (isinstance(inner, Call) and inner.fn == "to_utf8"):
            raise NotPorted(f"{e.fn} of {inner}")
        col = inner.args[0]
        d = self._string_dictionary(col, e.fn)
        if e.fn == "crc32":
            import zlib

            f = lambda v: zlib.crc32(v.encode())
        else:
            f = lambda v: xxh64_signed(v.encode())
        return self._push_value_tables(col, value_tables(d, (e.fn,), f, torch.int64), k1.VLUT)

    # -- strings: one table over the dictionary ----------------------------
    def _emit_lut(self, col: Expr, key: tuple, predicate) -> bool:
        """Push ``predicate(value)`` of a dictionary column: its int32
        code indexes a boolean table (clipped as the reference clips),
        and the column's valid bit stays."""
        if col.type.is_raw_string:
            raise NotPorted(f"string predicate over {col}")
        d = expr_dictionary(col, self.dictionaries)
        if d is None:
            raise NotPorted(f"string column {col} without a dictionary")
        self.emit(col)
        self._push_lut(dictionary_lut(d, key, predicate))
        return False

    def _lut_slot(self, table: k1.Lut) -> int:
        if not any(t is table for t in self.luts):
            self.luts.append(table)
        return next(i for i, t in enumerate(self.luts) if t is table)

    def _push_lut(self, table: k1.Lut, op: int = k1.LUT) -> None:
        self._push(op, self._lut_slot(table))

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
        """``x IN (literals)``: over an integer lane the raw value against
        each literal's value, no scale alignment (IN, as the reference);
        over a double lane ``==`` against each literal as a double (DIN; a
        REAL column compares in float32, so each literal rounds to float32
        first), where NaN matches nothing and -0.0 equals 0.0.  The result
        keeps x's valid bit; the literals take a run of the constant
        pool."""
        col, values = e.args[0], e.args[1:]
        lane = _lane(col.type)
        if lane not in (SHORT, DOUBLE):
            raise NotPorted(f"IN over {col.type}")
        number = (int, float, np.integer, np.floating) if lane == DOUBLE else (int, np.integer)
        lits = []
        for v in values:
            if not isinstance(v, Literal) or isinstance(v.value, bool) \
                    or not isinstance(v.value, number):
                raise NotPorted("IN with a value that is not an integer literal" if lane == SHORT
                                else "IN with a value that is not a numeric literal")
            if lane == SHORT:
                lits.append(int(v.value))
            else:
                x = float(np.float32(v.value)) if col.type.name == "real" else float(v.value)
                lits.append(k1.double_bits(x))
        if not lits or len(lits) >= 1 << (31 - k1.IN_COUNT_SHIFT):
            raise NotPorted(f"IN over {len(lits)} literals")
        const = self.emit(col)
        first = len(self.consts)
        if first >= 1 << k1.IN_COUNT_SHIFT:
            raise NotPorted("IN past the constant pool's reach")
        self.consts.extend(lits)
        self._push(k1.IN if lane == SHORT else k1.DIN, first | len(lits) << k1.IN_COUNT_SHIFT)
        return const

    # -- CASE / IF ----------------------------------------------------------
    def _emit_case(self, e: Call) -> bool:
        """``case(w1, t1, ..., else)`` / ``if(c, t, f)``: nested selects
        from the last branch out, so the first true condition wins (the
        reference's ``taken`` rule); NULL conditions are not taken."""
        args = e.args
        out_t = e.type
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
        double, the value itself on an integer and, as the reference's
        only float branch is the double's, on a REAL."""
        (x,) = e.args
        up = e.fn != "floor"
        lane = _lane(x.type)
        if lane in LIMBS:
            raise NotPorted(f"{e.fn} of {x.type}")
        const = self.emit(x)
        if lane == DOUBLE and x.type.name == "double":
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
        if lane in LIMBS or x.type.name == "real":  # the reference rounds a REAL in float32
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
        even (D2S; D2L splits it into limbs for a long decimal, which
        L2D38 widens for a wide one), else the reference's ``_coerce``."""
        x = e.args[0]
        to_t = e.type
        if x.type.name != "double":
            return self._emit_coerced(x, to_t)
        const = self.emit(x)
        m = self._const(k1.double_bits(10.0 ** _scale(to_t)))
        if _lane(to_t) in LIMBS:
            self._push(k1.D2L, m)
            if _lane(to_t) == D38:
                self._push(k1.L2D38)
        else:
            self._push(k1.D2S, m)
        return const

    def _emit_coerced(self, e: Expr, to_t: Type) -> bool:
        """Push ``e`` in ``to_t``'s representation (the reference's
        ``_coerce`` for the integer lanes: up-scaling wraps)."""
        if e.type == to_t or (_lane(e.type) == SHORT and not to_t.is_decimal
                              and not e.type.is_decimal and to_t.name == "bigint"):
            return self.emit(e)
        if to_t.name == "timestamp" and e.type.name == "date":
            return self._emit_ts(e)
        if to_t.name == "real":
            return self._emit_real(e)
        if _lane(to_t) == DOUBLE:
            return self._emit_double(e)
        if to_t.name == "bigint" and _lane(e.type) in LIMBS:
            return self._emit_cast_bigint(Call(type=to_t, fn="cast_bigint", args=(e,)))
        if _lane(to_t) == D38:  # _to_long_limbs(..., limbs=5)
            return self._emit_wide(e, _scale(to_t))
        if _lane(e.type) == D38 and to_t.is_decimal:
            # rescaled in five limbs, then narrowed: to two limbs (the
            # reference keeps five here, under a two-limb type), or to an
            # int64 lane by _narrow_to_int64 (wrapping)
            const = self._emit_wide(e, _scale(to_t))
            self._push(k1.D38NARROW, int(_lane(to_t) == LONG))
            return const
        if _lane(to_t) == LONG and _lane(e.type) in (SHORT, LONG):
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

    def _emit_wide(self, e: Expr, to_scale: int) -> bool:
        """Push a number as five limbs at ``to_scale`` (the reference's
        ``_to_long_limbs(..., limbs=5)``): an integer lane through S2D38,
        two limbs through L2D38, then D38UP (past the limbs' 45 digits
        the carry drops) or D38DOWN (floor division)."""
        lane = _lane(e.type)
        if lane == DOUBLE or not (e.type.is_decimal or e.type.name in (
                "bigint", "integer", "smallint", "tinyint")):
            raise NotPorted(f"coercion of {e.type} to decimal(38,{to_scale})")
        start = len(self.ops)
        const = self.emit(e)
        if lane == SHORT:
            self._push(k1.S2D38)
        elif lane == LONG:
            self._push(k1.L2D38)
        k = to_scale - _scale(e.type)
        if k:
            self._push(k1.D38UP if k > 0 else k1.D38DOWN, abs(k))
        if const:
            self._fold(start)
        return const

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
        self._push({LONG: k1.L2D, D38: k1.D382D}.get(lane, k1.S2D), _scale(e.type))
        if const:
            self._fold(start)
        return const

    def _emit_real(self, e: Expr) -> bool:
        """Push ``e`` as a REAL (the reference's ``_to_double(...)
        .astype(float32)``): a REAL as it is, anything else as a double
        (``_emit_double``) rounded once to float32 (F32R)."""
        if e.type.name == "real":
            return self.emit(e)
        start = len(self.ops)
        const = self._emit_double(e)
        self._push(k1.F32R, k1.F32R_DOUBLE)
        if const:
            self._fold(start)
        return const

    def _emit_cast_real(self, x: Expr) -> bool:
        """cast_real (the reference's ``run_cast_narrow``): a decimal
        through a double (``_to_double``: divided by 10^scale) rounded to
        float32, a double rounded, an integer lane converted straight to
        float32 (``astype(float32)``: F32R of the int64 lane)."""
        if x.type.name in _DT or x.type.name.startswith("interval"):
            raise NotPorted(f"cast_real of {x.type}")
        if x.type.is_decimal or _lane(x.type) != SHORT:
            return self._emit_real(x)
        const = self.emit(x)
        self._push(k1.F32R, k1.F32R_INT)
        return const

    def _emit_cast_narrow(self, e: Call) -> bool:
        """cast_smallint / cast_tinyint (the reference's
        ``run_cast_narrow``): a short decimal floor-divided by 10^scale, a
        long one through cast_bigint's floor, a double or REAL toward zero
        (XLA's saturating conversion), then NULL where the int64 value does
        not fit the narrower type (CASTN), never a wrapped value."""
        (x,) = e.args
        if x.type.name in _DT or x.type.name.startswith("interval"):
            raise NotPorted(f"{e.fn} of {x.type}")
        lane = _lane(x.type)
        if lane == LONG and _scale(x.type) > 18:
            raise NotPorted(f"{e.fn} of {x.type}")
        const = self.emit(x)
        if lane == DOUBLE:
            self._push(k1.CASTBI, k1.CAST_FROM_DOUBLE)
        elif lane == LONG:
            self._push(k1.CASTBI, k1.CAST_FROM_LONG | _scale(x.type) << 2)
        elif lane == D38:
            self._push_d38_int64(_scale(x.type))
        elif _scale(x.type):
            self._push(k1.SFLOOR, self._const(10 ** _scale(x.type)) * 2)
        self._push(k1.CASTN, _NARROW_BITS[_storage_kind(e.type)])
        return const

    def _emit_sign(self, e: Call) -> bool:
        """``neg`` / ``abs``: a double's sign (DNEG, DABS), or an integer
        lane's, NULL where the lane's least value has no negation (the
        reference's ``_ovf_neg``, at int32 width for an int32 lane)."""
        (x,) = e.args
        if e.fn == "neg" and x.type.name == "boolean":
            raise TypeError("neg does not accept a boolean (the reference's jnp negation)")
        lane = _lane(x.type)
        if lane == LONG:
            raise NotPorted(f"{e.fn} of {x.type}")
        const = self.emit(x)
        if lane == D38:  # decimal128.neg, or the reference's run_labs
            if e.fn == "neg":
                self._push(k1.D38NEG)
            else:
                self._push(k1.D38SIGN, 0)
        elif lane == DOUBLE:
            self._push(k1.DNEG if e.fn == "neg" else k1.DABS)
        else:  # an integer lane; an int16 or int8 one NULL past its range (CASTN)
            kind = _storage_kind(x.type)
            self._push(k1.NEG if e.fn == "neg" else k1.ABS, int(kind == k1.KIND_I32))
            if kind in (k1.KIND_I16, k1.KIND_I8):
                self._push(k1.CASTN, _NARROW_BITS[kind])
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
        if D38 in (_lane(a.type), _lane(b.type)):  # both sides as five limbs (D38CMP)
            const = self._emit_wide(a, s) & self._emit_wide(b, s)
            self._push(k1.D38CMP, LCMP_OPS.index(e.fn))
            return const
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
        if tr.name == "real":  # both sides as float32, the op in double, rounded once
            const = self._emit_real(a) & self._emit_real(b)
            if e.fn == "mod":
                self._push(k1.DBIN, k1.DBIN_FNS.index("mod"))
            else:
                self._push({"add": k1.DADD, "sub": k1.DSUB, "mul": k1.DMUL,
                            "div": k1.DDIV}[e.fn])
            self._push(k1.F32R, k1.F32R_DOUBLE)
            return const
        if tr.name == "double":
            const = self._emit_double(a) & self._emit_double(b)
            if e.fn == "mod":  # jnp.mod: floored (the reference's fault, ROADMAP C)
                self._push(k1.DBIN, k1.DBIN_FNS.index("mod"))
            else:
                self._push({"add": k1.DADD, "sub": k1.DSUB, "mul": k1.DMUL,
                            "div": k1.DDIV}[e.fn])
            return const
        lanes = (_lane(a.type), _lane(b.type))
        if tr.is_long_decimal and e.fn in ("add", "sub") and DOUBLE not in lanes:
            # both sides as limbs at the result's scale, then decimal128.add/sub
            const = self._emit_coerced(a, tr) & self._emit_coerced(b, tr)
            self._push(k1.D38ADD if _lane(tr) == D38 else k1.LADD, int(e.fn == "sub"))
            return const
        if tr.is_long_decimal:
            if e.fn == "mul" and all(x in LIMBS for x in lanes):
                # the reference's refusal (a product past 38 digits)
                raise NotPorted("long-decimal x long-decimal mul unsupported")
            if e.fn == "mul" and _lane(tr) == D38 and sorted(lanes) == [D38, SHORT]:
                # wide x int64 on magnitudes (decimal128.mul_wide_small)
                const = self.emit(a) & self.emit(b)
                self._push(k1.D38MUL, 0 if lanes[0] == D38 else 1)
                return const
            if e.fn != "mul" or sorted(lanes) != [LONG, SHORT] or _lane(tr) != LONG:
                raise NotPorted(f"{e.fn} of {a.type} and {b.type} producing {tr}")
            self.emit(a)
            self.emit(b)
            self._push(k1.MUL_LS, 0 if lanes[0] == LONG else 1)
            return False
        if lanes != (SHORT, SHORT) or (e.fn == "div" and tr.is_decimal):
            raise NotPorted(f"{e.fn} producing {tr}")
        width = 64
        if tr.is_decimal:
            if e.fn == "mul":  # scale sa + sb == tr.scale, no rescale
                const = self.emit(a) & self.emit(b)
            else:
                const = (self._emit_scaled(a, tr.scale or 0, check=True)
                         & self._emit_scaled(b, tr.scale or 0, check=True))
        else:
            # integer or interval arithmetic at the width jnp promotes the
            # operands to: an int64 one wraps-to-NULL in ADD/SUB/MUL, a
            # narrower one runs exactly in the int64 lane and is NULL where
            # it leaves its width (CASTN), as the reference's _ovf_* rules
            width = self._int_width(a.type, b.type, tr)
            const = self.emit(a) & self.emit(b)
        if e.fn in ("mod", "div"):  # _trunc_mod / _trunc_div, NULL on a zero divisor
            # each operand's abs at its own width and the result wrapped
            # at the wider one, as jnp computes them
            codes = [0, 0] if tr.is_decimal else [
                k1.IMOD_WIDTHS.index(8 * np.dtype(t.np_dtype).itemsize) for t in (a.type, b.type)]
            self._push(k1.IMOD, int(e.fn == "div") | codes[0] << 1 | codes[1] << 3)
            return const
        self._push({"add": k1.ADD, "sub": k1.SUB, "mul": k1.MUL}[e.fn])
        if not tr.is_decimal and width < 64:
            self._push(k1.CASTN, width)
        return const

    @staticmethod
    def _int_width(ta: Type, tb: Type, tr: Type) -> int:
        """The bits of an integer result: the wider operand's storage, as
        jnp promotes (an interval, a date or a timestamp is its integer
        lane)."""
        interval = tr.name.startswith("interval")
        for t in (ta, tb):
            if t.is_decimal or _lane(t) != SHORT or t.name == "boolean":
                raise NotPorted(f"arithmetic producing {tr} over {t}")
        width = 8 * max(np.dtype(ta.np_dtype).itemsize, np.dtype(tb.np_dtype).itemsize)
        if not (interval or tr.name in ("bigint", "integer", "smallint", "tinyint")) \
                or 8 * np.dtype(tr.np_dtype).itemsize != width:
            raise NotPorted(f"arithmetic producing {tr}")
        return width

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
            elif op in (k1.IN, k1.DIN):
                first, count = args[i] & ((1 << k1.IN_COUNT_SHIFT) - 1), \
                    args[i] >> k1.IN_COUNT_SHIFT
                args[i] = len(consts) | count << k1.IN_COUNT_SHIFT
                consts.extend(self.consts[first:first + count])
            elif op in k1.LIMB_RUNS:  # a literal's limbs stay one run
                first = args[i]
                args[i] = len(consts)
                consts.extend(self.consts[first:first + k1.LIMB_RUNS[op]])
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
        if involves_containers(expr) or involves_raw(expr):
            return None
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
        if involves_contains(expr):
            return GeoCompiler(self).scalar(expr)
        if involves_raw(expr):
            if involves_containers(expr):
                raise NotPorted(f"raw varchar values inside containers: {expr}")
            return RawCompiler(self).any(expr)
        if involves_containers(expr):
            return ContainerCompiler(self).any(expr)
        prog, columns = self.lower(expr)
        return self.run_program(prog, columns)

    @staticmethod
    def run_program(prog: k1.Program, columns: List[int]) -> CompiledExpr:
        """``page -> (data, valid)`` of a lowered program over the page
        columns it loads: one K1 launch, or a constant's value computed
        once on the host and expanded on the page's device."""
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
    if involves_contains(expr):
        return GeoCompiler(c).filter(expr)
    if involves_raw(expr):
        if involves_containers(expr):
            raise NotPorted(f"raw varchar values inside containers: {expr}")
        return RawCompiler(c).filter(expr)
    if involves_containers(expr):
        return ContainerCompiler(c).filter(expr)
    prog, columns = c.lower(expr)
    if prog.n_cols == 0:
        keep = prog.ops[0] == k1.LIT and prog.consts[prog.args[0]] != 0
        return lambda page: page.row_mask & keep

    def run(page):
        cols = [(page.blocks[i].data, page.blocks[i].valid) for i in columns]
        return k1.expr_eval(prog, cols, page.capacity, row_mask=page.row_mask)

    return run
