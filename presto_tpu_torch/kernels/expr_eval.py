"""K1 ``expr_eval``: one kernel that interprets a lowered expression.

``expr/compile.py`` lowers an expression tree on the host into a short
postfix :class:`Program` over a stack of ``(value, valid)`` pairs.
:func:`expr_eval` runs it: on a CUDA tensor it launches
``csrc/expr_eval.cu`` (one thread per row), on a CPU tensor it runs
:func:`expr_eval_plain`, which evaluates the same program with
whole-tensor torch ops.  Both follow the reference's rules
(``presto_tpu/expr/compile.py``): SQL three-valued logic, an int64
add/sub/mul or decimal up-scale that wraps turns its lane NULL, a
string predicate reads a boolean table over the column's dictionary,
``x IN (literals)`` compares the raw value with each literal, CASE takes
the first true branch, and a double division by zero is NULL.  CANON
maps a dictionary code to the representative code of its value (the
reference's ``canonicalize_codes``, for key columns whose dictionary
repeats a value).  DATEPART takes the year, month, day or quarter of
a date (``_civil_from_days``, floor division throughout); S2D turns an
int64 lane into a double divided by 10^scale; S2L and LSCALE bring a
short or long decimal to two limbs at a larger scale (wrapping as
``decimal128.rescale`` does) and LCMP compares two limb pairs;
NOTNULL is IS NULL / IS NOT NULL, never NULL itself.  LOAD_F64 and
DLIT push a double column or constant (its bits); DADD, DSUB, DMUL,
DNEG and DABS compute in double with the card's round-to-nearest
intrinsics; DCMP compares two doubles (NaN compares false, except
``ne``); NEG and ABS negate an integer lane, NULL where its width's
least value has no negation (the reference's ``_ovf_neg``).  COAL keeps
the first valid of two operands; SFLOOR floor-divides by 10^k (a
ceiling adds 10^k - 1 first); SROUND rounds a decimal half away from
zero; DFLOOR and DROUND floor/ceil and round a double (half away from
zero at 10^digits); D2S and D2L cast a double to a short or long
decimal (``round(d * 10^scale)``, half to even as ``jnp.round``);
LADD adds or subtracts two long decimals.

The function surface (eighth slice) comes as a few family opcodes
whose argument picks the function: DUN, a function of one double
(``DUN_FNS``: sqrt, cbrt, exp, ln, log2, log10, the trigonometric and
hyperbolic functions, degrees, radians, truncate, and sign and the
NaN/infinity tests, which give an integer lane); DBIN, of two doubles
(power, atan2, and ``mod``, floored as ``jnp.mod``, NULL on a zero
divisor); BITW, and/or/xor, a shift (by the count & 63, Java's rule)
or a bit count of the low ``bits`` bits; GL, greatest/least over an
integer, double (NaN wins, -0.0 below 0.0) or long lane; NULLIF (its
operand and the pair's equality); CASTBI, cast to bigint from a double
(toward zero, saturating, NaN to 0: XLA's conversion), a short decimal
(HALF_UP) or a long one (floor); HLL, splitmix64 of the lane's 64 bits
(with the golden-ratio increment in mode 1) and the HLL bucket or rho; WBUCKET, width_bucket; IMOD, SQL's
truncating int64 mod or div.  DATEPART also gives day_of_week,
day_of_year, ISO week, year_of_week and last_day_of_month.

The narrow scalar types (eleventh slice): a SMALLINT (int16) or
TINYINT (int8) column loads sign-extended into the int64 lane and a
REAL (float32) widens exactly into the double lane; an output of
those kinds stores narrowed.  F32R rounds the double lane once to
float32 and widens it back (or converts the int64 lane straight to
float32): a REAL operation runs in double and rounds once, which for
``+ - * /`` and the floored mod of two float32 values is the float32
result (53 >= 2 * 24 + 2).  CASTN NULLs an int64 lane outside a
narrower signed range (the narrowing casts, int16/int32 arithmetic);
DIN is IN over a double lane (``==``: NaN matches nothing, -0.0 equals
0.0).  IMOD takes each operand's ``abs`` at its own width and wraps its
result at the wider one, as the reference's jnp does.

The wide decimals (thirteenth slice): a decimal(37..38) value is five
base-10^9 limbs (the D38 lane, ``ops/decimal128.py``).  LOAD_D38 and
LIT_D38 push a column or a literal's five constants (LIT_LONG a two-limb
literal's two), S2D38 and L2D38 bring an int64 lane or two limbs to
five (``from_int64``, ``widen``), D38UP and D38DOWN rescale (up in steps
of 10^8 on the magnitude, dropping the top carry; down by floor
division in steps of 10^9), D38ADD, D38NEG and D38MUL add, subtract,
negate (``_norm_wide``'s floor carries) and multiply by an int64 lane
(``mul_wide_small``), D38CMP compares limb by limb, D382D gives the
double (Horner's rule from limb 0, then one division), D38NARROW an
int64 lane (wrapping) or two limbs, D38SIGN abs or sign.

A stack value is an int64 lane (integers, dates, booleans, short
decimals, dictionary codes), a double, a long decimal (two base-10^18
limbs) or a wide one (five base-10^9 limbs).  A program that holds a
long or double lane is "wide" and runs on a second instantiation of
the interpreter whose stack slots carry the second limb; a program
that holds a D38 lane runs on a third, whose slots carry five limbs;
every other program keeps the narrow int64 stack.  A CUDA tensor
meeting an opcode the kernel lacks raises (the C entry refuses it);
nothing falls back.
"""

from __future__ import annotations

import ctypes
import dataclasses
import struct
from typing import Optional, Sequence, Tuple

import torch

from presto_tpu_torch.kernels import build
from presto_tpu_torch.ops import decimal128 as d128

# opcodes: keep in step with csrc/expr_eval.cu
LOAD, LIT, NULL, ADD, SUB, MUL, SCALE_CHK, SCALE, EQ, NE, LT, LE, GT, GE, \
    BETWEEN, AND, OR, NOT, LUT, SEL, LOAD_LONG, MUL_LS, L2D, DDIV, IN, CANON, \
    DATEPART, S2D, S2L, LSCALE, LCMP, NOTNULL, LOAD_F64, DLIT, DADD, DSUB, DMUL, \
    DNEG, DABS, DCMP, NEG, ABS, COAL, SFLOOR, SROUND, DFLOOR, DROUND, D2S, D2L, LADD, \
    DUN, DBIN, BITW, GL, NULLIF, CASTBI, HLL, WBUCKET, IMOD, VLUT, DVLUT, TSPART, DTRUNC, \
    DTADD, DTDIFF, CASTTS, UNIXT, DFMT, F32R, CASTN, DIN, LOAD_D38, LIT_LONG, LIT_D38, \
    S2D38, L2D38, D38UP, D38DOWN, D38ADD, D38NEG, D38MUL, D38CMP, D382D, D38NARROW, \
    D38SIGN = range(85)
OP_NAMES = ("load", "lit", "null", "add", "sub", "mul", "scale_chk", "scale",
            "eq", "ne", "lt", "le", "gt", "ge", "between", "and", "or", "not",
            "lut", "sel", "load_long", "mul_ls", "l2d", "ddiv", "in", "canon",
            "datepart", "s2d", "s2l", "lscale", "lcmp", "notnull", "load_f64", "dlit",
            "dadd", "dsub", "dmul", "dneg", "dabs", "dcmp", "neg", "abs", "coalesce",
            "sfloor", "sround", "dfloor", "dround", "d2s", "d2l", "ladd",
            "dun", "dbin", "bitw", "gl", "nullif", "castbi", "hll", "wbucket", "imod",
            "vlut", "dvlut", "tspart", "dtrunc", "dtadd", "dtdiff", "castts", "unixt", "dfmt",
            "f32r", "castn", "din", "load_d38", "lit_long", "lit_d38", "s2d38", "l2d38",
            "d38up", "d38down", "d38add", "d38neg", "d38mul", "d38cmp", "d382d", "d38narrow",
            "d38sign")
# stack effect of each opcode (pushes minus pops)
STACK_EFFECT = (1, 1, 1, -1, -1, -1, 0, 0, -1, -1, -1, -1, -1, -1, -2, -1, -1, 0,
                0, -2, 1, -1, 0, -1, 0, 0, 0, 0, 0, 0, -1, 0, 1, 1, -1, -1, -1,
                0, 0, -1, 0, 0, -1, 0, 0, 0, 0, 0, 0, -1,
                0, -1, -1, -1, -1, 0, 0, -3, -1,
                0, 0, 0, 0, -1, -1, 0, 0, 0,
                0, 0, 0,
                1, 1, 1, 0, 0, 0, 0, -1, 0, -1, -1, 0, 0, 0)
# opcodes whose argument is printed: a column slot, a constant index,
# a table slot, the long operand's side (MUL_LS), a decimal scale
# (L2D, S2D), IN's literal run (first constant | count <<
# IN_COUNT_SHIFT), the date part (DATEPART: year, month, day,
# quarter, day_of_week, day_of_year, week, year_of_week,
# last_day_of_month), the digits of an up-scale (LSCALE), the comparison (LCMP:
# eq, ne, lt, le, gt, ge; DCMP the same), the test (NOTNULL: 0 not_null,
# 1 is_null), a double constant's bits (DLIT: a constant index) or the
# integer lane's width (NEG, ABS: 1 for int32, whose least value has no
# negation there, 0 for int64), a divisor's constant index times two
# plus 1 for a ceiling (SFLOOR), a divisor's constant index (SROUND),
# 0 floor or 1 ceil (DFLOOR), or the constant index of a double
# multiplier's bits (DROUND: 10^digits; D2S, D2L: 10^scale), or 0 add
# and 1 subtract (LADD, two long decimals at one scale); the function
# of a family opcode: DUN's (DUN_FNS), DBIN's (DBIN_FNS), BITW's
# operation (BITW_OPS) plus its width ``bits << 4`` (64: none), GL's
# 0 least or 1 greatest plus its lane ``<< 1`` (GL_INT, GL_DOUBLE,
# GL_LONG), CASTBI's source (CAST_FROM_DOUBLE, CAST_FROM_SHORT,
# CAST_FROM_LONG) plus its decimal scale ``<< 2``, HLL's 0 bucket or 1
# rho plus its register-index width ``P << 1`` (P = 0: the whole
# splitmix64 hash, checksum's), IMOD's 0 mod or 1 div plus its
# operands' widths (IMOD_WIDTHS codes ``<< 1`` and ``<< 3``); the date,
# time and dictionary-table opcodes: VLUT's and DVLUT's value table slot plus ``(not-null table
# slot + 1) << 8`` (0: none), TSPART's part (TS_PARTS), DTRUNC's,
# DTADD's and DTDIFF's unit (DT_UNITS) plus the lane flags ``<< 4``
# (DT_TS: a timestamp; DTDIFF: DT_A_DATE, DT_B_DATE), CASTTS's
# direction (0 date to timestamp, 1 timestamp to date), UNIXT's mode
# (UNIXT_TS, UNIXT_DATE, UNIXT_FROM), DFMT's 1 for a timestamp; the
# narrow types: F32R's source (F32R_DOUBLE: the double lane rounded to
# float32, F32R_INT: the int64 lane converted to float32, each widened
# back into the double lane), CASTN's width in bits (8, 16 or 32: NULL
# where the int64 lane lies outside that signed range), DIN's literal
# run as IN's (doubles' bits); the wide decimals: LOAD_D38's column
# slot, LIT_LONG's and LIT_D38's first constant (a run of two or five
# limbs), the digits of D38UP (an up-scale in steps of at most 8 that
# drops the top carry) and D38DOWN (a floor down-scale in steps of at
# most 9), D38ADD's 0 add or 1 subtract, D38MUL's side (MUL_LS's), the
# comparison of D38CMP (LCMP's), D382D's decimal scale, D38NARROW's
# target (0 an int64 lane, 1 two limbs) and D38SIGN's function (0 abs,
# 1 sign)
_ARG_OPS = (LOAD, LIT, SCALE_CHK, SCALE, LUT, LOAD_LONG, MUL_LS, L2D, IN, CANON,
            DATEPART, S2D, LSCALE, LCMP, NOTNULL, LOAD_F64, DLIT, DCMP, NEG, ABS,
            SFLOOR, SROUND, DFLOOR, DROUND, D2S, D2L, LADD, DUN, DBIN, BITW, GL, CASTBI,
            HLL, IMOD, VLUT, DVLUT, TSPART, DTRUNC, DTADD, DTDIFF, CASTTS, UNIXT, DFMT, F32R,
            CASTN, DIN, LOAD_D38, LIT_LONG, LIT_D38, D38UP, D38DOWN, D38ADD, D38MUL, D38CMP,
            D382D, D38NARROW, D38SIGN)
# opcodes whose argument holds a constant index (SFLOOR: times two)
CONST_ARG_OPS = (LIT, SCALE_CHK, SCALE, DLIT, SROUND, DROUND, D2S, D2L)
# opcodes whose argument is the first of a run of constants: a long
# literal's two limbs, a wide one's five
LIMB_RUNS = {LIT_LONG: 2, LIT_D38: 5}
IN_COUNT_SHIFT = 8
# opcodes only the wide interpreter runs
DOUBLE_OPS = frozenset((LOAD_F64, DLIT, DADD, DSUB, DMUL, DNEG, DABS, DCMP, DFLOOR,
                        DROUND, D2S, D2L, DUN, DBIN, WBUCKET, DVLUT, UNIXT, F32R, DIN))
WIDE_OPS = frozenset((LOAD_LONG, MUL_LS, L2D, DDIV, S2D, S2L, LSCALE, LCMP, D2L,
                      LADD, LIT_LONG)) | DOUBLE_OPS
# opcodes only the five-limb (D38) interpreter runs: a program holding
# one runs there, every other program keeps its narrower stack
D38_OPS = frozenset((LOAD_D38, LIT_D38, S2D38, L2D38, D38UP, D38DOWN, D38ADD, D38NEG, D38MUL,
                     D38CMP, D382D, D38NARROW, D38SIGN))

# fixed limits of the kernel's by-value program (csrc/expr_eval.cu)
MAX_INS = 128
MAX_CONSTS = 64
MAX_COLS = 16
MAX_STACK = 16
MAX_LUTS = 16

# DUN's functions of one double, by argument: the transcendental ones
# (TRANSCENDENTAL: libdevice on the card, torch's CPU kernels in the
# twin, XLA's in the reference, so they agree within a few ulp), the
# correctly rounded or exact ones, and those giving an integer lane
# (sign) or a boolean (the tests)
DUN_FNS = ("sqrt", "cbrt", "exp", "ln", "log2", "log10", "sin", "cos", "tan", "asin",
           "acos", "atan", "sinh", "cosh", "tanh", "degrees", "radians", "truncate",
           "sign", "is_nan", "is_finite", "is_infinite")
DUN_INT = frozenset(DUN_FNS.index(f) for f in ("sign", "is_nan", "is_finite", "is_infinite"))
TRANSCENDENTAL = frozenset(DUN_FNS.index(f) for f in (
    "cbrt", "exp", "ln", "log2", "log10", "sin", "cos", "tan", "asin", "acos", "atan",
    "sinh", "cosh", "tanh"))
# DBIN's functions of two doubles: power and atan2 (transcendental) and
# the floor ``mod`` of jnp.mod (NULL on a zero divisor)
DBIN_FNS = ("power", "atan2", "mod")
BITW_OPS = ("and", "or", "xor", "shift_left", "shift_right", "bit_count")
GL_INT, GL_DOUBLE, GL_LONG, GL_D38 = 0, 1, 2, 3
# IMOD's operand widths by their two-bit codes (arg bits 1-2 and 3-4)
IMOD_WIDTHS = (64, 32, 16, 8)
CAST_FROM_DOUBLE, CAST_FROM_SHORT, CAST_FROM_LONG = 0, 1, 2

# dates and timestamps: dates are int32 epoch days, timestamps int64 epoch
# microseconds (the reference's types.py MICROS_PER_DAY)
MICROS_PER_DAY = 86_400_000_000
# TSPART's parts: DATEPART's, then the time of day (over a date those
# four are 0, as the reference's _compile_datepart)
TS_PARTS = ("year", "month", "day", "quarter", "day_of_week", "day_of_year", "week",
            "year_of_week", "last_day_of_month", "hour", "minute", "second", "millisecond")
# DTRUNC's, DTADD's and DTDIFF's units; the first seven are fixed spans
# of microseconds (UNIT_MICROS), the last three calendar months
DT_UNITS = ("microsecond", "millisecond", "second", "minute", "hour", "day", "week",
            "month", "quarter", "year")
UNIT_MICROS = (1, 1_000, 1_000_000, 60_000_000, 3_600_000_000, MICROS_PER_DAY,
               7 * MICROS_PER_DAY)
DT_TS, DT_A_DATE, DT_B_DATE = 1 << 4, 1 << 4, 1 << 5
UNIXT_TS, UNIXT_DATE, UNIXT_FROM = 0, 1, 2
# date_format's dictionary: one formatted string per day from 1900-01-01
# (the reference's ExprCompiler.DATE_FMT_BASE / DATE_FMT_SPAN)
DATE_FMT_BASE = -25567
DATE_FMT_SPAN = 73049

# storage kinds of loaded columns and of the output: a SMALLINT
# (int16) or TINYINT (int8) loads sign-extended into the int64 lane, a
# REAL (float32) widens exactly into the double lane; each stores back
# narrowed
KIND_BOOL, KIND_I32, KIND_I64, KIND_F64, KIND_D128, KIND_I16, KIND_I8, KIND_F32, \
    KIND_D38 = range(9)
_LIMBS_OF = {KIND_D128: 2, KIND_D38: 5}
_KIND_OF = {torch.bool: KIND_BOOL, torch.int32: KIND_I32, torch.int64: KIND_I64,
            torch.int16: KIND_I16, torch.int8: KIND_I8}
_DTYPE_OF = {KIND_BOOL: torch.bool, KIND_I32: torch.int32, KIND_I64: torch.int64,
             KIND_F64: torch.float64, KIND_I16: torch.int16, KIND_I8: torch.int8,
             KIND_F32: torch.float32}
_FLOAT_KINDS = (KIND_F64, KIND_F32)
F32R_DOUBLE, F32R_INT = 0, 1

_I64_MAX = (1 << 63) - 1
_I64_MIN = -(1 << 63)

launches = 0
#: launches of programs that test ``IN`` (the IN opcode, or a table
#: built for IN over a dictionary)
in_launches = 0
#: launches of programs holding each of these opcodes, by name
op_launches: dict = {}
#: launches of programs holding any double opcode of DOUBLE_OPS
double_launches = 0
COUNTED_OPS = {DATEPART: "year", S2D: "s2d", LCMP: "lcmp", NOTNULL: "not_null",
               LOAD_F64: "load_f64", DLIT: "dlit", DADD: "dadd", DSUB: "dsub",
               DMUL: "dmul", DNEG: "dneg", DABS: "dabs", DCMP: "dcmp", NEG: "neg",
               ABS: "abs", COAL: "coalesce", SFLOOR: "floor", DFLOOR: "floor",
               SROUND: "round", DROUND: "round", D2S: "cast_decimal", D2L: "cast_decimal",
               LADD: "ladd", DUN: "dun", DBIN: "dbin", BITW: "bitw", GL: "gl",
               NULLIF: "nullif", CASTBI: "castbi", HLL: "hll", WBUCKET: "wbucket",
               IMOD: "imod", VLUT: "vlut", DVLUT: "dvlut", TSPART: "tspart",
               DTRUNC: "dtrunc", DTADD: "dtadd", DTDIFF: "dtdiff", CASTTS: "castts",
               UNIXT: "unixt", DFMT: "dfmt", F32R: "f32r", CASTN: "castn", DIN: "din",
               LIT_D38: "lit_d38", S2D38: "s2d38", D38UP: "d38up",
               D38DOWN: "d38down", D38ADD: "d38add", D38NEG: "d38neg", D38MUL: "d38mul",
               D38CMP: "d38cmp", D382D: "d382d", D38NARROW: "d38narrow", D38SIGN: "d38sign"}
#: table kinds counted by name: a string CASE/IF/coalesce's branch
#: codes remapped into the merged dictionary, the two sides of a
#: string-column comparison mapped to shared value ids, and a varchar
#: min/max's collation ranks (or their codes back)
COUNTED_TABLES = ("remap", "string_eq", "collation")

_I32_MIN = -(1 << 31)


def double_bits(x: float) -> int:
    """The IEEE-754 bits of a double as a signed int64 (DLIT's constant)."""
    return struct.unpack("<q", struct.pack("<d", float(x)))[0]


def bits_double(b: int) -> float:
    return struct.unpack("<d", struct.pack("<q", int(b)))[0]


class Lut:
    """The operand of LUT (a boolean table), CANON (an int32 table),
    VLUT (an int64 table) or DVLUT (a double table), indexed by a
    dictionary's codes, with its copy on each device it has been read
    on."""

    __slots__ = ("values", "dtype", "kind", "_copies")

    def __init__(self, values: Sequence, dtype: torch.dtype = torch.bool, kind: str = ""):
        self.dtype = dtype
        self.kind = kind  # what the table tests ("like", "in", "canon", a comparison)
        conv = bool if dtype == torch.bool else float if dtype == torch.float64 else int
        self.values = tuple(conv(v) for v in values)
        self._copies: dict = {}

    def on(self, device) -> torch.Tensor:
        t = self._copies.get(str(device))
        if t is None:
            t = self._copies[str(device)] = torch.tensor(self.values, dtype=self.dtype,
                                                         device=device)
        return t


@dataclasses.dataclass(frozen=True)
class Program:
    """A lowered expression: ``ops``/``args`` in postfix order, the
    int64 constant pool, the boolean tables of LUT, and the output
    storage kind.  ``args`` of a LOAD or LOAD_LONG is a column slot
    (index into the columns handed to :func:`expr_eval`); of LIT,
    SCALE_CHK and SCALE a constant index; of LUT and CANON a table
    slot; of MUL_LS 0 when the long operand is below the short one on
    the stack, 1 when above; of L2D the operand's decimal scale; of IN
    the first of its literals in the constant pool, plus their count
    shifted by ``IN_COUNT_SHIFT``.  ``luts`` holds the tables of LUT
    (bool) and CANON (int32)."""

    ops: Tuple[int, ...]
    args: Tuple[int, ...]
    consts: Tuple[int, ...]
    n_cols: int
    out_kind: int
    luts: Tuple[Lut, ...] = ()

    @property
    def wide(self) -> bool:
        return self.limbs > 1

    @property
    def limbs(self) -> int:
        """The interpreter instance the program runs on: 5 with a D38
        opcode, 2 with a long or double one, else 1."""
        if any(op in D38_OPS for op in self.ops):
            return 5
        return 2 if any(op in WIDE_OPS for op in self.ops) else 1

    @property
    def depth(self) -> int:
        d = best = 0
        for op in self.ops:
            d += STACK_EFFECT[op]
            best = max(best, d)
        return best

    def __repr__(self) -> str:
        body = " ".join(f"{OP_NAMES[o]}({a})" if o in _ARG_OPS
                        else OP_NAMES[o] for o, a in zip(self.ops, self.args))
        return f"Program[{body}; consts={list(self.consts)}]"


def _ovf_mul(a, b, r):
    """True overflow of the wrapped product ``r = a * b`` (the
    reference's ``_ovf_mul``), written so no division can trap: a == 0
    never overflows and a == -1 overflows only for b == INT64_MIN."""
    special = (a == 0) | (a == -1)
    den = torch.where(special, torch.ones_like(a), a)
    q = torch.div(r, den, rounding_mode="floor")
    exact = (r - q * den == 0) & (q == b)
    return torch.where(special, (a == -1) & (b == _I64_MIN), ~exact)


def _fdiv(a, b):
    return torch.div(a, b, rounding_mode="floor")


def civil_from_days(z: torch.Tensor):
    """Epoch days -> (year, month, day) with floor division throughout
    (the reference's ``_civil_from_days``, Howard Hinnant's
    algorithm)."""
    z = z + 719468
    era = _fdiv(torch.where(z >= 0, z, z - 146096), 146097)
    doe = z - era * 146097
    yoe = _fdiv(doe - _fdiv(doe, 1460) + _fdiv(doe, 36524) - _fdiv(doe, 146096), 365)
    y = yoe + era * 400
    doy = doe - (365 * yoe + _fdiv(yoe, 4) - _fdiv(yoe, 100))
    mp = _fdiv(5 * doy + 2, 153)
    d = doy - _fdiv(153 * mp + 2, 5) + 1
    m = torch.where(mp < 10, mp + 3, mp - 9)
    return torch.where(m <= 2, y + 1, y), m, d


def days_from_civil(y: torch.Tensor, m: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    """(year, month, day) -> epoch days, the inverse of
    :func:`civil_from_days` (the reference's ``_days_from_civil``)."""
    y = y - (m <= 2).to(y.dtype)
    era = _fdiv(torch.where(y >= 0, y, y - 399), 400)
    yoe = y - era * 400
    mp = torch.where(m > 2, m - 3, m + 9)
    doy = _fdiv(153 * mp + 2, 5) + d - 1
    doe = yoe * 365 + _fdiv(yoe, 4) - _fdiv(yoe, 100) + doy
    return era * 146097 + doe - 719468


def date_part(days: torch.Tensor, part: int) -> torch.Tensor:
    """DATEPART's plain form (``DATE_PARTS`` of ``expr/compile.py``):
    year, month, day, quarter, ISO day_of_week (Monday 1), day_of_year,
    ISO week and year_of_week (the week holding the date's Thursday
    belongs to that Thursday's year), last_day_of_month (epoch days)."""
    if part >= len(TS_PARTS) - 4:  # hour, minute, second, millisecond of a date
        return torch.zeros_like(days)
    y, m, d = civil_from_days(days)
    one = torch.ones_like(m)
    if part < 4:
        return (y, m, d, _fdiv(m - 1, 3) + 1)[part]
    if part == 4:
        return torch.remainder(days + 3, 7) + 1
    if part == 5:
        return days - days_from_civil(y, one, one) + 1
    if part in (6, 7):
        th = days - torch.remainder(days + 3, 7) + 3
        y_th = civil_from_days(th)[0]
        return _fdiv(th - days_from_civil(y_th, one, one), 7) + 1 if part == 6 else y_th
    dec = m == 12
    return days_from_civil(torch.where(dec, y + 1, y), torch.where(dec, one, m + 1), one) - 1


def lsr(x: torch.Tensor, s) -> torch.Tensor:
    """Logical right shift of int64 lanes by ``s`` (an int or a tensor
    in 0..63): torch has no unsigned 64-bit type, so the sign bits the
    arithmetic shift brings in are masked off."""
    if isinstance(s, int):
        return x if s == 0 else (x >> s) & ((1 << (64 - s)) - 1)
    s1 = torch.where(s == 0, torch.ones_like(s), s)
    return torch.where(s == 0, x, (x >> s1) & ((torch.ones_like(s1) << (64 - s1)) - 1))


def popcount(x: torch.Tensor) -> torch.Tensor:
    """Set bits of each int64 lane (SWAR, wrapping multiplies)."""
    x = x - (lsr(x, 1) & 0x5555555555555555)
    x = (x & 0x3333333333333333) + (lsr(x, 2) & 0x3333333333333333)
    x = (x + lsr(x, 4)) & 0x0F0F0F0F0F0F0F0F
    return lsr(x * 0x0101010101010101, 56)


def _s64(u: int) -> int:
    return u - (1 << 64) if u >= 1 << 63 else u


def mix_u64(x: torch.Tensor) -> torch.Tensor:
    """splitmix64's finalizer over int64 lanes read as uint64 (the
    reference's ``_mix_u64``); int64 multiplies wrap as uint64's do."""
    x = (x ^ lsr(x, 30)) * _s64(0xBF58476D1CE4E5B9)
    x = (x ^ lsr(x, 27)) * _s64(0x94D049BB133111EB)
    return x ^ lsr(x, 31)


def hll_from_lane(lane: torch.Tensor, rho: bool, p: int) -> torch.Tensor:
    """HLL's bucket (the hash's top ``p`` bits) or rho (the leading
    zeros of the rest, a sentinel bit capping them, plus one) of int64
    lanes (the reference's ``_hll_from_hash`` over ``_mix_u64``); with
    ``p == 0`` the whole hash (checksum's ``_mix64``), or with ``rho`` set
    too splitmix64 with its golden-ratio increment first
    (make_set_digest's ``mix64``)."""
    if p == 0:
        return mix_u64(lane + _s64(0x9E3779B97F4A7C15) if rho else lane)
    h = mix_u64(lane)
    if not rho:
        return lsr(h, 64 - p)
    x = (h << p) | (1 << (p - 1))
    clz = torch.zeros_like(x)
    for shift in (32, 16, 8, 4, 2, 1):
        empty = lsr(x, 64 - shift) == 0
        clz = clz + torch.where(empty, shift, 0)
        x = torch.where(empty, x << shift, x)
    return clz + 1


_TWO63 = 9223372036854775808.0


def double_to_int64(x: torch.Tensor) -> torch.Tensor:
    """XLA's conversion of a double to int64: toward zero, saturating
    past the int64 range, NaN to 0 (torch's own is undefined there)."""
    big, small, nan = x >= _TWO63, x < -_TWO63, torch.isnan(x)
    safe = torch.where(big | small | nan, torch.zeros_like(x), x).to(torch.int64)
    return torch.where(big, _I64_MAX, torch.where(small, _I64_MIN, safe))


def double_key(x: torch.Tensor) -> torch.Tensor:
    """An int64 that orders as the doubles do, -0.0 below 0.0 (the
    reference's min/max order); NaN takes no fixed place here."""
    b = x.view(torch.int64) if x.dtype == torch.float64 else x
    return b ^ ((b >> 63) & _I64_MAX)


def _nan_where(x, y, pick_x):
    """``pick_x ? x : y``, NaN where either is NaN (jnp.maximum's rule)."""
    nan = torch.isnan(x) | torch.isnan(y)
    return torch.where(nan, torch.full_like(x, float("nan")), torch.where(pick_x, x, y))


def cbrt(x: torch.Tensor) -> torch.Tensor:
    """Cube root: torch has none, so a power guess refined by one
    Newton step (the guess is good to ~1e-14, the step to the last
    bit), on the magnitude scaled by an exact power of two into a range
    where the cube neither overflows nor turns subnormal; zeros,
    infinities and NaN pass through."""
    a = torch.abs(x)
    ok = torch.isfinite(a) & (a > 0)
    tiny, big = a < 2.0 ** -900, a > 2.0 ** 900
    one = torch.ones_like(a)
    a2 = torch.where(ok, a, one) * torch.where(tiny, 2.0 ** 960,
                                               torch.where(big, 2.0 ** -960, one))
    y0 = torch.pow(a2, 1.0 / 3.0)
    y = y0 - (y0 * y0 * y0 - a2) / (3.0 * y0 * y0)
    y = y * torch.where(tiny, 2.0 ** -320, torch.where(big, 2.0 ** 320, one))
    return torch.copysign(torch.where(ok, y, a), x)


def dun_plain(fn: int, x: torch.Tensor) -> torch.Tensor:
    """DUN's plain form over a double tensor."""
    name = DUN_FNS[fn]
    if name == "sqrt":  # correctly rounded, as the card's __dsqrt_rn (numpy's on the CPU)
        if x.is_cuda:
            return torch.sqrt(x)
        import numpy as np

        with np.errstate(invalid="ignore"):
            return torch.from_numpy(np.sqrt(x.numpy()))
    if name == "cbrt":
        return cbrt(x)
    if name == "degrees":  # jnp.degrees: one multiply by the constant
        return x * (180.0 / 3.141592653589793)
    if name == "radians":
        return x * (3.141592653589793 / 180.0)
    if name == "sign":  # jnp.sign, then XLA's int conversion (NaN -> 0)
        return (x > 0).to(torch.int64) - (x < 0).to(torch.int64)
    if name == "is_nan":
        return torch.isnan(x).to(torch.int64)
    if name == "is_finite":
        return torch.isfinite(x).to(torch.int64)
    if name == "is_infinite":
        return torch.isinf(x).to(torch.int64)
    return {"exp": torch.exp, "ln": torch.log, "log2": torch.log2, "log10": torch.log10,
            "sin": torch.sin, "cos": torch.cos, "tan": torch.tan, "asin": torch.asin,
            "acos": torch.acos, "atan": torch.atan, "sinh": torch.sinh, "cosh": torch.cosh,
            "tanh": torch.tanh, "truncate": torch.trunc}[name](x)


def dbin_plain(fn: int, a: torch.Tensor, b: torch.Tensor):
    """DBIN's plain form: ``(value, nonzero divisor)``."""
    if DBIN_FNS[fn] == "power":
        return torch.pow(a, b), None
    if DBIN_FNS[fn] == "atan2":
        return torch.atan2(a, b), None
    zero = b == 0  # jnp.mod: fmod, moved to the divisor's sign
    bs = torch.where(zero, torch.ones_like(b), b)
    r = torch.fmod(a, bs)
    return torch.where((r != 0) & ((r < 0) != (bs < 0)), r + bs, r), ~zero


def bitw_plain(arg: int, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """BITW's plain form: and/or/xor of two int64 lanes, or a shift
    (by ``b & 63``, Java's rule) or bit count of ``a``'s low ``bits``
    bits as an unsigned field, masked back to ``bits``."""
    op, bits = BITW_OPS[arg & 15], arg >> 4
    if op in ("and", "or", "xor"):
        return {"and": a & b, "or": a | b, "xor": a ^ b}[op]
    mask = (1 << bits) - 1 if bits < 64 else -1
    ua = a & mask
    if op == "bit_count":
        return popcount(ua)
    s = b & 63
    out = ua << s if op == "shift_left" else lsr(ua, s)
    return out & mask


def greatest_least(take_max: bool, lane: int, a, b):
    """GL's plain form over two operands of one lane; NULL handling is
    the caller's (NULL if either is)."""
    if lane in (GL_LONG, GL_D38):
        a_less, _ = d128.compare(a, b)
        return torch.where((a_less != take_max)[:, None], a, b)
    if lane == GL_DOUBLE:
        ka, kb = double_key(a), double_key(b)
        return _nan_where(a, b, ka >= kb if take_max else ka <= kb)
    return torch.maximum(a, b) if take_max else torch.minimum(a, b)


def cast_bigint_plain(arg: int, d: torch.Tensor) -> torch.Tensor:
    """CASTBI's plain form: a double toward zero (XLA's saturating
    conversion), a short decimal HALF_UP at its scale, a long decimal's
    floor at its scale (``decimal128.rescale`` down, then narrowed to
    int64, wrapping)."""
    src, scale = arg & 3, arg >> 2
    if src == CAST_FROM_DOUBLE:
        return double_to_int64(d)
    p = 10 ** scale
    if src == CAST_FROM_LONG:
        return d[:, 0] * (d128.BASE // p) + _fdiv(d[:, 1], p)
    if scale == 0:
        return d
    q = _fdiv(d, p)
    r = d - q * p
    return q + torch.where(d >= 0, 2 * r >= p, 2 * r > p).to(torch.int64)


def _abs_at(x: torch.Tensor, bits: int) -> torch.Tensor:
    """``abs`` at a signed width: its least value stays itself (wraps)."""
    return torch.where(x == -(1 << (bits - 1)), x, torch.abs(x))


def wrap_at(x: torch.Tensor, bits: int) -> torch.Tensor:
    """An int64 lane wrapped to a narrower signed width."""
    return x if bits == 64 else x.to({32: torch.int32, 16: torch.int16,
                                      8: torch.int8}[bits]).to(torch.int64)


def imod_plain(arg: int, a: torch.Tensor, b: torch.Tensor):
    """IMOD's plain form: SQL's truncating mod (the dividend's sign) or
    div (toward zero): ``(value, valid)`` with NULL on a zero divisor and,
    for div, on the result width's least value over -1.  As the
    reference's ``_trunc_div`` / ``_trunc_mod`` compute it in jnp, each
    operand's ``abs`` runs at its own width (``IMOD_WIDTHS`` by arg bits
    1-2 and 3-4: abs of a width's least value wraps to itself) and the
    result wraps at the wider width."""
    wa, wb = IMOD_WIDTHS[arg >> 1 & 3], IMOD_WIDTHS[arg >> 3 & 3]
    wr = max(wa, wb)
    bs = torch.where(b == 0, torch.ones_like(b), b)
    aa, ab = _abs_at(a, wa), _abs_at(bs, wb)
    if arg & 1:
        q = torch.div(aa, ab, rounding_mode="floor")
        ok = (b != 0) & ~((a == -(1 << (wr - 1))) & (b == -1))
        return wrap_at(torch.where((a < 0) ^ (bs < 0), -q, q), wr), ok
    r = torch.remainder(aa, ab)
    return wrap_at(torch.where(a < 0, -r, r), wr), b != 0


def width_bucket_plain(x, lo, hi, n):
    """WBUCKET's plain form (the reference's ``width_bucket``)."""
    one = torch.ones_like(x)
    frac = (x - lo) / torch.where(hi == lo, one, hi - lo)
    b = double_to_int64(torch.floor(frac * n.to(torch.float64))) + 1
    return torch.minimum(torch.maximum(b, torch.zeros_like(b)), n + 1)


def narrow32(x: torch.Tensor) -> torch.Tensor:
    """An int64 lane wrapped to int32's range (the reference's
    ``astype(int32)`` of a date result)."""
    return x.to(torch.int32).to(torch.int64)


_MONTH_LEN = (31, 28, 31, 30, 31, 30, 31, 31, 30, 31, 30, 31)


def add_months(days: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    """Epoch days shifted by ``n`` calendar months, the day of the month
    clamped to the new month's length (the reference's ``_add_months``:
    2020-01-31 + 1 month is 2020-02-29)."""
    y, m, d = civil_from_days(days)
    months = y * 12 + (m - 1) + n
    y2 = _fdiv(months, 12)
    m2 = months - y2 * 12 + 1
    leap = (torch.remainder(y2, 4) == 0) & ((torch.remainder(y2, 100) != 0)
                                             | (torch.remainder(y2, 400) == 0))
    mlen = torch.tensor(_MONTH_LEN, dtype=torch.int64, device=days.device)[m2 - 1] \
        + ((m2 == 2) & leap).to(torch.int64)
    return days_from_civil(y2, m2, torch.minimum(d, mlen))


def ts_part(micros: torch.Tensor, part: int) -> torch.Tensor:
    """TSPART's plain form: a date part (``TS_PARTS``) of epoch
    microseconds, the days by floor division (1969-12-31 23:00 is in
    1969), the time of day from what is left."""
    days = _fdiv(micros, MICROS_PER_DAY)
    tod = micros - days * MICROS_PER_DAY
    name = TS_PARTS[part]
    if name == "hour":
        return _fdiv(tod, 3_600_000_000)
    if name == "minute":
        return torch.remainder(_fdiv(tod, 60_000_000), 60)
    if name == "second":
        return torch.remainder(_fdiv(tod, 1_000_000), 60)
    if name == "millisecond":
        return torch.remainder(_fdiv(tod, 1_000), 1000)
    return date_part(days, part)


def dt_trunc(x: torch.Tensor, arg: int) -> torch.Tensor:
    """DTRUNC's plain form (the reference's ``_datetime_trunc``): a
    timestamp floors to a second, minute, hour or day; a week (Monday),
    month, quarter or year goes through the civil calendar; a date
    keeps itself below a week."""
    unit, is_ts = DT_UNITS[arg & 15], bool(arg & DT_TS)
    if DT_UNITS.index(unit) <= DT_UNITS.index("day"):
        if not is_ts:
            return x
        step = UNIT_MICROS[DT_UNITS.index(unit)]
        return _fdiv(x, step) * step
    days = _fdiv(x, MICROS_PER_DAY) if is_ts else x
    y, m, _ = civil_from_days(days)
    one = torch.ones_like(m)
    if unit == "week":
        out = days - torch.remainder(days + 3, 7)
    elif unit == "month":
        out = days_from_civil(y, m, one)
    elif unit == "quarter":
        out = days_from_civil(y, _fdiv(m - 1, 3) * 3 + 1, one)
    else:
        out = days_from_civil(y, one, one)
    return out * MICROS_PER_DAY if is_ts else narrow32(out)


def _unit_months(unit: str, n: torch.Tensor) -> torch.Tensor:
    return n * (12 if unit == "year" else 3 if unit == "quarter" else 1)


def dt_add(x: torch.Tensor, n: torch.Tensor, arg: int) -> torch.Tensor:
    """DTADD's plain form (the reference's ``_datetime_add``,
    ``ts_add_micros``, ``ts_add_months``, ``date_add_months`` and
    ``date_add_days``): a fixed span adds its microseconds (wrapping), a
    month, quarter or year shifts the civil date and keeps the time of
    day; a date's result is narrowed to int32 as the reference's is."""
    ui, is_ts = arg & 15, bool(arg & DT_TS)
    unit = DT_UNITS[ui]
    if is_ts:
        if ui < len(UNIT_MICROS):
            return x + n * UNIT_MICROS[ui]
        days = _fdiv(x, MICROS_PER_DAY)
        tod = x - days * MICROS_PER_DAY
        return add_months(days, _unit_months(unit, n)) * MICROS_PER_DAY + tod
    if unit == "day":
        return narrow32(x + n)
    if unit == "week":
        return narrow32(x + 7 * n)
    return narrow32(add_months(x, _unit_months(unit, n)))


def trunc_div(a: torch.Tensor, b: int) -> torch.Tensor:
    """SQL's integer division toward zero by a positive constant (the
    reference's ``_trunc_div``)."""
    q = _fdiv(torch.abs(a), b)
    return torch.where(a < 0, -q, q)


def dt_diff(a: torch.Tensor, b: torch.Tensor, arg: int) -> torch.Tensor:
    """DTDIFF's plain form (the reference's ``_datetime_diff``): both
    sides as microseconds; a fixed span truncates the difference toward
    zero; month, quarter and year count calendar-field differences
    ((y2 * 12 + m2) - (y1 * 12 + m1)), the reference's documented
    deviation from Presto's whole elapsed periods."""
    ui = arg & 15
    m1 = a * MICROS_PER_DAY if arg & DT_A_DATE else a
    m2 = b * MICROS_PER_DAY if arg & DT_B_DATE else b
    if ui < len(UNIT_MICROS):
        return trunc_div(m2 - m1, UNIT_MICROS[ui])
    y1, mo1, _ = civil_from_days(_fdiv(m1, MICROS_PER_DAY))
    y2, mo2, _ = civil_from_days(_fdiv(m2, MICROS_PER_DAY))
    months = (y2 * 12 + mo2) - (y1 * 12 + mo1)
    unit = DT_UNITS[ui]
    if unit == "month":
        return months
    if unit == "quarter":
        return trunc_div(months, 3)
    return y2 - y1


def unixtime_plain(arg: int, d: torch.Tensor) -> torch.Tensor:
    """UNIXT's plain form: to_unixtime of a timestamp (micros / 1e6) or
    a date ((days * MICROS_PER_DAY) / 1e6, in double), or
    from_unixtime of a double (x * 1e6, to int64 as XLA converts:
    toward zero, saturating).  Each division is by a tensor, a true
    division on every device."""
    if arg == UNIXT_FROM:
        return double_to_int64(d * torch.full_like(d, 1e6))
    x = d.to(torch.float64)
    if arg == UNIXT_DATE:
        x = x * torch.full_like(x, float(MICROS_PER_DAY))
    return x / torch.full_like(x, 1e6)


def date_format_code(x: torch.Tensor, is_ts: bool):
    """DFMT's plain form: ``(code, in range)`` of a date or timestamp in
    the date_format dictionary (the day minus ``DATE_FMT_BASE``,
    clipped; NULL outside the dictionary's span)."""
    days = _fdiv(x, MICROS_PER_DAY) if is_ts else x
    code = days - DATE_FMT_BASE
    ok = (code >= 0) & (code < DATE_FMT_SPAN)
    return torch.clamp(code, 0, DATE_FMT_SPAN - 1), ok


def expr_eval_plain(prog: Program, cols: Sequence[Tuple[torch.Tensor, torch.Tensor]],
                    n: int, row_mask: Optional[torch.Tensor] = None):
    """Plain torch evaluation of ``prog`` over ``n`` rows.  Returns
    ``(data, valid)``, or with ``row_mask`` the filtered row mask
    ``row_mask & data & valid``.  Stack values are ``(n,)`` int64,
    ``(n,)`` float64 or ``(n, 2)`` int64 limbs."""
    dev = row_mask.device if row_mask is not None else (
        cols[0][0].device if cols else torch.device("cpu"))
    stack = []
    for op, arg in zip(prog.ops, prog.args):
        if op == LOAD:
            d, v = cols[arg]
            stack.append((d.to(torch.int64), v))
        elif op == LOAD_F64:  # a REAL widens exactly into the double lane
            d, v = cols[arg]
            stack.append((d.to(torch.float64), v))
        elif op in (LOAD_LONG, LOAD_D38):
            stack.append(cols[arg])
        elif op in LIMB_RUNS:  # a long or wide literal's limbs
            limbs = torch.tensor(prog.consts[arg:arg + LIMB_RUNS[op]], dtype=torch.int64,
                                 device=dev)
            stack.append((limbs.expand(n, -1).contiguous(),
                          torch.ones(n, dtype=torch.bool, device=dev)))
        elif op in (S2D38, L2D38, D38UP, D38DOWN, D38NEG, D382D, D38NARROW, D38SIGN):
            d, v = stack.pop()
            stack.append((d38_unary(op, arg, d), v))
        elif op == DLIT:
            stack.append((torch.full((n,), bits_double(prog.consts[arg]), dtype=torch.float64,
                                     device=dev),
                          torch.ones(n, dtype=torch.bool, device=dev)))
        elif op in (DNEG, DABS):
            d, v = stack.pop()
            stack.append((-d if op == DNEG else torch.abs(d), v))
        elif op == DFLOOR:
            d, v = stack.pop()
            stack.append((torch.ceil(d) if arg else torch.floor(d), v))
        elif op == DROUND:  # half away from zero at 10^digits, as the reference
            d, v = stack.pop()
            m = torch.full_like(d, bits_double(prog.consts[arg]))
            x = d * m
            r = torch.where(x >= 0, torch.floor(x + 0.5), torch.ceil(x - 0.5))
            stack.append((r / m, v))
        elif op == D2S:  # round(d * 10^scale), half to even (jnp.round)
            d, v = stack.pop()
            m = torch.full_like(d, bits_double(prog.consts[arg]))
            stack.append((torch.round(d * m).to(torch.int64), v))
        elif op == D2L:  # the same, split into limbs through floor(scaled / BASE)
            d, v = stack.pop()
            m = torch.full_like(d, bits_double(prog.consts[arg]))
            scaled = torch.round(d * m)
            base = torch.full_like(d, float(d128.BASE))
            hi = torch.floor(scaled / base)
            lo = scaled - hi * base
            stack.append((d128.normalize(hi.to(torch.int64), lo.to(torch.int64)), v))
        elif op == SFLOOR:  # floor division by 10^k (a ceiling adds 10^k - 1 first)
            d, v = stack.pop()
            c = prog.consts[arg >> 1]
            stack.append((_fdiv(d + (c - 1) if arg & 1 else d, c), v))
        elif op == SROUND:  # half away from zero over 10^drop
            d, v = stack.pop()
            p = prog.consts[arg]
            half = p // 2
            stack.append((torch.where(d >= 0, _fdiv(d + half, p), -_fdiv(-d + half, p)), v))
        elif op in (NEG, ABS):  # the least value of the lane's width has no negation: NULL
            d, v = stack.pop()
            v = v & (d != (_I32_MIN if arg else _I64_MIN))
            stack.append((-d if op == NEG else torch.abs(d), v))
        elif op == LIT:
            stack.append((torch.full((n,), prog.consts[arg], dtype=torch.int64, device=dev),
                          torch.ones(n, dtype=torch.bool, device=dev)))
        elif op == NULL:
            stack.append((torch.zeros(n, dtype=torch.int64, device=dev),
                          torch.zeros(n, dtype=torch.bool, device=dev)))
        elif op in (SCALE, SCALE_CHK):
            d, v = stack.pop()
            f = prog.consts[arg]
            if op == SCALE_CHK:
                lim = _I64_MAX // f
                v = v & ~((d > lim) | (d < -lim))
            stack.append((d * f, v))
        elif op == NOT:
            d, v = stack.pop()
            stack.append(((d == 0).to(torch.int64), v))
        elif op == IN:
            d, v = stack.pop()
            first, count = arg & ((1 << IN_COUNT_SHIFT) - 1), arg >> IN_COUNT_SHIFT
            hit = torch.zeros_like(v)
            for c in prog.consts[first:first + count]:
                hit = hit | (d == c)
            stack.append((hit.to(torch.int64), v))
        elif op in (LUT, CANON):
            d, v = stack.pop()
            table = prog.luts[arg].on(d.device)
            code = torch.clamp(d, 0, table.shape[0] - 1)
            stack.append((table[code].to(torch.int64), v))
        elif op == SEL:
            (ed, ev), (td, tv), (cd, cv) = stack.pop(), stack.pop(), stack.pop()
            cond = (cd != 0) & cv
            wide_cond = cond[:, None] if td.dim() > 1 else cond
            stack.append((torch.where(wide_cond, td, ed), torch.where(cond, tv, ev)))
        elif op == L2D:
            d, v = stack.pop()
            stack.append((d128.to_double(d, arg), v))
        elif op == S2D:  # a division by a tensor: no reciprocal multiply
            d, v = stack.pop()
            stack.append((d128.div_exact(d.to(torch.float64), 10.0 ** arg), v))
        elif op == S2L:
            d, v = stack.pop()
            stack.append((d128.from_int64(d), v))
        elif op == LSCALE:
            d, v = stack.pop()
            stack.append((d128.upscale(d, arg), v))
        elif op == DATEPART:
            d, v = stack.pop()
            stack.append((date_part(d, arg), v))
        elif op in (VLUT, DVLUT):  # a value table, and the not-null table's vote
            d, v = stack.pop()
            table = prog.luts[arg & 255].on(d.device)
            code = torch.clamp(d, 0, table.shape[0] - 1)
            if arg >> 8:
                v = v & prog.luts[(arg >> 8) - 1].on(d.device)[code]
            stack.append((table[code], v))
        elif op == TSPART:
            d, v = stack.pop()
            stack.append((ts_part(d, arg), v))
        elif op == DTRUNC:
            d, v = stack.pop()
            stack.append((dt_trunc(d, arg), v))
        elif op == CASTTS:
            d, v = stack.pop()
            stack.append((d * MICROS_PER_DAY if arg == 0 else
                          narrow32(_fdiv(d, MICROS_PER_DAY)), v))
        elif op == UNIXT:
            d, v = stack.pop()
            stack.append((unixtime_plain(arg, d), v))
        elif op == DFMT:
            d, v = stack.pop()
            code, ok = date_format_code(d, bool(arg))
            stack.append((code, v & ok))
        elif op == DUN:
            d, v = stack.pop()
            stack.append((dun_plain(arg, d), v))
        elif op == F32R:  # rounded once to float32, widened back
            d, v = stack.pop()
            stack.append((d.to(torch.float32).to(torch.float64), v))
        elif op == CASTN:  # NULL outside the narrower signed range
            d, v = stack.pop()
            lo, hi = -(1 << (arg - 1)), (1 << (arg - 1)) - 1
            stack.append((d, v & (d >= lo) & (d <= hi)))
        elif op == DIN:  # == against each double literal: NaN matches none
            d, v = stack.pop()
            first, count = arg & ((1 << IN_COUNT_SHIFT) - 1), arg >> IN_COUNT_SHIFT
            hit = torch.zeros_like(v)
            for c in prog.consts[first:first + count]:
                hit = hit | (d == bits_double(c))
            stack.append((hit.to(torch.int64), v))
        elif op == CASTBI:
            d, v = stack.pop()
            stack.append((cast_bigint_plain(arg, d), v))
        elif op == HLL:  # a double hashes its bits
            d, v = stack.pop()
            lane = d.view(torch.int64) if d.is_floating_point() else d
            stack.append((hll_from_lane(lane, bool(arg & 1), arg >> 1), v))
        elif op == WBUCKET:
            (nd, nv), (hd, hv), (ld, lv), (xd, xv) = (stack.pop(), stack.pop(), stack.pop(),
                                                       stack.pop())
            stack.append((width_bucket_plain(xd, ld, hd, nd), xv & lv & hv & nv))
        elif op == NOTNULL:
            _, v = stack.pop()
            stack.append(((~v if arg else v).to(torch.int64), torch.ones_like(v)))
        elif op in (LCMP, D38CMP):
            (bd, bv), (ad, av) = stack.pop(), stack.pop()
            lt, eq = d128.compare(ad, bd)
            d = (eq, ~eq, lt, lt | eq, ~(lt | eq), ~lt)[arg]
            stack.append((d.to(torch.int64), av & bv))
        elif op == BETWEEN:
            (hd, hv), (ld, lv), (xd, xv) = stack.pop(), stack.pop(), stack.pop()
            stack.append(_logic(AND, (xd >= ld).to(torch.int64), xv & lv,
                                (xd <= hd).to(torch.int64), xv & hv))
        else:
            (bd, bv), (ad, av) = stack.pop(), stack.pop()
            if op in (AND, OR):
                stack.append(_logic(op, ad, av, bd, bv))
                continue
            if op == NULLIF:  # b: a = b, which NULLs a where it is true
                stack.append((ad, av & ~((bd != 0) & bv)))
                continue
            if op == COAL:  # the first valid operand
                take = ~av & bv
                wide_take = take[:, None] if ad.dim() > 1 else take
                stack.append((torch.where(wide_take, bd, ad), av | bv))
                continue
            v = av & bv
            if op == ADD:
                d = ad + bd
                v = v & ~(((ad ^ d) & (bd ^ d)) < 0)
            elif op == SUB:
                d = ad - bd
                v = v & ~(((ad ^ bd) & (ad ^ d)) < 0)
            elif op == MUL:
                d = ad * bd
                v = v & ~_ovf_mul(ad, bd, d)
            elif op == MUL_LS:
                d = d128.mul_long_short(ad, bd) if arg == 0 else d128.mul_long_short(bd, ad)
            elif op in (LADD, D38ADD):
                d = d128.sub(ad, bd) if arg else d128.add(ad, bd)
            elif op == D38MUL:  # arg 0: the wide operand below the int64 one
                d = d128.mul_wide_small(ad, bd) if arg == 0 else d128.mul_wide_small(bd, ad)
            elif op == DDIV:
                zero = bd == 0
                d = ad / torch.where(zero, torch.ones_like(bd), bd)
                v = v & ~zero
            elif op in (DADD, DSUB, DMUL):
                d = ad + bd if op == DADD else ad - bd if op == DSUB else ad * bd
            elif op == DBIN:
                d, ok = dbin_plain(arg, ad, bd)
                if ok is not None:
                    v = v & ok
            elif op == BITW:
                d = bitw_plain(arg, ad, bd)
            elif op == GL:
                d = greatest_least(bool(arg & 1), arg >> 1, ad, bd)
            elif op == IMOD:
                d, ok = imod_plain(arg, ad, bd)
                v = v & ok
            elif op == DTADD:
                d = dt_add(ad, bd, arg)
            elif op == DTDIFF:
                d = dt_diff(ad, bd, arg)
            elif op == DCMP:
                d = (ad == bd, ad != bd, ad < bd, ad <= bd, ad > bd, ad >= bd)[arg].to(
                    torch.int64)
            else:
                d = {EQ: ad == bd, NE: ad != bd, LT: ad < bd, LE: ad <= bd,
                     GT: ad > bd, GE: ad >= bd}[op].to(torch.int64)
            stack.append((d, v))
    (d, v), = stack
    if row_mask is not None:
        return row_mask & (d != 0) & v
    if prog.out_kind == KIND_BOOL:
        return d != 0, v
    if prog.out_kind in _LIMBS_OF or (d.is_floating_point() and prog.out_kind != KIND_F32):
        return d, v
    return d.to(_DTYPE_OF[prog.out_kind]), v


def d38_unary(op: int, arg: int, d: torch.Tensor) -> torch.Tensor:
    """The plain form of K1's one-operand wide-decimal opcodes:
    S2D38 (``from_int64``), L2D38 (``widen``), D38UP / D38DOWN (the
    up-scale that drops its top carry, the flooring down-scale),
    D38NEG, D382D (``to_double``), D38NARROW (to an int64 lane, wrapping,
    or to two limbs) and D38SIGN (abs, or sign as an int64 lane)."""
    if op == S2D38:
        return d128.from_int64(d, d128.WIDE_LIMBS)
    if op == L2D38:
        return d128.widen(d)
    if op == D38UP:
        return d128.upscale(d, arg)
    if op == D38DOWN:
        return d128.downscale_wide(d, arg)
    if op == D38NEG:
        return d128.neg(d)
    if op == D382D:
        return d128.to_double(d, arg)
    if op == D38NARROW:
        return d128.narrow_long(d) if arg else d128.to_int64(d)
    negative = d[:, 0] < 0
    if arg == 0:  # abs
        return torch.where(negative[:, None], d128.neg(d), d)
    return torch.where(negative, -1, (d != 0).any(dim=1).to(torch.int64))


def _logic(op, ad, av, bd, bv):
    a, b = ad != 0, bd != 0
    if op == AND:
        definite_false = (av & ~a) | (bv & ~b)
        return (~definite_false & a & b).to(torch.int64), (av & bv) | definite_false
    definite_true = (av & a) | (bv & b)
    return (definite_true | a | b).to(torch.int64), (av & bv) | definite_true


def expr_eval(prog: Program, cols: Sequence[Tuple[torch.Tensor, torch.Tensor]],
              n: int, row_mask: Optional[torch.Tensor] = None):
    """Evaluate ``prog`` over ``n`` rows of ``cols`` (``(data, valid)``
    pairs).  Returns ``(data, valid)``; with ``row_mask``, the new row
    mask ``row_mask & data & valid`` (a filter).  CPU tensors take the
    plain version; CUDA tensors launch the kernel."""
    tensors = [t for c in cols for t in c] + ([row_mask] if row_mask is not None else [])
    if not tensors or not tensors[0].is_cuda:
        return expr_eval_plain(prog, cols, n, row_mask)
    return _launch(prog, cols, n, row_mask, tensors)


def _launch(prog, cols, n, row_mask, tensors):
    global launches, in_launches, double_launches
    build.require_cuda(tensors, "expr_eval")
    if (len(prog.ops) > MAX_INS or len(prog.consts) > MAX_CONSTS
            or len(cols) > MAX_COLS or prog.depth > MAX_STACK or len(prog.luts) > MAX_LUTS):
        raise ValueError(f"expr_eval: program exceeds the kernel's limits: {prog}")
    if prog.out_kind not in _DTYPE_OF and prog.out_kind not in _LIMBS_OF or (
            prog.out_kind in (KIND_F64, KIND_F32, KIND_D128) and not prog.wide) or (
            prog.out_kind == KIND_D38 and prog.limbs != 5):
        raise ValueError(f"expr_eval: output kind {prog.out_kind}")
    for op, arg in zip(prog.ops, prog.args):
        if op in (LUT, CANON) and prog.luts[arg].dtype != (torch.bool if op == LUT
                                                           else torch.int32):
            raise ValueError(f"expr_eval: table {arg} has the wrong type for {OP_NAMES[op]}")
        if op in (VLUT, DVLUT) and (
                prog.luts[arg & 255].dtype != (torch.int64 if op == VLUT else torch.float64)
                or (arg >> 8 and (prog.luts[(arg >> 8) - 1].dtype != torch.bool
                                  or len(prog.luts[(arg >> 8) - 1].values)
                                  != len(prog.luts[arg & 255].values)))):
            raise ValueError(f"expr_eval: tables {arg} have the wrong types for {OP_NAMES[op]}")
        if op in (IN, DIN) and (arg & ((1 << IN_COUNT_SHIFT) - 1)) + (arg >> IN_COUNT_SHIFT) \
                > len(prog.consts):
            raise ValueError("expr_eval: IN literals past the constant pool")
        if op in LIMB_RUNS and not 0 <= arg <= len(prog.consts) - LIMB_RUNS[op]:
            raise ValueError(f"expr_eval: {OP_NAMES[op]} limbs past the constant pool")
        if op == CASTN and arg not in (8, 16, 32) or op == F32R and arg not in (F32R_DOUBLE,
                                                                                F32R_INT):
            raise ValueError(f"expr_eval: {OP_NAMES[op]}({arg})")
    long_slots = {a for o, a in zip(prog.ops, prog.args) if o == LOAD_LONG}
    d38_slots = {a for o, a in zip(prog.ops, prog.args) if o == LOAD_D38}
    f64_slots = {a for o, a in zip(prog.ops, prog.args) if o == LOAD_F64}
    kinds = []
    for slot, (d, v) in enumerate(cols):
        tail = (2,) if slot in long_slots else (5,) if slot in d38_slots else ()
        if d.dim() != 1 + len(tail) or d.shape[0] < n or tuple(d.shape[1:]) != tail \
                or v.dim() != 1 or v.shape[0] < n or v.dtype != torch.bool \
                or (tail and not d.is_contiguous()):
            raise ValueError("expr_eval: columns must be 1-D, or contiguous (n, 2) or (n, 5) "
                             "limbs, with bool validity")
        if tail:
            if d.dtype != torch.int64:
                raise ValueError(f"expr_eval: long-decimal column dtype {d.dtype}")
            kinds.append(KIND_D128 if tail == (2,) else KIND_D38)
        elif slot in f64_slots:
            if d.dtype not in (torch.float64, torch.float32):
                raise ValueError(f"expr_eval: double column dtype {d.dtype}")
            kinds.append(KIND_F64 if d.dtype == torch.float64 else KIND_F32)
        elif d.dtype not in _KIND_OF:
            raise ValueError(f"expr_eval: column dtype {d.dtype}")
        else:
            kinds.append(_KIND_OF[d.dtype])
    dev = tensors[0].device
    luts = [t.on(dev) for t in prog.luts]
    if row_mask is not None:
        if row_mask.dtype != torch.bool or row_mask.shape[0] != n:
            raise ValueError("expr_eval: row_mask must be bool (n,)")
        out_data, out_valid = None, None
        out_mask = torch.empty(n, dtype=torch.bool, device=dev)
    else:
        out_data = torch.empty((n, _LIMBS_OF[prog.out_kind]), dtype=torch.int64, device=dev) \
            if prog.out_kind in _LIMBS_OF else torch.empty(n, dtype=_DTYPE_OF[prog.out_kind],
                                                           device=dev)
        out_valid = torch.empty(n, dtype=torch.bool, device=dev)
        out_mask = None
    lib = build.library()
    fn = lib.k1_expr_eval
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                   ctypes.c_void_p, ctypes.c_int,
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                   ctypes.c_longlong, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_void_p]
    # the C arrays stay referenced until the call returns
    c_ops, c_args = build.ints(prog.ops), build.ints(prog.args)
    c_consts = build.ptrs(prog.consts)
    c_data = build.ptrs(d.data_ptr() for d, _ in cols)
    c_valid = build.ptrs(v.data_ptr() for _, v in cols)
    c_kinds = build.ints(kinds)
    c_luts = build.ptrs(t.data_ptr() for t in luts)
    c_lut_len = build.ptrs(t.shape[0] for t in luts)
    err = fn(c_ops, c_args, len(prog.ops), c_consts, len(prog.consts),
             c_data, c_valid, c_kinds, len(cols),
             c_luts, c_lut_len, len(luts), prog.limbs,
             n, row_mask.data_ptr() if row_mask is not None else None,
             out_data.data_ptr() if out_data is not None else None, prog.out_kind,
             out_valid.data_ptr() if out_valid is not None else None,
             out_mask.data_ptr() if out_mask is not None else None,
             build.stream_of(tensors[0]))
    build.check(err, "expr_eval")
    launches += 1
    if IN in prog.ops or DIN in prog.ops or any(t.kind == "in" for t in prog.luts):
        in_launches += 1
    if {KIND_I16, KIND_I8, KIND_F32} & (set(kinds) | {prog.out_kind}):
        op_launches["narrow"] = op_launches.get("narrow", 0) + 1
    for kind in {t.kind for t in prog.luts} & set(COUNTED_TABLES):
        op_launches[kind] = op_launches.get(kind, 0) + 1
    double_launches += int(bool(DOUBLE_OPS & set(prog.ops)))
    if prog.limbs == 5:
        op_launches["d38"] = op_launches.get("d38", 0) + 1
    for op in set(prog.ops) & COUNTED_OPS.keys():
        op_launches[COUNTED_OPS[op]] = op_launches.get(COUNTED_OPS[op], 0) + 1
    if any(op == HLL and arg >> 1 == 0 for op, arg in zip(prog.ops, prog.args)):
        op_launches["mix64"] = op_launches.get("mix64", 0) + 1
    if any(op == HLL and arg == 1 for op, arg in zip(prog.ops, prog.args)):
        op_launches["digest_hash"] = op_launches.get("digest_hash", 0) + 1
    if out_mask is not None:
        return out_mask
    return out_data, out_valid
