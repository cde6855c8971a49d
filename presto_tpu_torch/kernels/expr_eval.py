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
least value has no negation (the reference's ``_ovf_neg``).

A stack value is an int64 lane (integers, dates, booleans, short
decimals, dictionary codes), a double, or a long decimal (two
base-10^18 limbs).  A program that holds a long or double lane is
"wide" and runs on a second instantiation of the interpreter whose
stack slots carry the second limb; every other program keeps the
narrow int64 stack.
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
    DNEG, DABS, DCMP, NEG, ABS = range(42)
OP_NAMES = ("load", "lit", "null", "add", "sub", "mul", "scale_chk", "scale",
            "eq", "ne", "lt", "le", "gt", "ge", "between", "and", "or", "not",
            "lut", "sel", "load_long", "mul_ls", "l2d", "ddiv", "in", "canon",
            "datepart", "s2d", "s2l", "lscale", "lcmp", "notnull", "load_f64", "dlit",
            "dadd", "dsub", "dmul", "dneg", "dabs", "dcmp", "neg", "abs")
# stack effect of each opcode (pushes minus pops)
STACK_EFFECT = (1, 1, 1, -1, -1, -1, 0, 0, -1, -1, -1, -1, -1, -1, -2, -1, -1, 0,
                0, -2, 1, -1, 0, -1, 0, 0, 0, 0, 0, 0, -1, 0, 1, 1, -1, -1, -1,
                0, 0, -1, 0, 0)
# opcodes whose argument is printed: a column slot, a constant index,
# a table slot, the long operand's side (MUL_LS), a decimal scale
# (L2D, S2D), IN's literal run (first constant | count <<
# IN_COUNT_SHIFT), the date part (DATEPART: year, month, day,
# quarter), the digits of an up-scale (LSCALE), the comparison (LCMP:
# eq, ne, lt, le, gt, ge; DCMP the same), the test (NOTNULL: 0 not_null,
# 1 is_null), a double constant's bits (DLIT: a constant index) or the
# integer lane's width (NEG, ABS: 1 for int32, whose least value has no
# negation there, 0 for int64)
_ARG_OPS = (LOAD, LIT, SCALE_CHK, SCALE, LUT, LOAD_LONG, MUL_LS, L2D, IN, CANON,
            DATEPART, S2D, LSCALE, LCMP, NOTNULL, LOAD_F64, DLIT, DCMP, NEG, ABS)
IN_COUNT_SHIFT = 8
# opcodes only the wide interpreter runs
DOUBLE_OPS = frozenset((LOAD_F64, DLIT, DADD, DSUB, DMUL, DNEG, DABS, DCMP))
WIDE_OPS = frozenset((LOAD_LONG, MUL_LS, L2D, DDIV, S2D, S2L, LSCALE, LCMP)) | DOUBLE_OPS

# fixed limits of the kernel's by-value program (csrc/expr_eval.cu)
MAX_INS = 128
MAX_CONSTS = 64
MAX_COLS = 16
MAX_STACK = 16
MAX_LUTS = 16

# storage kinds of loaded columns and of the output
KIND_BOOL, KIND_I32, KIND_I64, KIND_F64, KIND_D128 = range(5)
_KIND_OF = {torch.bool: KIND_BOOL, torch.int32: KIND_I32, torch.int64: KIND_I64}
_DTYPE_OF = {KIND_BOOL: torch.bool, KIND_I32: torch.int32, KIND_I64: torch.int64,
             KIND_F64: torch.float64}

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
               ABS: "abs"}

_I32_MIN = -(1 << 31)


def double_bits(x: float) -> int:
    """The IEEE-754 bits of a double as a signed int64 (DLIT's constant)."""
    return struct.unpack("<q", struct.pack("<d", float(x)))[0]


def bits_double(b: int) -> float:
    return struct.unpack("<d", struct.pack("<q", int(b)))[0]


class Lut:
    """The operand of LUT (a boolean table) or CANON (an int32 table),
    indexed by a dictionary's codes, with its copy on each device it
    has been read on."""

    __slots__ = ("values", "dtype", "kind", "_copies")

    def __init__(self, values: Sequence, dtype: torch.dtype = torch.bool, kind: str = ""):
        self.dtype = dtype
        self.kind = kind  # what the table tests ("like", "in", "canon", a comparison)
        self.values = tuple(bool(v) if dtype == torch.bool else int(v) for v in values)
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
        return any(op in WIDE_OPS for op in self.ops)

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


def date_part(days: torch.Tensor, part: int) -> torch.Tensor:
    """DATEPART's plain form: year, month, day or quarter (0-3)."""
    y, m, d = civil_from_days(days)
    return (y, m, d, _fdiv(m - 1, 3) + 1)[part]


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
        elif op in (LOAD_LONG, LOAD_F64):
            stack.append(cols[arg])
        elif op == DLIT:
            stack.append((torch.full((n,), bits_double(prog.consts[arg]), dtype=torch.float64,
                                     device=dev),
                          torch.ones(n, dtype=torch.bool, device=dev)))
        elif op in (DNEG, DABS):
            d, v = stack.pop()
            stack.append((-d if op == DNEG else torch.abs(d), v))
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
        elif op == NOTNULL:
            _, v = stack.pop()
            stack.append(((~v if arg else v).to(torch.int64), torch.ones_like(v)))
        elif op == LCMP:
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
            elif op == DDIV:
                zero = bd == 0
                d = ad / torch.where(zero, torch.ones_like(bd), bd)
                v = v & ~zero
            elif op in (DADD, DSUB, DMUL):
                d = ad + bd if op == DADD else ad - bd if op == DSUB else ad * bd
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
    if prog.out_kind == KIND_D128 or d.is_floating_point():
        return d, v
    return d.to(_DTYPE_OF[prog.out_kind]), v


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
    if prog.out_kind not in _DTYPE_OF and prog.out_kind != KIND_D128 or (
            prog.out_kind in (KIND_F64, KIND_D128) and not prog.wide):
        raise ValueError(f"expr_eval: output kind {prog.out_kind}")
    for op, arg in zip(prog.ops, prog.args):
        if op in (LUT, CANON) and prog.luts[arg].dtype != (torch.bool if op == LUT
                                                           else torch.int32):
            raise ValueError(f"expr_eval: table {arg} has the wrong type for {OP_NAMES[op]}")
        if op == IN and (arg & ((1 << IN_COUNT_SHIFT) - 1)) + (arg >> IN_COUNT_SHIFT) \
                > len(prog.consts):
            raise ValueError("expr_eval: IN literals past the constant pool")
    long_slots = {a for o, a in zip(prog.ops, prog.args) if o == LOAD_LONG}
    f64_slots = {a for o, a in zip(prog.ops, prog.args) if o == LOAD_F64}
    kinds = []
    for slot, (d, v) in enumerate(cols):
        tail = (2,) if slot in long_slots else ()
        if d.dim() != 1 + len(tail) or d.shape[0] < n or tuple(d.shape[1:]) != tail \
                or v.dim() != 1 or v.shape[0] < n or v.dtype != torch.bool:
            raise ValueError("expr_eval: columns must be 1-D, or (n, 2) limbs, with "
                             "bool validity")
        if slot in long_slots:
            if d.dtype != torch.int64:
                raise ValueError(f"expr_eval: long-decimal column dtype {d.dtype}")
            kinds.append(KIND_D128)
        elif slot in f64_slots:
            if d.dtype != torch.float64:
                raise ValueError(f"expr_eval: double column dtype {d.dtype}")
            kinds.append(KIND_F64)
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
        out_data = torch.empty((n, 2), dtype=torch.int64, device=dev) \
            if prog.out_kind == KIND_D128 else torch.empty(n, dtype=_DTYPE_OF[prog.out_kind],
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
             c_luts, c_lut_len, len(luts), int(prog.wide),
             n, row_mask.data_ptr() if row_mask is not None else None,
             out_data.data_ptr() if out_data is not None else None, prog.out_kind,
             out_valid.data_ptr() if out_valid is not None else None,
             out_mask.data_ptr() if out_mask is not None else None,
             build.stream_of(tensors[0]))
    build.check(err, "expr_eval")
    launches += 1
    if IN in prog.ops or any(t.kind == "in" for t in prog.luts):
        in_launches += 1
    double_launches += int(bool(DOUBLE_OPS & set(prog.ops)))
    for op in set(prog.ops) & COUNTED_OPS.keys():
        op_launches[COUNTED_OPS[op]] = op_launches.get(COUNTED_OPS[op], 0) + 1
    if out_mask is not None:
        return out_mask
    return out_data, out_valid
