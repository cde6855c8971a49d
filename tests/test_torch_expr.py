"""K1's lowering and plain evaluator (presto_tpu_torch.expr.compile)
against the reference's ExprCompiler.compile: the same expression over
the same numpy inputs gives the same valid mask everywhere and the same
data wherever valid.  Integer and decimal arithmetic is exact; doubles
agree to a relative 1e-12 (XLA may round the reference's fused
operations in another order)."""

import numpy as np
import pytest
import jax.numpy as jnp

from presto_tpu import expr as ref_ir
from presto_tpu.expr import compile as ref_compile
from presto_tpu.page import Block as RefBlock, Dictionary as RefDictionary, Page as RefPage
from presto_tpu.testing import LocalQueryRunner as RefRunner
from presto_tpu.types import parse_type as ref_type
from presto_tpu_torch import NotPorted
from presto_tpu_torch.expr import compile as port_compile
from presto_tpu_torch.expr import ir as port_ir
from presto_tpu_torch.testing import LocalQueryRunner as PortRunner
from presto_tpu_torch.types import parse_type as port_type
from tpch_queries import QUERIES
from torch_parity import assert_same_lanes, to_port, with_nulls_and_dead_rows

I64_MAX = (1 << 63) - 1
I64_MIN = -(1 << 63)
EDGES = [I64_MAX, I64_MIN, I64_MAX - 1, I64_MIN + 1, 1 << 62, -(1 << 62),
         3037000499, -3037000500, I64_MAX // 100, I64_MAX // 100 + 1,
         -(I64_MAX // 100) - 1, 0, 1, -1]
# the synthetic page: name -> type
COLUMNS = [("d0", "decimal(12,2)"), ("d1", "decimal(12,2)"), ("b0", "bigint"),
           ("b1", "bigint"), ("dt", "date"), ("f", "boolean"), ("d18", "decimal(18,2)")]


def _synthetic_page(seed: int, n: int = 4096) -> RefPage:
    rng = np.random.default_rng(seed)
    cols = []
    for name, t in COLUMNS:
        if t == "boolean":
            data = rng.random(n) < 0.5
        elif t == "date":
            data = rng.integers(8000, 11000, n).astype(np.int32)
        elif name.startswith("b") or name == "d18":
            data = rng.integers(-(10 ** 12), 10 ** 12, n)
            pick = rng.random(n) < 0.3
            data[pick] = rng.choice(np.array(EDGES, dtype=np.int64), pick.sum())
        else:
            data = rng.integers(-10 ** 6, 10 ** 6, n)
        cols.append(RefBlock(jnp.asarray(data), jnp.ones(n, jnp.bool_), ref_type(t)))
    page = RefPage(tuple(cols), jnp.ones(n, jnp.bool_))
    return with_nulls_and_dead_rows(page, rng, null_rate=0.15, dead_rate=0.1)


def _build(spec, ir, parse_type):
    kind = spec[0]
    if kind == "col":
        idx = [c for c, _ in COLUMNS].index(spec[1])
        return ir.ColumnRef(type=parse_type(COLUMNS[idx][1]), index=idx)
    if kind == "lit":
        return ir.Literal(type=parse_type(spec[2]), value=spec[1])
    _, fn, t, *args = spec
    return ir.Call(type=parse_type(t), fn=fn,
                   args=tuple(_build(a, ir, parse_type) for a in args))


def C(name):
    return ("col", name)


def L(v, t):
    return ("lit", v, t)


def F(fn, t, *args):
    return ("call", fn, t) + args


SPECS = {
    "bigint_add": F("add", "bigint", C("b0"), C("b1")),
    "bigint_sub": F("sub", "bigint", C("b0"), C("b1")),
    "bigint_mul": F("mul", "bigint", C("b0"), C("b1")),
    "bigint_mul_lit": F("mul", "bigint", C("b0"), L(-1, "bigint")),
    "dec_add_rescale": F("add", "decimal(18,2)", C("d18"), C("b1")),
    "dec_sub_rescale_lit": F("sub", "decimal(13,2)", L(1, "bigint"), C("d0")),
    "dec_mul": F("mul", "decimal(18,4)", C("d18"), C("d1")),
    "dec_mul_chain": F("mul", "decimal(18,6)",
                       F("mul", "decimal(18,4)", C("d0"), F("sub", "decimal(13,2)",
                                                           L(1, "bigint"), C("d1"))),
                       F("add", "decimal(13,2)", L(1, "bigint"), C("d0"))),
    "cmp_dec_bigint": F("lt", "boolean", C("d18"), C("b0")),
    "cmp_date_lit": F("le", "boolean", C("dt"), L(10471, "date")),
    "cmp_eq": F("eq", "boolean", C("b0"), C("b1")),
    "cmp_ne": F("ne", "boolean", C("d0"), C("d1")),
    "cmp_ge_gt": F("and", "boolean", F("ge", "boolean", C("d0"), L(0, "bigint")),
                   F("gt", "boolean", C("b1"), C("b0"))),
    "between_same_scale": F("between", "boolean", C("d0"),
                            F("sub", "decimal(18,2)", L(6, "decimal(18,2)"),
                              L(1, "decimal(18,2)")),
                            F("add", "decimal(18,2)", L(6, "decimal(18,2)"),
                              L(1, "decimal(18,2)"))),
    "between_mixed_scale": F("between", "boolean", C("d18"), C("b0"), L(5, "decimal(12,2)")),
    "three_valued_or_not": F("or", "boolean", C("f"),
                             F("not", "boolean", F("lt", "boolean", C("b0"), C("b1")))),
    "and_null_literal": F("and", "boolean", C("f"), L(None, "boolean")),
    "or_null_literal": F("or", "boolean", L(None, "boolean"), C("f")),
    "folded_overflow_literal": F("add", "bigint", C("b0"),
                                 F("add", "bigint", L(1 << 62, "bigint"),
                                   L(1 << 62, "bigint"))),
    "folded_rescale_overflow": F("add", "decimal(18,2)", C("d0"),
                                 L(I64_MAX // 10, "bigint")),
}


@pytest.mark.parametrize("name", sorted(SPECS))
@pytest.mark.parametrize("seed", [0, 1])
def test_expression_parity(name, seed):
    ref_page = _synthetic_page(seed)
    port_page = to_port(ref_page)
    ref_e = _build(SPECS[name], ref_ir, ref_type)
    port_e = _build(SPECS[name], port_ir, port_type)
    ref = ref_compile.ExprCompiler.for_page(ref_page).compile(ref_e)(ref_page)
    got = port_compile.ExprCompiler.for_page(port_page).compile(port_e)(port_page)
    assert_same_lanes(ref, got, name)
    if ref_e.type.name == "boolean":
        want = ref_compile.compile_filter(ref_e, ref_page)(ref_page)
        mask = port_compile.compile_filter(port_e, port_page)(port_page)
        np.testing.assert_array_equal(mask.numpy(), np.asarray(want))


def _plan_exprs(plan):
    """Filter predicates and aggregate arguments of a plan, preorder."""
    out, stack = [], [plan]
    while stack:
        node = stack.pop()
        if hasattr(node, "predicate"):
            out.append(node.predicate)
        for agg in getattr(node, "aggs", ()) or ():
            if agg.arg is not None:
                out.append(agg.arg)
        stack.extend(node.sources)
    return out


@pytest.mark.parametrize("q", [6, 1])
def test_tpch_expressions_parity(q):
    """Q6/Q1 predicates and aggregate arguments, as each package's own
    planner binds them, over a lineitem split with NULLs and dead rows."""
    from presto_tpu.connectors.tpch import Tpch

    ref_exprs = _plan_exprs(RefRunner(sf=0.01).plan(QUERIES[q]))
    port_exprs = _plan_exprs(PortRunner(sf=0.01, device="cpu").plan(QUERIES[q]))
    assert [repr(e) for e in port_exprs] == [repr(e) for e in ref_exprs]
    ref_page = with_nulls_and_dead_rows(Tpch(sf=0.01).page_for_split("lineitem", 0),
                                        np.random.default_rng(q))
    port_page = to_port(ref_page)
    for re_, pe in zip(ref_exprs, port_exprs):
        ref = ref_compile.ExprCompiler.for_page(ref_page).compile(re_)(ref_page)
        got = port_compile.ExprCompiler.for_page(port_page).compile(pe)(port_page)
        assert_same_lanes(ref, got, repr(pe))


def test_literal_subtrees_fold_on_the_host():
    page = to_port(_synthetic_page(0, 16))
    c = port_compile.ExprCompiler.for_page(page)
    prog, cols = c.lower(_build(SPECS["dec_sub_rescale_lit"], port_ir, port_type))
    assert [op for op in prog.ops] == [1, 0, 4]  # LIT(100) LOAD SUB
    assert prog.consts == (100,)
    prog, _ = c.lower(_build(SPECS["folded_overflow_literal"], port_ir, port_type))
    assert prog.ops == (0, 2, 3)  # LOAD NULL ADD: 2^62 + 2^62 wraps to NULL


@pytest.mark.parametrize("spec", [
    F("date_trunc", "date", L("millisecond", "varchar"), C("dt")),
    F("mod", "decimal(38,2)", C("d0"), C("d1")),
    F("in", "boolean", C("d0"), ("lit", 1.5, "double")),
])
def test_unported_expressions_raise(spec):
    """Integer div and double mod, once here, are ported since the
    eighth slice (tests/test_torch_functions.py), date_trunc by a
    calendar unit since the ninth (tests/test_torch_datetime.py); a
    unit the reference has no branch for, a long-decimal mod and IN
    with a double literal are not."""
    page = to_port(_synthetic_page(0, 16))
    with pytest.raises(NotPorted):
        port_compile.ExprCompiler.for_page(page).compile(_build(spec, port_ir, port_type))


# -- strings, CASE and the wide (long-decimal / double) lanes ------------------

WIDE_COLUMNS = [("s", "varchar"), ("d0", "decimal(12,2)"), ("l0", "decimal(36,4)"),
                ("l1", "decimal(36,4)"), ("b0", "bigint"), ("f", "boolean"),
                ("g", "boolean")]
WORDS = ["PROMO BRUSHED TIN", "STANDARD BRASS", "PROMO PLATED", "ABC", "AXC", "BUILDING",
         "promo lower"]


def _wide_page(seed: int, n: int = 4096) -> RefPage:
    rng = np.random.default_rng(seed)
    cols = []
    for name, t in WIDE_COLUMNS:
        if t == "varchar":
            data = rng.integers(0, len(WORDS), n).astype(np.int32)
        elif t == "boolean":
            data = rng.random(n) < 0.5
        elif t == "decimal(36,4)":
            hi = rng.integers(-10 ** 6, 10 ** 6, n)
            hi[rng.random(n) < 0.1] = 0
            lo = rng.integers(0, 10 ** 18, n)
            lo[(hi == 0) & (rng.random(n) < 0.5)] = 0  # zero divisors
            data = np.stack([hi, lo], 1)
        elif name == "d0":
            data = rng.integers(-10 ** 9, 10 ** 9, n)
        else:
            data = rng.integers(-10 ** 12, 10 ** 12, n)
        cols.append(RefBlock(jnp.asarray(data), jnp.ones(n, jnp.bool_), ref_type(t),
                             RefDictionary(WORDS) if t == "varchar" else None))
    page = RefPage(tuple(cols), jnp.ones(n, jnp.bool_))
    return with_nulls_and_dead_rows(page, rng, null_rate=0.15, dead_rate=0.1)


def _wide(spec, ir, parse_type):
    if spec[0] == "col":
        idx = [c for c, _ in WIDE_COLUMNS].index(spec[1])
        return ir.ColumnRef(type=parse_type(WIDE_COLUMNS[idx][1]), index=idx)
    if spec[0] == "lit":
        return ir.Literal(type=parse_type(spec[2]), value=spec[1])
    _, fn, t, *args = spec
    return ir.Call(type=parse_type(t), fn=fn,
                   args=tuple(_wide(a, ir, parse_type) for a in args))


REVENUE = F("mul", "decimal(18,4)", C("d0"), F("sub", "decimal(13,2)", L(1, "bigint"),
                                               C("d0")))
WIDE_SPECS = {
    "like_prefix": F("like", "boolean", C("s"), L("PROMO%", "varchar")),
    "like_suffix": F("like", "boolean", C("s"), L("%BRASS", "varchar")),
    "like_underscore": F("like", "boolean", C("s"), L("A_C", "varchar")),
    "varchar_eq": F("eq", "boolean", C("s"), L("BUILDING", "varchar")),
    "varchar_ne": F("ne", "boolean", C("s"), L("BUILDING", "varchar")),
    "varchar_eq_absent": F("eq", "boolean", C("s"), L("NOPE", "varchar")),
    "varchar_lt_literal_left": F("lt", "boolean", L("B", "varchar"), C("s")),
    "not_like_and": F("and", "boolean", F("not", "boolean",
                                          F("like", "boolean", C("s"), L("%TIN", "varchar"))),
                      C("f")),
    # Q14's argument: CASE WHEN like THEN revenue ELSE 0 (bigint -> decimal(18,4))
    "case_like_else_zero": F("case", "decimal(18,4)",
                             F("like", "boolean", C("s"), L("PROMO%", "varchar")),
                             REVENUE, L(0, "bigint")),
    # NULL conditions are not taken; the first true branch wins
    "case_null_conditions": F("case", "decimal(18,2)", C("f"), C("d0"), C("g"),
                              L(7, "decimal(18,2)"), F("like", "boolean", C("s"),
                                                       L("A%", "varchar")),
                              L(-1, "bigint"), L(None, "decimal(18,2)")),
    "if_bigint": F("if", "bigint", C("f"), C("b0"), L(3, "bigint")),
    # Q14's projection: 100.00 * long / long as double, zero divisor -> NULL
    "promo_div": F("div", "double", F("mul", "decimal(36,6)", L(10000, "decimal(18,2)"),
                                      C("l0")), C("l1")),
    "long_times_short_div": F("div", "double", F("mul", "decimal(36,6)", C("l0"), C("d0")),
                              C("l1")),
}


@pytest.mark.parametrize("name", sorted(WIDE_SPECS))
@pytest.mark.parametrize("seed", [0, 1])
def test_string_case_and_wide_parity(name, seed):
    ref_page = _wide_page(seed)
    port_page = to_port(ref_page)
    ref_e = _wide(WIDE_SPECS[name], ref_ir, ref_type)
    port_e = _wide(WIDE_SPECS[name], port_ir, port_type)
    rd, rv = ref_compile.ExprCompiler.for_page(ref_page).compile(ref_e)(ref_page)
    pd, pv = port_compile.ExprCompiler.for_page(port_page).compile(port_e)(port_page)
    rd, rv, pd, pv = np.asarray(rd), np.asarray(rv), pd.numpy(), pv.numpy()
    np.testing.assert_array_equal(pv, rv, err_msg=f"{name} valid")
    assert rv.any() and (~rv).any()
    if ref_e.type.name == "double":
        np.testing.assert_allclose(pd[rv], rd[rv], rtol=1e-12, atol=0)
    else:
        np.testing.assert_array_equal(pd[rv], rd[rv], err_msg=f"{name} data")
    if ref_e.type.name == "boolean":
        want = ref_compile.compile_filter(ref_e, ref_page)(ref_page)
        mask = port_compile.compile_filter(port_e, port_page)(port_page)
        np.testing.assert_array_equal(mask.numpy(), np.asarray(want))


def test_wide_programs_take_the_wide_interpreter():
    """Only programs with a long-decimal or double lane are wide: Q6's
    and Q1's programs keep the narrow int64 stack."""
    from presto_tpu_torch.kernels import expr_eval as k1

    page = to_port(_wide_page(0, 16))
    c = port_compile.ExprCompiler.for_page(page)
    prog, _ = c.lower(_wide(WIDE_SPECS["promo_div"], port_ir, port_type))
    assert prog.wide and prog.out_kind == k1.KIND_F64
    for name in ("case_like_else_zero", "like_prefix", "varchar_eq"):
        prog, _ = c.lower(_wide(WIDE_SPECS[name], port_ir, port_type))
        assert not prog.wide and k1.LUT in prog.ops
    for spec in SPECS.values():
        prog, _ = port_compile.ExprCompiler.for_page(to_port(_synthetic_page(0, 16))).lower(
            _build(spec, port_ir, port_type))
        assert not prog.wide


def test_dictionary_tables_are_shared_and_bounded():
    """One table per (dictionary, predicate), reused by every program;
    the cache keeps at most LUT_CACHE_SIZE of them, dropping the least
    recently used."""
    from presto_tpu_torch.page import Dictionary

    d = Dictionary(["PROMO BRUSHED", "STANDARD POLISHED"])
    first = port_compile.dictionary_lut(d, ("like", "PROMO%"), lambda v: v.startswith("PROMO"))
    assert first.values == (True, False)
    assert port_compile.dictionary_lut(d, ("like", "PROMO%"), None) is first
    for i in range(port_compile.LUT_CACHE_SIZE + 10):
        port_compile.dictionary_lut(Dictionary([str(i)]), ("eq", "0"), lambda v: v == "0")
    assert len(port_compile._LUT_CACHE) == port_compile.LUT_CACHE_SIZE
    assert port_compile.dictionary_lut(d, ("like", "PROMO%"),
                                       lambda v: v.startswith("PROMO")) is not first
    assert first.on("cpu") is first.on("cpu")


@pytest.mark.parametrize("q", [14, 3])
def test_join_query_expressions_bind_alike(q):
    """Q14's and Q3's predicates and aggregate arguments bind to the
    same expressions in both packages."""
    ref_exprs = _plan_exprs(RefRunner(sf=0.01).plan(QUERIES[q]))
    port_exprs = _plan_exprs(PortRunner(sf=0.01, device="cpu").plan(QUERIES[q]))
    assert [repr(e) for e in port_exprs] == [repr(e) for e in ref_exprs]
    assert port_exprs


# -- IN (K1's IN opcode and dictionary tables) ---------------------------------

IN_COLUMNS = [("b", "bigint"), ("d", "decimal(12,2)"), ("s", "varchar"), ("k", "integer")]
IN_WORDS = ["MAIL", "SHIP", "AIR", "AIR REG", "MAIL", "TRUCK"]  # MAIL twice


def _in_page(seed: int, n: int = 4096) -> RefPage:
    rng = np.random.default_rng(seed)
    data = [rng.integers(-3, 20, n), rng.integers(0, 400, n),
            rng.integers(0, len(IN_WORDS), n).astype(np.int32),
            rng.integers(0, 60, n).astype(np.int32)]
    cols = [RefBlock(jnp.asarray(x), jnp.ones(n, jnp.bool_), ref_type(t),
                     RefDictionary(IN_WORDS) if t == "varchar" else None)
            for x, (_, t) in zip(data, IN_COLUMNS)]
    page = RefPage(tuple(cols), jnp.ones(n, jnp.bool_))
    return with_nulls_and_dead_rows(page, rng, null_rate=0.15, dead_rate=0.1)


def _in_expr(spec, ir, parse_type):
    if spec[0] == "col":
        idx = [c for c, _ in IN_COLUMNS].index(spec[1])
        return ir.ColumnRef(type=parse_type(IN_COLUMNS[idx][1]), index=idx)
    if spec[0] == "lit":
        return ir.Literal(type=parse_type(spec[2]), value=spec[1])
    _, fn, t, *args = spec
    return ir.Call(type=parse_type(t), fn=fn,
                   args=tuple(_in_expr(a, ir, parse_type) for a in args))


IN_SPECS = {
    "bigint": F("in", "boolean", C("b"), L(3, "bigint"), L(7, "bigint"), L(-1, "bigint"),
                L(11, "bigint")),
    "integer_q16": F("in", "boolean", C("k"), *[L(v, "bigint")
                                                for v in (49, 14, 23, 45, 19, 3, 36, 9)]),
    # raw data against each literal's value, no scale alignment
    "short_decimal": F("in", "boolean", C("d"), L(150, "decimal(12,2)"),
                       L(7, "decimal(12,2)"), L(399, "decimal(12,2)")),
    "short_decimal_bigint_literal": F("in", "boolean", C("d"), L(5, "bigint")),
    "varchar": F("in", "boolean", C("s"), L("MAIL", "varchar"), L("AIR REG", "varchar"),
                 L("NOPE", "varchar")),
    "not_in_varchar": F("not", "boolean", F("in", "boolean", C("s"), L("SHIP", "varchar"))),
    "in_and_in": F("and", "boolean", F("in", "boolean", C("b"), L(1, "bigint"), L(2, "bigint")),
                   F("in", "boolean", C("s"), L("TRUCK", "varchar"), L("AIR", "varchar"))),
    "folded_literal_in": F("or", "boolean", F("in", "boolean", L(4, "bigint"), L(3, "bigint"),
                                              L(5, "bigint")),
                           F("eq", "boolean", C("b"), L(0, "bigint"))),
}


@pytest.mark.parametrize("name", sorted(IN_SPECS))
@pytest.mark.parametrize("seed", [0, 1])
def test_in_parity(name, seed):
    ref_page = _in_page(seed)
    port_page = to_port(ref_page)
    ref_e = _in_expr(IN_SPECS[name], ref_ir, ref_type)
    port_e = _in_expr(IN_SPECS[name], port_ir, port_type)
    ref = ref_compile.ExprCompiler.for_page(ref_page).compile(ref_e)(ref_page)
    got = port_compile.ExprCompiler.for_page(port_page).compile(port_e)(port_page)
    assert_same_lanes(ref, got, name)
    d, v = got
    assert (d & v).any() and (~d & v).any()
    want = ref_compile.compile_filter(ref_e, ref_page)(ref_page)
    mask = port_compile.compile_filter(port_e, port_page)(port_page)
    np.testing.assert_array_equal(mask.numpy(), np.asarray(want))


def test_in_lowers_to_one_opcode_over_a_literal_run():
    from presto_tpu_torch.kernels import expr_eval as k1

    page = to_port(_in_page(0, 16))
    c = port_compile.ExprCompiler.for_page(page)
    prog, _ = c.lower(_in_expr(IN_SPECS["in_and_in"], port_ir, port_type))
    assert prog.ops == (k1.LOAD, k1.IN, k1.LOAD, k1.LUT, k1.AND)
    first, count = prog.args[1] & 255, prog.args[1] >> k1.IN_COUNT_SHIFT
    assert prog.consts[first:first + count] == (1, 2)
    prog, _ = c.lower(_in_expr(IN_SPECS["folded_literal_in"], port_ir, port_type))
    assert k1.IN not in prog.ops  # 4 IN (3, 5) folded on the host
    with pytest.raises(NotPorted):
        c.lower(_in_expr(F("in", "boolean", C("b"), C("k")), port_ir, port_type))


@pytest.mark.parametrize("q", [12, 16, 19])
def test_slice_filters_fit_the_kernel(q):
    """The filters of Q12, Q16 and Q19 bind as the reference's and lower
    within K1's limits; Q19's post-join predicate (three ORed branches
    with six dictionary tables) is the largest."""
    from presto_tpu_torch.kernels import expr_eval as k1
    from presto_tpu_torch.planner.plan import FilterNode

    ref_exprs = _plan_exprs(RefRunner(sf=0.01).plan(QUERIES[q]))
    plan = PortRunner(sf=0.01, device="cpu").plan(QUERIES[q])
    assert [repr(e) for e in _plan_exprs(plan)] == [repr(e) for e in ref_exprs]
    stack, sizes = [plan], []
    while stack:
        node = stack.pop()
        if isinstance(node, FilterNode):
            chans = node.source.channels
            prog, _ = port_compile.ExprCompiler(
                [ch.type for ch in chans], [ch.dictionary for ch in chans]).lower(
                node.predicate)
            sizes.append((len(prog.ops), len(prog.luts)))
        stack.extend(node.sources)
    assert sizes and all(n <= k1.MAX_INS and luts <= k1.MAX_LUTS for n, luts in sizes)
    if q == 19:
        assert max(sizes) == (56, 6)


@pytest.mark.parametrize("words", [["MAIL", "SHIP", "AIR", "MAIL", "AIR REG", "SHIP"],
                                   ["MAIL", "SHIP", "AIR"]])
def test_key_canon_codes_equal_reference(words):
    """A key over a dictionary that repeats a value runs K1's CANON
    program; its codes equal the reference's canonicalize_codes at
    every valid position.  A dictionary without repeats needs none."""
    from presto_tpu.ops.aggregate import canonicalize_codes

    rng = np.random.default_rng(31)
    n = 4096
    codes = rng.integers(0, len(words), n).astype(np.int32)
    ref_page = RefPage((RefBlock(jnp.asarray(codes), jnp.ones(n, jnp.bool_), ref_type("varchar"),
                                 RefDictionary(words)),), jnp.ones(n, jnp.bool_))
    ref_page = with_nulls_and_dead_rows(ref_page, rng, null_rate=0.1, dead_rate=0.1)
    ref_block = ref_page.blocks[0]
    want = np.asarray(canonicalize_codes([ref_block.data], [ref_block.dictionary])[0])
    page = to_port(ref_page)
    c = port_compile.ExprCompiler.for_page(page)
    key = port_ir.ColumnRef(type=port_type("varchar"), index=0)
    assert (c.lower_key(key) is None) == (len(set(words)) == len(words))
    data, valid = c.compile_key(key)(page)
    live = np.asarray(ref_block.valid)
    np.testing.assert_array_equal(valid.numpy(), live)
    np.testing.assert_array_equal(data.numpy()[live], want[live])
    assert len(set(data.numpy()[live].tolist())) == len(set(words))
