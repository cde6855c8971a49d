"""The eighth slice's scalar functions: K1's new opcode families
(DUN, DBIN, BITW, GL, NULLIF, CASTBI, HLL, WBUCKET, IMOD and the new
date parts) against the reference's ``ExprCompiler`` over seeded pages
with NULLs and dead rows, and the reference's scalar suites' SQL
(``tests/test_scalar_functions.py``, ``test_function_breadth.py``,
``test_scalar_breadth2.py``) through the port's ``QueryRunner`` on the
CPU against the reference's, at TPC-H sf 0.001.

Tolerances: every lane is exact (valid masks everywhere, data where
valid), but the doubles a transcendental produces (cbrt, exp, ln, log2,
log10, the trigonometric and hyperbolic functions, power, atan2), which
agree within a relative 1e-9: XLA's CPU kernels compute them in the
reference, torch's in the port.  sqrt, degrees, radians, truncate,
mod and the casts are correctly rounded or exact on both sides."""

import math

import numpy as np
import pytest

from presto_tpu.expr import compile as ref_compile
from presto_tpu.expr import ir as ref_ir
from presto_tpu.types import parse_type as ref_type
from presto_tpu_torch import NotPorted
from presto_tpu_torch.expr import compile as port_compile
from presto_tpu_torch.expr import ir as port_ir
from presto_tpu_torch.kernels import expr_eval as k1
from presto_tpu_torch.types import parse_type as port_type
from torch_fn_parity import COLUMNS, C, F, L, TpchPair, build, function_page
from torch_parity import to_port

X, Y, A, B, D, DT, LL, S = C("x"), C("y"), C("a"), C("b"), C("d"), C("dt"), C("l"), C("s")

# name -> (spec, transcendental)
# exp and power take arguments whose results stay normal: XLA's CPU
# backend flushes subnormal doubles to zero (test_subnormals_...)
X_SMALL = F("div", "double", X, L(1e4, "double"))
SPECS = {f"dun_{fn}": (F(fn, "double", Y if fn in ("ln", "log2", "log10", "sqrt")
                         else X_SMALL if fn == "exp" else X),
                       k1.DUN_FNS.index(fn) in k1.TRANSCENDENTAL)
         for fn in k1.DUN_FNS if fn not in ("sign", "is_nan", "is_finite", "is_infinite")}
SPECS.update({
    "dun_sign_double": (F("sign", "bigint", X), False),
    "dun_sign_decimal": (F("sign", "bigint", D), False),
    "dun_sign_int": (F("sign", "bigint", A), False),
    "dun_is_nan": (F("is_nan", "boolean", F("sqrt", "double", X)), False),
    "dun_is_finite": (F("is_finite", "boolean", X), False),
    "dun_is_infinite": (F("is_infinite", "boolean", X), False),
    "dun_of_decimal": (F("ln", "double", D), True),
    "dbin_power": (F("power", "double", Y, F("div", "double", X, L(1e5, "double"))), True),
    "dbin_atan2": (F("atan2", "double", X, Y), True),
    # jnp.mod floors (the dividend's sign is lost: a reference fault, ROADMAP C)
    "dbin_mod": (F("mod", "double", X, Y), False),
    "dbin_mod_zero": (F("mod", "double", X, L(0.0, "double")), False),
    "dbin_mod_decimal_operand": (F("mod", "double", D, L(-0.75, "double")), False),
    "bitw_and": (F("bitwise_and", "bigint", A, B), False),
    "bitw_or": (F("bitwise_or", "bigint", A, B), False),
    "bitw_xor": (F("bitwise_xor", "bigint", A, B), False),
    "bitw_not": (F("bitwise_not", "bigint", A), False),
    "bitw_int_operand": (F("bitwise_and", "bigint", A, C("i")), False),
    # shift counts in -5..80: Java's rule, the count & 63
    "bitw_shl_64": (F("bitwise_shift_left", "bigint", A, B, L(64, "integer")), False),
    "bitw_shr_64": (F("bitwise_shift_right", "bigint", A, B, L(64, "integer")), False),
    "bitw_shl_4": (F("bitwise_shift_left", "bigint", A, B, L(4, "integer")), False),
    "bitw_shr_8": (F("bitwise_shift_right", "bigint", A, B, L(8, "integer")), False),
    "bitw_count_64": (F("bit_count", "bigint", A, L(64, "integer")), False),
    "bitw_count_8": (F("bit_count", "bigint", A, L(8, "integer")), False),
    "gl_greatest_int": (F("greatest", "bigint", A, B, C("i")), False),
    "gl_least_decimal": (F("least", "decimal(12,2)", D, L(250, "decimal(12,2)")), False),
    "gl_greatest_double": (F("greatest", "double", X, L(-0.0, "double")), False),
    "gl_least_double": (F("least", "double", X, Y, L(0.0, "double")), False),
    "gl_greatest_long": (F("greatest", "decimal(36,4)", LL, D), False),
    "gl_least_date": (F("least", "date", DT, L(0, "date")), False),
    "nullif_int": (F("nullif", "bigint", A, B), False),
    "nullif_double": (F("nullif", "double", X, L(2.5, "double")), False),
    "nullif_decimal": (F("nullif", "decimal(12,2)", D, L(250, "decimal(12,2)")), False),
    "nullif_mixed_scale": (F("nullif", "bigint", B, L(250, "decimal(12,2)")), False),
    "castbi_double": (F("cast_bigint", "bigint", X), False),
    "castbi_decimal_half_up": (F("cast_bigint", "bigint", D), False),
    "castbi_long": (F("cast_bigint", "bigint", LL), False),
    "castbi_int": (F("cast_bigint", "bigint", C("i")), False),
    "wbucket": (F("width_bucket", "bigint", X, L(0.0, "double"), L(1000.0, "double"),
                  L(10, "bigint")), False),
    "wbucket_decimal": (F("width_bucket", "bigint", D, L(-100, "bigint"), L(100, "bigint"),
                          B), False),
    "imod_int": (F("mod", "bigint", A, B), False),
    "imod_div": (F("div", "bigint", A, B), False),
    "imod_decimal": (F("mod", "decimal(12,2)", D, L(700, "decimal(12,2)")), False),
    "imod_negative_divisor": (F("mod", "bigint", A, L(-7, "bigint")), False),
    "last_day_of_month": (F("last_day_of_month", "date", DT), False),
})
SPECS.update({f"hll_{fn}_{c}": (F(fn, "bigint", C(c)), False)
              for fn in ("hll_bucket", "hll_rho") for c in ("a", "x", "s", "dt", "f")})
SPECS.update({f"datepart_{fn}": (F(fn, "bigint", DT), False)
              for fn in ("day_of_week", "day_of_year", "week", "year_of_week")})


@pytest.mark.parametrize("name", sorted(SPECS))
def test_function_parity(name):
    """The port's K1 twin against the reference's ExprCompiler: exact,
    or a relative 1e-9 for a transcendental's doubles (see above)."""
    spec, transcendental = SPECS[name]
    ref_page = function_page(sum(map(ord, name)))
    port_page = to_port(ref_page)
    ref_e = build(spec, ref_ir, ref_type, COLUMNS)
    port_e = build(spec, port_ir, port_type, COLUMNS)
    rd, rv = ref_compile.ExprCompiler.for_page(ref_page).compile(ref_e)(ref_page)
    pd, pv = port_compile.ExprCompiler.for_page(port_page).compile(port_e)(port_page)
    rd, rv, pd, pv = np.asarray(rd), np.asarray(rv), pd.numpy(), pv.numpy()
    np.testing.assert_array_equal(pv, rv, err_msg=f"{name} valid")
    if transcendental:
        np.testing.assert_allclose(pd[rv], rd[rv], rtol=1e-9, atol=0, err_msg=name)
    elif pd.dtype == np.float64:  # bit for bit; a NaN as a NaN (its sign bit is not kept)
        nan = np.isnan(rd[rv])
        np.testing.assert_array_equal(np.isnan(pd[rv]), nan, err_msg=name)
        np.testing.assert_array_equal(pd[rv][~nan].view(np.int64), rd[rv][~nan].view(np.int64),
                                      err_msg=name)
    else:
        np.testing.assert_array_equal(pd[rv], rd[rv], err_msg=name)


def test_nan_and_signed_zero_follow_the_reference():
    """greatest/least propagate NaN and order -0.0 below 0.0, as
    jnp.maximum/jnp.minimum do; a NaN cast to bigint is 0 and past the
    int64 range saturates (XLA's conversion)."""
    ref_page = function_page(5, nan=True)
    port_page = to_port(ref_page)
    for spec in (F("greatest", "double", X, L(-0.0, "double")),
                 F("least", "double", X, L(0.0, "double")),
                 F("cast_bigint", "bigint", X), F("sign", "bigint", X),
                 F("is_nan", "boolean", X)):
        ref_e = build(spec, ref_ir, ref_type, COLUMNS)
        port_e = build(spec, port_ir, port_type, COLUMNS)
        rd, rv = ref_compile.ExprCompiler.for_page(ref_page).compile(ref_e)(ref_page)
        pd, pv = port_compile.ExprCompiler.for_page(port_page).compile(port_e)(port_page)
        rd, rv, pd = np.asarray(rd), np.asarray(rv), pd.numpy()
        np.testing.assert_array_equal(pv.numpy(), rv)
        if pd.dtype == np.float64:
            assert np.array_equal(np.isnan(pd[rv]), np.isnan(rd[rv]))
            ok = ~np.isnan(rd[rv])
            np.testing.assert_array_equal(pd[rv][ok].view(np.int64), rd[rv][ok].view(np.int64))
        else:
            np.testing.assert_array_equal(pd[rv], rd[rv])


def test_subnormals_flush_in_the_reference_only():
    """A difference of mechanism, pinned: XLA's CPU backend flushes
    subnormal doubles to zero, inputs and results (exp(-740) is 0 and
    sign(-1e-310) is 0 there); the port keeps IEEE subnormals, as the
    card does.  The parity cases above keep their doubles normal."""
    import jax.numpy as jnp
    import torch

    assert float(jnp.exp(jnp.asarray(-740.0))) == 0.0
    assert float(jnp.sign(jnp.asarray(-1e-310))) == 0.0
    got = k1.dun_plain(k1.DUN_FNS.index("exp"), torch.tensor([-740.0], dtype=torch.float64))
    assert 0.0 < float(got[0]) < 1e-308
    sign = k1.dun_plain(k1.DUN_FNS.index("sign"), torch.tensor([-1e-310], dtype=torch.float64))
    assert int(sign[0]) == -1


@pytest.mark.parametrize("sql,want", [
    ("select mod(-7.5e0, 2e0), mod(7.5e0, -2e0)", (0.5, -0.5)),
    ("select mod(-7, 2), mod(7, -2), -7 / 2", (-1, 1, -3)),
    ("select bitwise_shift_left(1, 70, 64), bitwise_shift_left(2, 70, 64), "
     "bitwise_shift_left(7, 2, 4), bit_count(-1, 8)", (64, 128, 12, 8)),
], ids=["double_mod_floors", "integer_mod_truncates", "shift_counts"])
def test_edges_pinned(sql, want):
    """Pinned edges, each equal to the reference: a double mod floors as
    jnp.mod does (Presto's answer to mod(-7.5, 2) is -1.5: a reference
    fault, ROADMAP C, that the port follows); integer mod and div
    truncate; a shift count past 63 wraps (70 acts as 6); bits narrow
    the field."""
    pair = _pair()
    assert tuple(pair.check(sql)[0]) == want


_PAIR = []


def _pair() -> TpchPair:
    if not _PAIR:
        _PAIR.append(TpchPair())
    return _PAIR[0]


# the reference suites' SQL in the slice (each equal to the reference's rows)
SCALAR_SQL = [
    # tests/test_scalar_functions.py CASES (all but length/strpos)
    "select s_suppkey, abs(s_acctbal), sign(s_acctbal) from supplier",
    "select s_suppkey, round(s_acctbal), round(s_acctbal, 1) from supplier",
    "select s_suppkey, ceil(s_acctbal), floor(s_acctbal) from supplier",
    "select o_orderkey, sqrt(o_totalprice), ln(o_totalprice), log10(o_totalprice) "
    "from orders limit 500",
    "select o_orderkey, power(o_shippriority + 2, 3) from orders limit 100",
    "select s_suppkey, greatest(s_acctbal, 0.0), least(s_acctbal, 0.0) from supplier",
    "select s_suppkey, nullif(s_nationkey, 7) from supplier",
    "select n_nationkey, lower(n_name), reverse(n_name) from nation",
    "select o_orderkey, day_of_week(o_orderdate), day_of_year(o_orderdate), "
    "quarter(o_orderdate) from orders limit 500",
    "select l_orderkey, l_linenumber, mod(l_quantity, 7) from lineitem limit 500",
    "select coalesce(nullif(n_regionkey, 0), n_nationkey) from nation",
    # tests/test_function_breadth.py :382, the math sweep and constants
    "SELECT sin(pi()/2), cos(0), tan(0), atan2(1, 1), log2(8), degrees(pi()), "
    "radians(180e0), truncate(-2.7e0), width_bucket(3.5, 0, 10, 5), is_nan(sqrt(-1e0)), "
    "is_finite(1e0), sinh(0), cosh(0), tanh(0), e()",
    # tests/test_scalar_breadth2.py: bitwise, NaN/infinity, casts, dates
    "select bitwise_and(19, 25), bitwise_or(19, 25), bitwise_xor(19, 25), bitwise_not(19), "
    "bitwise_shift_left(1, 5, 64), bitwise_shift_right(-8, 2, 64), "
    "bitwise_shift_left(7, 2, 4)",
    "select bit_count(7, 64), bit_count(-1, 64), bit_count(-1, 8), bit_count(9, 64)",
    "select o_orderkey, bitwise_and(o_orderkey, 255), bitwise_xor(o_orderkey, 7) "
    "from orders limit 100",
    "select bitwise_shift_left(1, 64, 64), bitwise_shift_left(1, 65, 64), "
    "bitwise_shift_right(8, 1, 64)",
    "select is_nan(nan()), is_infinite(infinity()), is_infinite(1.5), infinity() > 1e300",
    "select cast('42' as bigint), cast('2.5' as double), cast('abc' as bigint), "
    "cast('99999999999999999999' as bigint), cast('1_0' as bigint), cast(' 7 ' as bigint), "
    "cast('1.5e3' as double), cast('Infinity' as double), cast('1_0.5' as double)",
    "select last_day_of_month(date '2020-02-10'), last_day_of_month(date '2021-12-31')",
    "select o_orderdate, last_day_of_month(o_orderdate) from orders limit 200",
    "select o_orderdate, week(o_orderdate), week_of_year(o_orderdate), "
    "year_of_week(o_orderdate), yow(o_orderdate) from orders limit 300",
    "select o_orderdate, day_of_month(o_orderdate), doy(o_orderdate), dow(o_orderdate) "
    "from orders limit 100",
    # cast_bigint over columns (HALF_UP from a short decimal, toward zero from a double)
    "select o_orderkey, cast(o_totalprice as bigint), cast(o_totalprice / 3 as bigint) "
    "from orders where o_orderkey < 200",
]


@pytest.mark.parametrize("i", range(len(SCALAR_SQL)))
def test_scalar_sql_equals_reference(i):
    _pair().check(SCALAR_SQL[i])


def test_math_sweep_values():
    """The reference suite's assertions on the math sweep, through the
    port (tests/test_function_breadth.py test_trig_and_math_sweep)."""
    rows = _pair().port.execute(SCALAR_SQL[11]).rows[0]
    assert rows[0] == pytest.approx(1.0) and rows[3] == pytest.approx(math.pi / 4)
    assert rows[4] == 3.0 and rows[5] == pytest.approx(180.0)
    assert rows[6] == pytest.approx(math.pi) and rows[7] == -2.0 and rows[8] == 2
    assert rows[9] is True and rows[10] is True and rows[12] == 1.0
    assert rows[14] == pytest.approx(math.e)


@pytest.mark.parametrize("sql,what", [
    ("select jaccard_index(make_set_digest(n_nationkey), make_set_digest(n_regionkey)) "
     "from nation", None),
    ("select cast(l_extendedprice as decimal(38,2)) + l_tax from lineitem", None),
    ("select round(cast(l_tax as real), 1) from lineitem", "round of real"),
], ids=["setdigest", "decimal38", "round_real"])
def test_deferred_scalar_families_raise_by_name(sql, what):
    """The families a later slice ports raise NotPorted by name; a
    family a later slice ported (``what`` None: the set digests, the
    twelfth slice; DECIMAL(38), the thirteenth) equals the reference (a
    raw varchar's functions, the fourteenth: tests/test_torch_rawstring.py
    and tests/test_torch_string_fns.py)."""
    if what is None:
        _pair().check(sql)
        return
    with pytest.raises(NotPorted) as e:
        _pair().port.execute(sql)
    assert e.value.what == what


@pytest.mark.parametrize("sql", [
    "select split(n_name, 'A') from nation",
    "select row(n_nationkey, n_regionkey) from nation",
], ids=["split", "row"])
def test_former_scalar_pins_equal_reference(sql):
    """Pinned as NotPorted ("dictionary of string expression split",
    "expression row_construct") until the tenth slice ported ARRAY, MAP
    and ROW values."""
    _pair().check(sql)


@pytest.mark.parametrize("sql", [
    "select length(c_name) from customer",
    "select date_format(o_orderdate, '%Y') from orders",
    "select cast(n_name as bigint) from nation",
    "select try(1 / 0)",
], ids=["string_functions", "date_format", "cast_of_a_varchar_column", "try"])
def test_former_pin_equals_reference(sql):
    """Pinned as NotPorted until the ninth slice ported them (the string
    functions over dictionaries, date_format, CAST of a varchar column,
    try); now equal to the reference."""
    _pair().check(sql)
