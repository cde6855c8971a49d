"""The eleventh slice's scalar types at kernel level: REAL, SMALLINT,
TINYINT and INTERVAL values through K1 ``expr_eval`` (the narrowing
casts with their out-of-range NULL, REAL arithmetic, IN over a double,
interval and narrow-integer arithmetic), the K2/K3/K6 states over them
(``grouped_aggregate``, ``combine_packed_states``, ``finalize_packed``,
``merge_aggregate``), K7 with a REAL key, the ORDER BY ... LIMIT path
past K7's ``MAX_N`` and K10 over a REAL argument, each against the
reference's function on XLA:CPU over the same numpy-seeded page (NULLs
and dead rows included), through the port's plain twins.

Tolerances: integers, intervals and REALs exactly (REALs bit for bit);
the doubles a REAL's sum adds within a relative 1e-9 (the port adds in
its fixed order, the reference in its own); every other double bit for
bit.  No subnormal float32 value or result: XLA's CPU backend flushes
them to zero, the port and the card keep them."""

import numpy as np
import pytest
import jax.numpy as jnp

from presto_tpu.expr import compile as ref_compile
from presto_tpu.expr import ir as ref_ir
from presto_tpu.ops import aggregate as ref_agg
from presto_tpu.ops import sort as ref_sort
from presto_tpu.ops import window as ref_window
from presto_tpu.page import Block as RefBlock, Page as RefPage
from presto_tpu import types as ref_types
from presto_tpu_torch.expr import compile as port_compile
from presto_tpu_torch.expr import ir as port_ir
from presto_tpu_torch.kernels import expr_eval as k1
from presto_tpu_torch.kernels import topn as k7
from presto_tpu_torch.ops import aggregate as port_agg
from presto_tpu_torch.ops import sort as port_sort
from presto_tpu_torch.ops import window as port_window
from presto_tpu_torch import types as port_types
from torch_fn_parity import C, F, L, build
from torch_parity import numpy_state, with_nulls_and_dead_rows

MICROS_PER_DAY = 86_400_000_000


def _type_parser(types_module):
    """The package's ``parse_type``, plus the two interval types (which
    only the binder names)."""
    intervals = {"interval day to second": types_module.INTERVAL_DAY_SECOND,
                 "interval year to month": types_module.INTERVAL_YEAR_MONTH}
    return lambda s: intervals.get(s) or types_module.parse_type(s)


ref_type, port_type = _type_parser(ref_types), _type_parser(port_types)


def to_port(ref_page: RefPage):
    """The port Page holding exactly ``ref_page``'s state (its types by
    the parser above)."""
    import torch

    from presto_tpu_torch.page import Block, Page

    cols, valids, mask, types, _ = numpy_state(ref_page)
    return Page(tuple(Block(torch.from_numpy(np.array(c)), torch.from_numpy(np.array(v)),
                            port_type(t)) for c, v, t in zip(cols, valids, types)),
                torch.from_numpy(np.array(mask)))
COLUMNS = [("r", "real"), ("s", "real"), ("f", "real"), ("h", "smallint"), ("t", "tinyint"),
           ("a", "bigint"), ("x", "double"), ("d", "decimal(12,2)"), ("l", "decimal(36,4)"),
           ("i", "integer"), ("ts", "timestamp"), ("ts2", "timestamp"),
           ("iv", "interval day to second"), ("ym", "interval year to month"),
           ("k", "bigint")]
# float32 edges: signed zeros, infinities, halves, a value whose products
# overflow, and a tie of float32 rounding; none whose quotients turn
# subnormal
REAL_EDGES = np.array([0.0, -0.0, np.inf, -np.inf, 0.5, -2.5, 1e25, -1.5,
                       16777217.0, 1.0000001], dtype=np.float32)
# bigint edges for the narrowing casts and the int64 -> float32 cast
INT_EDGES = np.array([32767, 32768, -32768, -32769, 127, 128, -128, -129, (1 << 53) + 1,
                      (1 << 62) + 3, -(1 << 63), (1 << 63) - 1, 0, -1], dtype=np.int64)


def types_page(seed: int, n: int = 2048, nan: bool = False) -> RefPage:
    """A reference page of ``COLUMNS`` with NULLs and dead rows: REALs
    over many magnitudes (products and quotients stay normal) with their
    edges (NaN too with ``nan``), finite REALs (``f``: a double sum in
    another order, or a key hashed by its truncation, meets no infinity,
    where the reference's cumsum turns later groups' sums NaN and XLA
    and torch convert an infinity to int64 apart), SMALLINT and TINYINT
    over their whole
    range, bigint edges around the narrow ranges, doubles past float32's
    range, decimals with .50 ties, long decimals, timestamps before and
    after 1970, intervals of both kinds, a small key."""
    rng = np.random.default_rng(seed)

    def reals():
        x = (rng.normal(size=n) * 10.0 ** rng.uniform(-6, 6, n)).astype(np.float32)
        pick = rng.random(n) < 0.1
        edges = np.concatenate([REAL_EDGES, [np.nan]]) if nan else REAL_EDGES
        x[pick] = rng.choice(edges, pick.sum())
        return x

    a = rng.integers(-10 ** 6, 10 ** 6, n)
    pick = rng.random(n) < 0.3
    a[pick] = rng.choice(INT_EDGES, pick.sum())
    x = rng.normal(size=n) * 10.0 ** rng.uniform(-3, 40, n)
    d = rng.integers(-10 ** 9, 10 ** 9, n)
    d[rng.random(n) < 0.2] = rng.choice([250, -250, 350, -350, 3276750, -3276850, 0])
    ts = rng.integers(-10 ** 6, 10 ** 6, n) * 10 ** 6 + rng.integers(0, 10 ** 6, n)
    data = {
        "r": reals(), "s": reals(),
        "f": np.round(rng.normal(size=n) * 10.0 ** rng.uniform(-2, 3, n), 2).astype(np.float32),
        "h": rng.integers(-32768, 32768, n).astype(np.int16),
        "t": rng.integers(-128, 128, n).astype(np.int8), "a": a, "x": x, "d": d,
        "l": np.stack([rng.integers(-10 ** 3, 10 ** 3, n), rng.integers(0, 10 ** 18, n)], 1),
        "i": rng.integers(-(1 << 31), 1 << 31, n).astype(np.int32),
        "ts": ts, "ts2": ts + rng.integers(-3, 3, n) * MICROS_PER_DAY
        + rng.integers(-10 ** 10, 10 ** 10, n),
        "iv": rng.integers(-10 ** 12, 10 ** 12, n), "ym": rng.integers(-500, 500, n),
        "k": rng.integers(0, 40, n),
    }
    blocks = [RefBlock(jnp.asarray(data[c]), jnp.ones(n, jnp.bool_), ref_type(t))
              for c, t in COLUMNS]
    return with_nulls_and_dead_rows(RefPage(tuple(blocks), jnp.ones(n, jnp.bool_)), rng)


R, S, FR, H, T, A, X, D, LL, I = (C(c) for c in "r s f h t a x d l i".split())


def _idx(name):
    return [c for c, _ in COLUMNS].index(name)
TS, TS2, IV, YM, K = C("ts"), C("ts2"), C("iv"), C("ym"), C("k")
IDS = "interval day to second"
SPECS = {
    # the narrowing casts: a decimal floor-divided (or through a double
    # for a REAL), an integer straight to float32, out of range NULL
    "cast_real_decimal": F("cast_real", "real", D),
    "cast_real_long": F("cast_real", "real", LL),
    "cast_real_double": F("cast_real", "real", X),
    "cast_real_bigint": F("cast_real", "real", A),
    "cast_real_integer": F("cast_real", "real", I),
    "cast_real_smallint": F("cast_real", "real", H),
    "cast_smallint_bigint": F("cast_smallint", "smallint", A),
    "cast_smallint_decimal": F("cast_smallint", "smallint", D),
    "cast_smallint_double": F("cast_smallint", "smallint", X),
    "cast_smallint_real": F("cast_smallint", "smallint", R),
    "cast_smallint_long": F("cast_smallint", "smallint", LL),
    "cast_smallint_tinyint": F("cast_smallint", "smallint", T),
    "cast_tinyint_bigint": F("cast_tinyint", "tinyint", A),
    "cast_tinyint_smallint": F("cast_tinyint", "tinyint", H),
    "cast_tinyint_decimal": F("cast_tinyint", "tinyint", D),
    "cast_double_real": F("cast_double", "double", R),
    "cast_bigint_real": F("cast_bigint", "bigint", R),
    # REAL arithmetic: both sides as float32, the result rounded once
    "real_add": F("add", "real", R, S), "real_sub": F("sub", "real", R, S),
    "real_mul": F("mul", "real", R, S), "real_div": F("div", "real", R, S),
    "real_mod": F("mod", "real", R, S),
    "real_div_zero": F("div", "real", R, L(0.0, "real")),
    "real_mod_zero": F("mod", "real", R, L(0.0, "real")),
    "real_add_decimal": F("add", "real", R, D), "real_mul_decimal": F("mul", "real", D, R),
    "real_sub_literal": F("sub", "real", L(1, "bigint"), R),
    "real_add_integer": F("add", "real", R, I),
    "real_neg": F("neg", "real", R), "real_abs": F("abs", "real", R),
    "real_times_double": F("mul", "double", R, X),
    "real_lt": F("lt", "boolean", R, S), "real_eq_decimal": F("eq", "boolean", R, D),
    "real_gt_literal": F("gt", "boolean", R, L(15, "decimal(2,1)")),
    "real_ge_double": F("ge", "boolean", R, X),
    "real_coalesce": F("coalesce", "real", R, S, L(2.5, "real")),
    "real_case": F("if", "real", F("gt", "boolean", A, L(0, "bigint")), R, L(0, "bigint")),
    "real_greatest": F("greatest", "real", R, S),
    # IN over a double lane: == against each literal (a REAL column in
    # float32: each literal rounds first)
    "in_double": F("in", "boolean", X, L(0.5, "double"), L(-0.0, "double"),
                   L(1e300, "double")),
    "in_real": F("in", "boolean", R, L(0.5, "double"), L(0.1, "double"), L(-2.5, "double"),
                 L(0, "bigint")),
    "in_real_decimal_cast": F("in", "boolean", F("cast_double", "double", D),
                              L(2.5, "double"), L(-3.5, "double")),
    # intervals: int64 lanes of micros or months, NULL where they wrap
    "interval_ts_sub": F("sub", IDS, TS, TS2),
    "interval_add": F("add", IDS, IV, IV),
    "interval_sub": F("sub", IDS, IV, F("mul", IDS, IV, L(3, "bigint"))),
    "interval_times_int": F("mul", IDS, IV, I),
    "interval_ym_add": F("add", "interval year to month", YM, YM),
    "interval_neg": F("neg", IDS, IV),
    "interval_plus_ts": F("ts_add_micros", "timestamp", TS, IV),
    "interval_div_double": F("cast_bigint", IDS, F("div", "double", IV, L(2.5, "double"))),
    "interval_lt": F("lt", "boolean", IV, F("sub", IDS, TS, TS2)),
    # narrow integer arithmetic: exact, NULL where the width overflows
    "smallint_add": F("add", "smallint", H, H), "smallint_mul": F("mul", "smallint", H, T),
    "smallint_div": F("div", "smallint", H, T), "smallint_mod": F("mod", "smallint", H, T),
    "tinyint_sub": F("sub", "tinyint", T, T), "integer_add": F("add", "integer", I, I),
    "integer_mul": F("mul", "integer", I, H), "smallint_neg": F("neg", "smallint", H),
    "tinyint_abs": F("abs", "tinyint", T), "smallint_plus_bigint": F("add", "bigint", H, A),
    "smallint_in": F("in", "boolean", H, L(1, "bigint"), L(-32768, "bigint")),
    "tinyint_eq_decimal": F("eq", "boolean", T, D),
}


def _lanes(name, spec, page_seed=None, nan=False):
    ref_page = types_page(page_seed if page_seed is not None else sum(map(ord, name)), nan=nan)
    port_page = to_port(ref_page)
    ref_e = build(spec, ref_ir, ref_type, COLUMNS)
    port_e = build(spec, port_ir, port_type, COLUMNS)
    rd, rv = ref_compile.ExprCompiler.for_page(ref_page).compile(ref_e)(ref_page)
    pd, pv = port_compile.ExprCompiler.for_page(port_page).compile(port_e)(port_page)
    return np.asarray(rd), np.asarray(rv), pd.numpy(), pv.numpy()


def _assert_bits(pd, pv, rd, rv, what):
    """Valid masks equal; data equal where valid, floats by their bits (a
    NaN as a NaN: its sign bit is not kept)."""
    np.testing.assert_array_equal(pv, rv, err_msg=f"{what} valid")
    assert pd.dtype == rd.dtype, (what, pd.dtype, rd.dtype)
    p, r = pd[rv], rd[rv]
    if p.dtype.kind == "f":
        nan = np.isnan(r)
        np.testing.assert_array_equal(np.isnan(p), nan, err_msg=what)
        ints = np.int64 if p.dtype == np.float64 else np.int32
        p, r = p[~nan].view(ints), r[~nan].view(ints)
    np.testing.assert_array_equal(p, r, err_msg=what)


@pytest.mark.parametrize("name", sorted(SPECS))
def test_expression_equals_reference(name):
    """K1's twin against the reference's ExprCompiler, bit for bit."""
    rd, rv, pd, pv = _lanes(name, SPECS[name])
    _assert_bits(pd, pv, rd, rv, name)


def test_in_over_double_with_nan_and_signed_zero():
    """NaN matches no literal and -0.0 equals 0.0, as ``==`` compares."""
    spec = F("in", "boolean", R, L(0.0, "double"), L(float("nan"), "double"))
    rd, rv, pd, pv = _lanes("in_nan", spec, page_seed=3, nan=True)
    _assert_bits(pd, pv, rd, rv, "in_nan")
    page = to_port(types_page(3, nan=True))
    r = page.blocks[0].data.numpy()
    hit = pd & pv
    assert not hit[np.isnan(r)].any() and hit[(r == 0) & pv].all()


@pytest.mark.parametrize("op", ["add", "sub", "mul", "div", "mod"])
def test_real_ops_bit_equal_jnp_float32(op):
    """REAL on the double lane, rounded once (F32R), against jnp.float32
    arithmetic over random magnitudes and the edges: the double result
    rounded to float32 is the float32 result (53 >= 2 * 24 + 2), bit for
    bit.  Magnitudes keep every product and quotient normal."""
    rng = np.random.default_rng(11)
    n = 1 << 16
    a = (rng.normal(size=n) * 10.0 ** rng.uniform(-15, 15, n)).astype(np.float32)
    b = (rng.normal(size=n) * 10.0 ** rng.uniform(-15, 15, n)).astype(np.float32)
    a[:REAL_EDGES.size], b[-REAL_EDGES.size:] = REAL_EDGES, REAL_EDGES
    a[REAL_EDGES.size:2 * REAL_EDGES.size] = np.nextafter(b[:REAL_EDGES.size], np.inf)
    cols = [("p", "real"), ("q", "real")]
    blocks = [RefBlock(jnp.asarray(v), jnp.ones(n, jnp.bool_), ref_type("real"))
              for v in (a, b)]
    ref_page = RefPage(tuple(blocks), jnp.ones(n, jnp.bool_))
    spec = F(op, "real", C("p"), C("q"))
    port_page = to_port(ref_page)
    pd, pv = port_compile.ExprCompiler.for_page(port_page).compile(
        build(spec, port_ir, port_type, cols))(port_page)
    ja, jb = jnp.asarray(a), jnp.asarray(b)
    safe = jnp.where(jb == 0, jnp.float32(1.0), jb)
    want = {"add": ja + jb, "sub": ja - jb, "mul": ja * jb, "div": ja / safe,
            "mod": jnp.mod(ja, safe)}[op]
    rv = np.ones(n, np.bool_) if op in ("add", "sub", "mul") else b != 0
    _assert_bits(pd.numpy(), pv.numpy(), np.asarray(want), rv, op)


def test_narrowing_casts_null_out_of_range_and_keep_in_range():
    """cast_smallint / cast_tinyint NULL a value past their range rather
    than wrapping it, and keep every value inside it."""
    rd, rv, pd, pv = _lanes("range", F("cast_smallint", "smallint", A), page_seed=5)
    _assert_bits(pd, pv, rd, rv, "range")
    a = to_port(types_page(5)).blocks[_idx("a")]
    src, ok = a.data.numpy(), a.valid.numpy()
    fits = (src >= -32768) & (src <= 32767)
    np.testing.assert_array_equal(pv, ok & fits)
    np.testing.assert_array_equal(pd[pv], src[pv].astype(np.int16))
    assert (ok & ~fits).any() and (ok & fits & (np.abs(src) > 32000)).any()


def test_constant_real_folds_on_the_host():
    """A constant REAL expression folds to one DLIT of its float32 value."""
    lw = port_compile._Lowering([])
    e = build(F("mul", "real", F("cast_real", "real", L(15, "decimal(2,1)")),
                L(3, "bigint")), port_ir, port_type, COLUMNS)
    assert lw.emit(e)
    assert lw.ops == [k1.DLIT] and k1.bits_double(lw.consts[lw.args[0]]) == 4.5


# -- aggregates: K2 packed slots, K6 sorted runs and merge, K3 fold -----------

# min/max keep their type (REAL, SMALLINT, TINYINT, intervals), sum and
# avg of a REAL are doubles, of a SMALLINT or TINYINT bigints, of an
# interval intervals (avg HALF_UP)
EXTREMES = [(fn, c) for fn in ("min", "max") for c in (R, S, H, T, IV, YM)]
SUMS = [("sum", H), ("sum", T), ("sum", IV), ("avg", IV), ("avg", H), ("sum", YM),
        ("avg", YM), ("count", R), ("count_star", None)]
REAL_SUMS = [("sum", FR), ("avg", FR)]
KEY_DOMAIN = [(0, 39)]


def _aggs(ir, parse_type, agg_module, specs):
    out = []
    for fn, arg in specs:
        a = build(arg, ir, parse_type, COLUMNS) if arg is not None else None
        call = ir.AggCall(fn=fn, arg=a, type=parse_type("bigint"))
        out.append(ir.AggCall(fn=fn, arg=a, type=agg_module.output_type(call)))
    return out


def _compact_ref(page: RefPage) -> RefPage:
    live = np.nonzero(np.asarray(page.row_mask))[0]
    return RefPage(tuple(RefBlock(jnp.asarray(np.asarray(b.data)[live]),
                                  jnp.asarray(np.asarray(b.valid)[live]), b.type,
                                  b.dictionary) for b in page.blocks),
                   jnp.ones(live.shape[0], jnp.bool_))


def _states_equal(port, ref, aggs, num_keys, mode):
    """Keys and row masks exactly; a partial state where its count is
    positive and every count exactly; a final value where valid.  REAL,
    integer and interval values exactly, a REAL sum's doubles within a
    relative 1e-9."""
    assert [str(b.type) for b in port.blocks] == [str(b.type) for b in ref.blocks]
    mask = np.asarray(ref.row_mask)
    np.testing.assert_array_equal(port.row_mask.numpy(), mask)
    for pb, rb in zip(port.blocks[:num_keys], ref.blocks[:num_keys]):
        ok = mask & np.asarray(rb.valid)
        np.testing.assert_array_equal(pb.valid.numpy()[mask], np.asarray(rb.valid)[mask])
        np.testing.assert_array_equal(pb.data.numpy()[ok], np.asarray(rb.data)[ok])
    pos = num_keys
    for agg in aggs:
        width = len(port_agg.state_types(agg)) if mode == "partial" else 1
        cols = list(zip(port.blocks[pos:pos + width], ref.blocks[pos:pos + width]))
        pos += width
        if mode == "partial":
            live = mask & (np.asarray(cols[-1][1].data) > 0)
            np.testing.assert_array_equal(cols[-1][0].data.numpy()[mask],
                                          np.asarray(cols[-1][1].data)[mask])
        else:
            live = mask & np.asarray(cols[0][1].valid)
            np.testing.assert_array_equal(cols[0][0].valid.numpy()[mask],
                                          np.asarray(cols[0][1].valid)[mask], agg.fn)
        for pb, rb in cols:
            p, r = pb.data.numpy()[live], np.asarray(rb.data)[live]
            assert p.dtype == r.dtype, (agg.fn, p.dtype, r.dtype)
            if p.dtype == np.float64:  # a REAL's sum or mean
                np.testing.assert_allclose(p, r, rtol=1e-9, atol=0, err_msg=agg.fn)
            elif p.dtype == np.float32:  # a REAL's extreme: its bits
                np.testing.assert_array_equal(p.view(np.int32), r.view(np.int32), agg.fn)
            else:
                np.testing.assert_array_equal(p, r, agg.fn)


def _grouped(seed, specs, keys, kd, mg, mode):
    ref_page = types_page(seed)
    ref = ref_agg.grouped_aggregate(ref_page, [build(k, ref_ir, ref_type, COLUMNS)
                                               for k in keys],
                                    _aggs(ref_ir, ref_type, ref_agg, specs), mg,
                                    key_domains=kd, mode=mode)
    aggs = _aggs(port_ir, port_type, port_agg, specs)
    got = port_agg.grouped_aggregate(to_port(ref_page), [build(k, port_ir, port_type, COLUMNS)
                                                         for k in keys], aggs, mg,
                                     key_domains=kd, mode=mode)
    return got, ref, aggs


# two sets of aggregates, each within K6's 32 states
AGG_SETS = {"extremes": EXTREMES, "sums": SUMS + REAL_SUMS}


@pytest.mark.parametrize("mode", ["partial", "single"])
@pytest.mark.parametrize("aggs", sorted(AGG_SETS))
@pytest.mark.parametrize("path", ["global", "packed", "sorted", "narrow_keys"])
def test_aggregates_over_narrow_types_equal_reference(path, aggs, mode):
    """K2's global and packed-direct slots (the REAL sums only globally:
    a keyed double state takes the sort path), K6's runs by a hashed key
    and by SMALLINT, TINYINT and REAL keys (K9 over them)."""
    keys = {"global": [], "packed": [K], "sorted": [K], "narrow_keys": [H, T, FR]}[path]
    specs = [a for a in AGG_SETS[aggs] if path != "packed" or a not in REAL_SUMS]
    kd = {"global": None, "packed": KEY_DOMAIN}.get(path, [None] * len(keys))
    mg = {"global": 1, "packed": 64}.get(path, 1 << 16)
    got, ref, aggs = _grouped({"global": 1, "packed": 2, "sorted": 3, "narrow_keys": 4}[path],
                              specs, keys, kd, mg, mode)
    if path in ("sorted", "narrow_keys"):  # each group once, in key order
        ref = _compact_ref(ref)
        assert got.capacity == ref.capacity
    _states_equal(got, ref, aggs, len(keys), mode)


@pytest.mark.parametrize("num_keys", [0, 1])
def test_fold_and_finalize_equal_reference(num_keys):
    """combine_packed_states of two splits' partials (K3 folds REAL,
    SMALLINT, TINYINT and interval extremes in their storage, and the
    sums), then finalize_packed (FIN_VALUE, an interval's HALF_UP avg)."""
    specs = EXTREMES + SUMS + ([] if num_keys else REAL_SUMS)
    keys, kd, mg = ([K], KEY_DOMAIN, 64) if num_keys else ([], None, 1)
    parts = [_grouped(seed, specs, keys, kd, mg, "partial") for seed in (6, 7)]
    aggs = parts[0][2]
    ref_aggs = _aggs(ref_ir, ref_type, ref_agg, specs)
    ref_fold = ref_agg.combine_packed_states(parts[0][1], parts[1][1], num_keys, ref_aggs)
    port_fold = port_agg.combine_packed_states(parts[0][0], parts[1][0], num_keys, aggs)
    _states_equal(port_fold, ref_fold, aggs, num_keys, "partial")
    _states_equal(port_agg.finalize_packed(port_fold, num_keys, aggs),
                  ref_agg.finalize_packed(ref_fold, num_keys, ref_aggs), aggs, num_keys,
                  "single")


@pytest.mark.parametrize("aggs", sorted(AGG_SETS))
def test_merge_equals_reference(aggs):
    """merge_aggregate of two sort-path partials (K6's merge of the REAL,
    SMALLINT, TINYINT and interval states), finalized."""
    from presto_tpu.page import concat_pages_host as ref_concat
    from presto_tpu_torch.page import concat_pages_device

    specs = AGG_SETS[aggs]
    parts = [_grouped(seed, specs, [K], [None], 1 << 16, "partial") for seed in (8, 9)]
    aggs, ref_aggs = parts[0][2], _aggs(ref_ir, ref_type, ref_agg, specs)
    ref = ref_agg.merge_aggregate(ref_concat([p[1] for p in parts]), 1, ref_aggs, 1 << 16,
                                  key_domains=[None], mode="single")
    got = port_agg.merge_aggregate(concat_pages_device([p[0] for p in parts]), 1, aggs,
                                   1 << 16, key_domains=[None], mode="single")
    ref = _compact_ref(ref)
    _states_equal(got, ref, aggs, 1, "single")


def test_real_extremes_follow_the_reference():
    """min/max over REALs with NaN and signed zeros (NaN wins both, -0.0
    below 0.0) and empty groups (+inf / -inf), on K2 and K6."""
    specs = [("min", R), ("max", R), ("count_star", None)]
    for keys, kd, mg in (([], None, 1), ([K], KEY_DOMAIN, 64), ([K], [None], 1 << 16)):
        ref_page = types_page(10, nan=True)
        ref = ref_agg.grouped_aggregate(ref_page, [build(k, ref_ir, ref_type, COLUMNS)
                                                   for k in keys],
                                        _aggs(ref_ir, ref_type, ref_agg, specs), mg,
                                        key_domains=kd, mode="partial")
        aggs = _aggs(port_ir, port_type, port_agg, specs)
        got = port_agg.grouped_aggregate(to_port(ref_page),
                                         [build(k, port_ir, port_type, COLUMNS)
                                          for k in keys], aggs, mg, key_domains=kd,
                                         mode="partial")
        if kd == [None]:
            ref = _compact_ref(ref)
        mask = np.asarray(ref.row_mask)
        for j in (len(keys), len(keys) + 2):
            p, r = got.blocks[j].data.numpy()[mask], np.asarray(ref.blocks[j].data)[mask]
            np.testing.assert_array_equal(np.isnan(p), np.isnan(r))
            ok = ~np.isnan(r)
            np.testing.assert_array_equal(p[ok].view(np.int32), r[ok].view(np.int32))


@pytest.mark.parametrize("fn,t", [("min_by", "real"), ("checksum", "smallint"),
                                  ("bitwise_and_agg", "tinyint")])
def test_states_left_out_raise_by_name(fn, t):
    from presto_tpu_torch import NotPorted

    arg = port_ir.ColumnRef(type=port_type(t), index=0)
    agg = port_ir.AggCall(fn=fn, arg=arg, arg2=arg if fn == "min_by" else None,
                          type=port_type("bigint"))
    with pytest.raises(NotPorted) as e:
        port_agg._state_kind(agg)
    assert e.value.what == f"{fn} over {t}"


# -- ORDER BY: K7 with a REAL key, and past MAX_N ---------------------------------

ORDERS = {
    "real_desc": ([R], [False], [False]),
    "real_asc_nulls_first": ([R, K], [True, False], [True, False]),
    "smallint_tinyint": ([H, T], [False, True], [False, True]),
    "interval_real": ([IV, S], [True, False], [True, True]),
}


def _exprs(ir, parse_type, specs):
    return [build(s, ir, parse_type, COLUMNS) for s in specs]


def _tied_page(seed):
    """A types page whose REALs take few values, so keys tie often."""
    ref_page = types_page(seed)
    rng = np.random.default_rng(seed)
    n = ref_page.capacity
    blocks = list(ref_page.blocks)
    for j in (0, 1):
        vals = rng.choice(np.array([0.5, -0.0, 0.0, 2.5, -1.5, np.inf], np.float32), n)
        blocks[j] = RefBlock(jnp.asarray(vals), blocks[j].valid, blocks[j].type)
    h = _idx("h")
    blocks[h] = RefBlock(jnp.asarray(rng.integers(-3, 3, n).astype(np.int16)), blocks[h].valid,
                         blocks[h].type)
    return RefPage(tuple(blocks), ref_page.row_mask)


@pytest.mark.parametrize("order", sorted(ORDERS))
@pytest.mark.parametrize("n", [10, 100, 150, 500])
def test_topn_equals_reference(order, n):
    """K7's twin up to MAX_N (a REAL key orders as its exact double: -0.0
    ties 0.0, NaN last), the sorted page past it: the reference's
    topn_page rows, in order."""
    specs, asc, nf = ORDERS[order]
    ref_page = _tied_page(len(order) + n)
    want = ref_sort.topn_page(ref_page, _exprs(ref_ir, ref_type, specs), asc, n, nf)
    got = port_sort.topn_page(to_port(ref_page), _exprs(port_ir, port_type, specs), asc, n, nf)
    assert got.capacity == n
    assert got.to_pylist() == want.to_pylist()
    assert len(got.to_pylist()) == min(n, int(np.asarray(ref_page.row_mask).sum()))


def test_topn_past_max_n_keeps_the_kernel_bound():
    """K7 itself still refuses n past its MAX_N; topn_page sorts instead."""
    page = to_port(types_page(12))
    keys = port_sort.topn_keys(page, _exprs(port_ir, port_type, [R]), [True])
    with pytest.raises(ValueError):
        k7.topn(keys, page.row_mask, k7.MAX_N + 1)


# -- windows over REAL ----------------------------------------------------------

WINDOW_FUNCS = [("sum", R, None), ("avg", R, None), ("min", S, None), ("max", S, None),
                ("sum", S, ("rows", -2, 1)), ("lag", R, None), ("first_value", S, None),
                ("count", R, None)]


def _window_page(seed):
    """A types page without signed zeros among its REALs (XLA picks either
    zero inside its min/max scan) and with ties in its order keys."""
    ref_page = _tied_page(seed)
    blocks = list(ref_page.blocks)
    for j in (0, 1):
        v = np.asarray(blocks[j].data).copy()
        v[v == 0] = 0.25
        blocks[j] = RefBlock(jnp.asarray(v), blocks[j].valid, blocks[j].type)
    return RefPage(tuple(blocks), ref_page.row_mask)


@pytest.mark.parametrize("shape", ["real_order", "partitioned"])
def test_window_over_real_equals_reference(shape):
    """K10's twin over REAL arguments and a REAL order key: sums and means
    as doubles in the reference's prefix order, extremes as REALs, bit
    for bit."""
    parts, kd, orders, asc = {"real_order": ([], None, [R, A], [False, True]),
                              "partitioned": ([K], KEY_DOMAIN, [S, A], [True, True])}[shape]
    ref_page = _window_page(13 if shape == "real_order" else 14)

    def funcs(mod, ir, parse_type):
        return [mod.WindowFunc(kind=k, arg=build(a, ir, parse_type, COLUMNS), frame=fr)
                for k, a, fr in WINDOW_FUNCS]

    want = ref_window.window_page(ref_page, _exprs(ref_ir, ref_type, parts),
                                  _exprs(ref_ir, ref_type, orders), asc,
                                  funcs(ref_window, ref_ir, ref_type), partition_domains=kd)
    got = port_window.window_page(to_port(ref_page), _exprs(port_ir, port_type, parts),
                                  _exprs(port_ir, port_type, orders), asc,
                                  funcs(port_window, port_ir, port_type), partition_domains=kd)
    base = len(COLUMNS)
    for j, spec in enumerate(WINDOW_FUNCS):
        g, w = got.blocks[base + j], want.blocks[base + j]
        assert str(g.type) == str(w.type), spec
        _assert_bits(g.data.numpy(), g.valid.numpy(), np.asarray(w.data), np.asarray(w.valid),
                     str(spec))
