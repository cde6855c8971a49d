"""The thirteenth slice's wide decimals (decimal(37..38): five base-10^9
limbs, ``presto_tpu/ops/decimal128.py``'s wide layout) through the port's
twins on the CPU, against the reference's functions on the same seeded
numpy inputs: the decimal128 functions, K1's D38 programs against the
reference's ``ExprCompiler``, the K2/K3/K6 wide states against
``grouped_aggregate`` / ``merge_aggregate`` / ``combine_packed_states``,
and K7 with a wide key against ``topn_page``.

The edge values are +-(10^38 - 1), each limb boundary 10^(9k) +- 1,
zero, negatives, NULLs and dead rows, and an up-scale past the five
limbs' 45 digits that wraps (equal in both packages: the top carry
drops).  Two faults of
the reference are pinned beside the port's exact answers (ROADMAP queue
C): a wide x short product over a column raises a broadcast error there,
and an up-scale of a negative wide value comes out as 10^45 - |x| 10^k.
Those products are held against Python's ``Decimal`` at ``prec = 60``.
Ints, decimals and strings compare exactly, doubles within a relative
1e-9."""

import decimal
from decimal import Decimal

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from presto_tpu.expr import compile as ref_compile
from presto_tpu.expr import ir as ref_ir
from presto_tpu.ops import aggregate as ref_agg
from presto_tpu.ops import decimal128 as ref_d128
from presto_tpu.ops import sort as ref_sort
from presto_tpu.page import Block as RefBlock, Dictionary as RefDictionary, Page as RefPage
from presto_tpu.types import parse_type as ref_type
from presto_tpu_torch import NotPorted
from presto_tpu_torch.expr import compile as port_compile
from presto_tpu_torch.expr import ir as port_ir
from presto_tpu_torch.kernels import expr_eval as k1
from presto_tpu_torch.kernels import packed_fold_finalize as k3
from presto_tpu_torch.kernels import topn as k7
from presto_tpu_torch.ops import aggregate as port_agg
from presto_tpu_torch.ops import decimal128 as d128
from presto_tpu_torch.ops import sort as port_sort
from presto_tpu_torch.types import parse_type as port_type
from torch_fn_parity import C, F, L, build
from torch_parity import to_port, with_nulls_and_dead_rows

decimal.getcontext().prec = 60  # a 38-digit product must not round at 28

MAX38 = 10 ** 38 - 1
# +-(10^38 - 1), each limb boundary 10^(9k) +- 1, zero, small negatives
EDGES = [MAX38, -MAX38, 0, 1, -1] + [s * (10 ** (9 * k) + d) for k in (1, 2, 3, 4)
                                     for d in (-1, 0, 1) for s in (1, -1)]


def wide_values(rng: np.random.Generator, n: int, digits: int = 38, signed: bool = True):
    """``n`` python ints of up to ``digits`` digits (every magnitude
    from 1 digit up), a tenth of them edge values, signed or not."""
    out = []
    for _ in range(n):
        d = int(rng.integers(1, digits + 1))
        v = 0
        for _ in range(5):
            v = v * 10 ** 9 + int(rng.integers(0, 10 ** 9))
        v %= 10 ** d
        out.append(-v if signed and rng.random() < 0.5 else v)
    edges = [e for e in EDGES if abs(e) < 10 ** digits]
    for i in rng.choice(n, n // 10, replace=False):
        e = edges[int(rng.integers(0, len(edges)))]
        out[i] = e if signed else abs(e)
    return out


def both(values, limbs: int = 5):
    """The same limbs as a reference array and a port tensor."""
    arr = ref_d128.encode_py(values, len(values), limbs=limbs)
    return jnp.asarray(arr), torch.from_numpy(arr.copy())


def ints(x) -> list:
    return ref_d128.decode_py(np.asarray(x))


# -- decimal128 -----------------------------------------------------------------

@pytest.mark.parametrize("fn", ["add", "sub"])
def test_add_sub_and_neg_equal_the_reference(fn):
    rng = np.random.default_rng(1)
    a, b = wide_values(rng, 400), wide_values(rng, 400)
    (ra, pa), (rb, pb) = both(a), both(b)
    got = getattr(d128, fn)(pa, pb)
    np.testing.assert_array_equal(got.numpy(), np.asarray(getattr(ref_d128, fn)(ra, rb)))
    np.testing.assert_array_equal(d128.neg(pa).numpy(), np.asarray(ref_d128.neg(ra)))
    assert ints(got) == [x + y if fn == "add" else x - y for x, y in zip(a, b)]


def test_norm_widen_from_int64_and_sum_limbs_equal_the_reference():
    """_norm_wide over unnormalised limbs (sums of many rows), widen of
    two limbs, from_int64 into five, to/from_sum_limbs' wide identity."""
    rng = np.random.default_rng(2)
    raw = rng.integers(-(10 ** 15), 10 ** 15, (300, 5))
    np.testing.assert_array_equal(d128._norm_wide(torch.from_numpy(raw)).numpy(),
                                  np.asarray(ref_d128._norm_wide(jnp.asarray(raw))))
    longs = [v for v in wide_values(rng, 300, digits=36)]
    rl, pl = both(longs, limbs=2)
    np.testing.assert_array_equal(d128.widen(pl).numpy(), np.asarray(ref_d128.widen(rl)))
    assert ints(d128.widen(pl)) == longs
    x = rng.integers(-(1 << 62), 1 << 62, 300)
    x[:3] = [(1 << 63) - 1, -(1 << 63), 0]
    np.testing.assert_array_equal(
        d128.from_int64(torch.from_numpy(x), 5).numpy(),
        np.asarray(ref_d128.from_int64(jnp.asarray(x), limbs=5)))
    rw, pw = both(wide_values(rng, 300))
    np.testing.assert_array_equal(d128.to_sum_limbs(pw).numpy(),
                                  np.asarray(ref_d128.to_sum_limbs(rw)))
    np.testing.assert_array_equal(d128.from_sum_limbs(torch.from_numpy(raw)).numpy(),
                                  np.asarray(ref_d128.from_sum_limbs(jnp.asarray(raw))))


@pytest.mark.parametrize("k", [1, 8, 9, 16, 30])
def test_downscale_compare_and_double_equal_the_reference(k):
    """rescale down (floor division in steps of 10^9), compare (lt, eq)
    and to_double (Horner's rule, then one division)."""
    rng = np.random.default_rng(3 + k)
    a, b = wide_values(rng, 300), wide_values(rng, 300)
    b[:50] = a[:50]
    (ra, pa), (rb, pb) = both(a), both(b)
    got = d128.downscale_wide(pa, k)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref_d128.rescale(ra, k, 0)))
    assert ints(got) == [x // 10 ** k for x in a]
    lt, eq = d128.compare(pa, pb)
    rlt, req, _ = ref_d128.compare(ra, rb)
    np.testing.assert_array_equal(lt.numpy(), np.asarray(rlt))
    np.testing.assert_array_equal(eq.numpy(), np.asarray(req))
    np.testing.assert_allclose(d128.to_double(pa, k).numpy(),
                               np.asarray(ref_d128.to_double(ra, k)), rtol=1e-9, atol=0)


@pytest.mark.parametrize("k", [2, 8, 16, 24])
def test_upscale_of_positive_values_equals_the_reference_and_wraps(k):
    """An up-scale of a non-negative wide value equals the reference's:
    exact while it fits the five limbs' 45 digits, the carry past them
    dropped (the magnitude modulo 10^45, never NULL) in both packages."""
    rng = np.random.default_rng(10 + k)
    a = wide_values(rng, 300, signed=False)
    ra, pa = both(a)
    got = d128.upscale(pa, k)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref_d128.rescale(ra, 0, k)))
    assert ints(got) == [x * 10 ** k % 10 ** 45 for x in a]
    assert any(x * 10 ** k >= 10 ** 45 for x in a) == (k >= 8)  # some wrap


def test_upscale_of_a_negative_value_known_fault():
    """A queue-C fault of the reference, pinned: its _shift_digits_wide
    shifts the signed limbs, so the sign limb's floor carry drops and a
    negative value up-scales to 10^45 - |x| 10^k (-1.5 at scale 1 to
    scale 4 gives 99999999999999999999999999999999999999998.5000); the
    port shifts the magnitude and keeps the sign."""
    a = [-15, -1, -(10 ** 30) - 7]
    ra, pa = both(a)
    assert ints(ref_d128.rescale(ra, 1, 4)) == [10 ** 45 - x * -1000 for x in a]
    assert ints(d128.upscale(pa, 3)) == [x * 1000 for x in a]


def test_wide_times_short_over_a_column():
    """mul_wide_small over a column: the port's product equals Python's
    Decimal wherever it fits 38 digits; the reference broadcasts (n, 5)
    limbs against the (n,) column and raises (queue C).  A scalar factor
    (what folds in the reference) equals the reference's."""
    rng = np.random.default_rng(4)
    a = wide_values(rng, 500, digits=22)
    k = [int(x) for x in rng.integers(-(10 ** 15), 10 ** 15, 500)]
    k[:4] = [0, 1, -1, 999_999_999_999_999_999]
    ra, pa = both(a)
    got = ints(d128.mul_wide_small(pa, torch.tensor(k, dtype=torch.int64)))
    want = [int(Decimal(x) * Decimal(y)) for x, y in zip(a, k)]
    assert [g for g, w in zip(got, want) if abs(w) < 10 ** 38] == \
        [w for w in want if abs(w) < 10 ** 38]
    with pytest.raises(ValueError, match="Incompatible shapes for broadcasting"):
        ref_d128.mul_wide_small(ra, jnp.asarray(np.asarray(k, dtype=np.int64)))
    for scalar in (7, -123456789012, 10 ** 17):
        np.testing.assert_array_equal(
            d128.mul_wide_small(pa, torch.tensor(scalar)).numpy(),
            np.asarray(ref_d128.mul_wide_small(ra, jnp.asarray(scalar, jnp.int64))))


def test_avg_equals_the_reference():
    """The wide avg finalize: long division over the limbs, HALF_UP on
    the magnitude (K3's twin and the reference's _avg_decimal128)."""
    rng = np.random.default_rng(5)
    s = wide_values(rng, 300)
    n = rng.integers(1, 10 ** 6, 300)
    n[:3] = [1, 2, 3]
    rs, ps = both(s)
    got = d128.avg_wide(ps, torch.from_numpy(n))
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(ref_agg._avg_decimal128(rs, jnp.asarray(n))))
    fin, = k3.packed_finalize_plain([(k3.FIN_AVG_D38, ps, torch.from_numpy(n))],
                                    torch.ones(300, dtype=torch.bool))
    np.testing.assert_array_equal(fin[0].numpy(), got.numpy())


# -- K1 programs ------------------------------------------------------------------

# the page's columns: wn signed wide values, wp non-negative ones (an
# up-scale of a negative value hits the reference's fault), wq small
# non-negative ones, s a short decimal, l a long one, b a bigint, x a
# double, g a small group key
COLUMNS = [("wn", "decimal(38,2)"), ("wp", "decimal(38,2)"), ("wq", "decimal(38,4)"),
           ("s", "decimal(12,2)"), ("l", "decimal(36,4)"), ("b", "bigint"), ("x", "double"),
           ("g", "bigint"), ("flag", "varchar")]
FLAGS = ["A", "N", "R"]


def wide_page(seed: int, n: int = 1024) -> RefPage:
    rng = np.random.default_rng(seed)
    data = {
        "wn": ref_d128.encode_py(wide_values(rng, n), n, 5),
        "wp": ref_d128.encode_py(wide_values(rng, n, signed=False), n, 5),
        "wq": ref_d128.encode_py(wide_values(rng, n, digits=20, signed=False), n, 5),
        "s": rng.integers(-10 ** 9, 10 ** 9, n),
        "l": ref_d128.encode_py(wide_values(rng, n, digits=30), n, 2),
        "b": rng.integers(-10 ** 6, 10 ** 6, n),
        "x": rng.normal(size=n) * 1e6,
        "g": rng.integers(0, 6, n),
        "flag": rng.integers(0, len(FLAGS), n).astype(np.int32),
    }
    blocks = [RefBlock(jnp.asarray(data[c]), jnp.ones(n, jnp.bool_), ref_type(t),
                       RefDictionary(FLAGS) if t == "varchar" else None) for c, t in COLUMNS]
    return with_nulls_and_dead_rows(RefPage(tuple(blocks), jnp.ones(n, jnp.bool_)), rng)


WN, WP, WQ, S, LG, B, X = C("wn"), C("wp"), C("wq"), C("s"), C("l"), C("b"), C("x")
W = "decimal(38,2)"
SPECS = {
    "add": F("add", W, WN, WP),
    "sub": F("sub", W, WN, WP),
    "add_short": F("add", W, WN, S),
    "add_long_upscale": F("add", "decimal(38,4)", WP, LG),
    "add_int": F("add", W, WN, F("abs", "bigint", B)),
    "neg": F("neg", W, WN),
    "abs": F("abs", W, WN),
    "sign": F("sign", "bigint", WN),
    "lt": F("lt", "boolean", WN, WP),
    "eq_self": F("eq", "boolean", WN, WN),
    "ge_short": F("ge", "boolean", WN, S),
    "gt_long_upscale": F("gt", "boolean", WP, LG),
    "lt_across_scales": F("lt", "boolean", WQ, WP),
    "between": F("between", "boolean", WN, L(-50_000, "decimal(12,2)"),
                 L(10 ** 30, "decimal(38,0)")),
    "is_null": F("is_null", "boolean", WN),
    "to_double": F("cast_double", "double", WN),
    "to_real": F("cast_real", "real", WN),
    "double_arith": F("mul", "double", WN, X),
    "to_bigint": F("cast_bigint", "bigint", WQ),
    "to_short": F("cast_decimal", "decimal(12,2)", WQ),
    "downscale": F("cast_decimal", "decimal(38,0)", WN),
    "upscale_wraps": F("cast_decimal", "decimal(38,20)", WP),
    "short_to_wide": F("cast_decimal", "decimal(38,6)", F("abs", "decimal(12,2)", S)),
    "long_to_wide": F("cast_decimal", "decimal(38,4)", LG),
    "double_to_wide": F("cast_decimal", "decimal(38,2)", X),
    "greatest": F("greatest", W, WN, WP),
    "least": F("least", W, WN, F("neg", W, WP)),
    "coalesce": F("coalesce", W, WN, WP),
    "case": F("case", W, F("gt", "boolean", B, L(0, "bigint")), WN, F("neg", W, WN)),
    "wide_literal": F("add", W, WN, L(12345678901234567890123456789012345678,
                                      "decimal(38,2)")),
    "long_literal": F("add", "decimal(38,4)", WP, L(1234567890123456780000, "decimal(22,4)")),
    "null_literal": F("coalesce", W, L(None, W), WN),
}


@pytest.mark.parametrize("name", sorted(SPECS))
def test_k1_d38_programs_equal_the_reference(name):
    """K1's twin over wide columns against the reference's
    ExprCompiler: valid masks everywhere, limbs and integers exactly
    where valid, doubles within a relative 1e-9."""
    spec = SPECS[name]
    ref_page = wide_page(sum(map(ord, name)))
    port_page = to_port(ref_page)
    ref_e = build(spec, ref_ir, ref_type, COLUMNS)
    port_e = build(spec, port_ir, port_type, COLUMNS)
    rd, rv = ref_compile.ExprCompiler.for_page(ref_page).compile(ref_e)(ref_page)
    prog, _ = port_compile.ExprCompiler.for_page(port_page).lower(port_e)
    assert prog.limbs == 5, prog  # the D38 instance
    pd, pv = port_compile.ExprCompiler.for_page(port_page).compile(port_e)(port_page)
    rd, rv, pd, pv = np.asarray(rd), np.asarray(rv), pd.numpy(), pv.numpy()
    np.testing.assert_array_equal(pv, rv, err_msg=f"{name} valid")
    if pd.dtype.kind == "f":
        np.testing.assert_allclose(pd[rv], rd[rv], rtol=1e-9, atol=0, err_msg=name)
    else:
        np.testing.assert_array_equal(pd[rv], rd[rv], err_msg=name)


@pytest.mark.parametrize("short", ["s", "b"])
def test_k1_wide_times_short_column_is_exact(short):
    """D38MUL over a column equals Python's Decimal (the reference raises
    its broadcast error: queue C)."""
    spec = F("mul", "decimal(38,6)" if short == "s" else "decimal(38,4)", WQ, C(short))
    ref_page = wide_page(7)
    port_page = to_port(ref_page)
    port_e = build(spec, port_ir, port_type, COLUMNS)
    pd, pv = port_compile.ExprCompiler.for_page(port_page).compile(port_e)(port_page)
    idx = {c: i for i, (c, _) in enumerate(COLUMNS)}
    a = ints(ref_page.blocks[idx["wq"]].data)
    k = [int(v) for v in np.asarray(ref_page.blocks[idx[short]].data)]
    va = np.asarray(ref_page.blocks[idx["wq"]].valid) & np.asarray(
        ref_page.blocks[idx[short]].valid)
    np.testing.assert_array_equal(pv.numpy(), va)
    got = ints(pd)
    for i in np.nonzero(va)[0]:
        assert got[i] == int(Decimal(a[i]) * Decimal(k[i]))
    with pytest.raises(ValueError, match="Incompatible shapes for broadcasting"):
        ref_e = build(spec, ref_ir, ref_type, COLUMNS)
        ref_compile.ExprCompiler.for_page(ref_page).compile(ref_e)(ref_page)


def test_nullif_over_wide_values():
    """nullif(a, b) over wide values: the port compares the limbs (a,
    NULL where a = b); the reference compares them elementwise and its
    (n, 5) equality meets the (n,) valid lanes in a broadcast error
    (queue C)."""
    ref_page = wide_page(11, 256)
    idx = {c: i for i, (c, _) in enumerate(COLUMNS)}
    blocks = list(ref_page.blocks)
    wn, wp = blocks[idx["wn"]], blocks[idx["wp"]]
    same = np.arange(256) % 3 == 0  # a third of the rows equal
    wp_data = np.where(same[:, None], np.asarray(wn.data), np.asarray(wp.data))
    blocks[idx["wp"]] = RefBlock(jnp.asarray(wp_data), wp.valid, wp.type)
    ref_page = RefPage(tuple(blocks), ref_page.row_mask)
    spec = F("nullif", W, WN, WP)
    pd, pv = port_compile.ExprCompiler.for_page(to_port(ref_page)).compile(
        build(spec, port_ir, port_type, COLUMNS))(to_port(ref_page))
    va, vb = np.asarray(wn.valid), np.asarray(wp.valid)
    equal = (np.asarray(wn.data) == wp_data).all(axis=1)
    np.testing.assert_array_equal(pv.numpy(), va & ~(va & vb & equal))
    np.testing.assert_array_equal(pd.numpy()[va], np.asarray(wn.data)[va])
    with pytest.raises(ValueError, match="Incompatible shapes for broadcasting"):
        ref_compile.ExprCompiler.for_page(ref_page).compile(
            build(spec, ref_ir, ref_type, COLUMNS))(ref_page)


@pytest.mark.parametrize("spec, what", [
    (F("mul", "decimal(38,4)", WN, WP), "long-decimal x long-decimal mul unsupported"),
    (F("mul", "decimal(38,6)", WN, LG), "long-decimal x long-decimal mul unsupported"),
    (F("mod", W, WN, S), None),
    (F("round", W, WN), "round of decimal(38,2)"),
], ids=["wide_x_wide", "wide_x_long", "mod", "round"])
def test_refusals_raise_by_name(spec, what):
    """A wide x wide or wide x long product, a long-decimal mod and the
    round of a wide decimal stay refused, as in the reference."""
    port_page = to_port(wide_page(8, 64))
    with pytest.raises(NotPorted) as e:
        port_compile.ExprCompiler.for_page(port_page).compile(
            build(spec, port_ir, port_type, COLUMNS))
    if what is not None:
        assert e.value.what == what


def test_k1_picks_the_d38_instance_only_for_wide_programs():
    """A program holding a D38 opcode runs the five-limb instance; a
    two-limb or narrow program keeps its own (they pay nothing)."""
    port_page = to_port(wide_page(9, 64))
    c = port_compile.ExprCompiler.for_page(port_page)
    for spec, limbs in ((F("add", "decimal(36,4)", LG, LG), 2),
                        (F("gt", "boolean", B, L(3, "bigint")), 1),
                        (F("gt", "boolean", WN, L(3, "bigint")), 5)):
        assert c.lower(build(spec, port_ir, port_type, COLUMNS))[0].limbs == limbs


# -- K2 / K3 / K6 -----------------------------------------------------------------

AGGS = [("sum", "wn"), ("avg", "wn"), ("min", "wn"), ("max", "wn"), ("count", "wn"),
        ("sum", "wq"), ("avg", "wp"), ("min", "wq"), ("max", "wp")]


def _aggs(ir, parse_type, agg_module, names=AGGS):
    out = []
    for fn, col in names:
        idx = [c for c, _ in COLUMNS].index(col)
        arg = ir.ColumnRef(type=parse_type(COLUMNS[idx][1]), index=idx)
        out.append(ir.AggCall(fn=fn, arg=arg, type=agg_module.output_type(
            ir.AggCall(fn=fn, arg=arg, type=None))))
    return out


def _live_rows_equal(got, ref) -> None:
    """The port's page and the reference's hold the same live rows."""
    from oracle import assert_rows_match

    assert_rows_match(got.to_pylist(), ref.to_pylist(), ordered=True)


def _key(ir, parse_type, name):
    idx = [c for c, _ in COLUMNS].index(name)
    return ir.ColumnRef(type=parse_type(COLUMNS[idx][1]), index=idx)


@pytest.mark.parametrize("path", ["global", "packed", "sorted"])
@pytest.mark.parametrize("mode", ["partial", "single"])
def test_grouped_states_equal_the_reference(path, mode):
    """K2 (global and packed-direct) and K6 (sort path: the key's domain
    is left out) wide sum/avg/min/max states and finalizes."""
    ref_page = wide_page(20)
    port_page = to_port(ref_page)
    keys = [] if path == "global" else ["g"]
    doms = None if path == "global" else [(0, 5)] if path == "packed" else [None]
    ref = ref_agg.grouped_aggregate(ref_page, [_key(ref_ir, ref_type, k) for k in keys],
                                    _aggs(ref_ir, ref_type, ref_agg), 64, key_domains=doms,
                                    mode=mode)
    got = port_agg.grouped_aggregate(port_page, [_key(port_ir, port_type, k) for k in keys],
                                     _aggs(port_ir, port_type, port_agg), 64, key_domains=doms,
                                     mode=mode)
    _live_rows_equal(got, ref)


@pytest.mark.parametrize("mode", ["partial", "single"])
def test_merge_equals_the_reference(mode):
    """K6's merge of two splits' partial wide states."""
    from presto_tpu.exec.local import concat_pages_device as ref_concat
    from presto_tpu_torch.page import concat_pages_device as port_concat

    ref_parts, port_parts = [], []
    for seed in (21, 22):
        ref_page = wide_page(seed)
        ref_parts.append(ref_agg.grouped_aggregate(
            ref_page, [_key(ref_ir, ref_type, "g")], _aggs(ref_ir, ref_type, ref_agg), 64,
            key_domains=[None], mode="partial"))
        port_parts.append(port_agg.grouped_aggregate(
            to_port(ref_page), [_key(port_ir, port_type, "g")],
            _aggs(port_ir, port_type, port_agg), 64, key_domains=[None], mode="partial"))
    ref = ref_agg.merge_aggregate(ref_concat(ref_parts), 1, _aggs(ref_ir, ref_type, ref_agg),
                                  64, key_domains=[None], mode=mode)
    got = port_agg.merge_aggregate(port_concat(port_parts), 1,
                                   _aggs(port_ir, port_type, port_agg), 64, key_domains=[None],
                                   mode=mode)
    _live_rows_equal(got, ref)


def test_packed_fold_equals_the_reference():
    """K3's fold of two packed-direct wide tables: the sums equal the
    reference's combine_packed_states; the min/max (which the reference
    folds limb by limb, so its packed_fold_supported refuses them) equal
    its merge of the same partials; then the finalize."""
    from presto_tpu.exec.local import concat_pages_device as ref_concat

    sums = [("sum", "wn"), ("avg", "wq"), ("count", "wn")]
    extremes = [("min", "wn"), ("max", "wn")]
    parts = {}
    for names in (sums, extremes):
        ref_p, port_p = [], []
        for seed in (23, 24):
            ref_page = wide_page(seed)
            ref_p.append(ref_agg.grouped_aggregate(
                ref_page, [_key(ref_ir, ref_type, "g")], _aggs(ref_ir, ref_type, ref_agg, names),
                8, key_domains=[(0, 5)], mode="partial"))
            port_p.append(port_agg.grouped_aggregate(
                to_port(ref_page), [_key(port_ir, port_type, "g")],
                _aggs(port_ir, port_type, port_agg, names), 8, key_domains=[(0, 5)],
                mode="partial"))
        parts[len(names)] = (ref_p, port_p)
    ref_p, port_p = parts[len(sums)]
    pa = _aggs(port_ir, port_type, port_agg, sums)
    got = port_agg.combine_packed_states(port_p[0], port_p[1], 1, pa)
    ref = ref_agg.combine_packed_states(ref_p[0], ref_p[1], 1, _aggs(ref_ir, ref_type, ref_agg,
                                                                     sums))
    _live_rows_equal(got, ref)
    _live_rows_equal(port_agg.finalize_packed(got, 1, pa),
                     ref_agg.finalize_packed(ref, 1, _aggs(ref_ir, ref_type, ref_agg, sums)))
    ref_p, port_p = parts[len(extremes)]
    pa = _aggs(port_ir, port_type, port_agg, extremes)
    got = port_agg.combine_packed_states(port_p[0], port_p[1], 1, pa)
    ref = ref_agg.merge_aggregate(ref_concat(ref_p), 1,
                                  _aggs(ref_ir, ref_type, ref_agg, extremes), 8,
                                  key_domains=[(0, 5)], mode="partial")
    _live_rows_equal(got, ref)


def test_empty_groups_hold_the_reference_identities():
    """A group with no valid row: its wide min/max state holds the
    identity in every limb and its sum zero, as the reference's."""
    ref_page = wide_page(25, 256)
    idx = {c: i for i, (c, _) in enumerate(COLUMNS)}
    blocks = list(ref_page.blocks)
    b = blocks[idx["wn"]]
    g = np.asarray(ref_page.blocks[idx["g"]].data)
    blocks[idx["wn"]] = RefBlock(b.data, jnp.asarray(np.asarray(b.valid) & (g != 3)), b.type)
    ref_page = RefPage(tuple(blocks), ref_page.row_mask)
    names = [("sum", "wn"), ("min", "wn"), ("max", "wn")]
    ref = ref_agg.grouped_aggregate(ref_page, [_key(ref_ir, ref_type, "g")],
                                    _aggs(ref_ir, ref_type, ref_agg, names), 8,
                                    key_domains=[(0, 5)], mode="partial")
    got = port_agg.grouped_aggregate(to_port(ref_page), [_key(port_ir, port_type, "g")],
                                     _aggs(port_ir, port_type, port_agg, names), 8,
                                     key_domains=[(0, 5)], mode="partial")
    for rb, pb in zip(ref.blocks, got.blocks):
        np.testing.assert_array_equal(pb.data.numpy(), np.asarray(rb.data))


# -- K7 -----------------------------------------------------------------------------

@pytest.mark.parametrize("n", [10, 100, 300])
@pytest.mark.parametrize("asc", [True, False])
def test_topn_with_a_wide_key_equals_the_reference(n, asc):
    """K7 over a wide key (and a bigint tie-break) up to its MAX_N; past
    it the page's limb-by-limb sort (ops/sort.py)."""
    ref_page = wide_page(30 + n)
    port_page = to_port(ref_page)
    ref_keys = [_key(ref_ir, ref_type, "wn"), _key(ref_ir, ref_type, "b")]
    port_keys = [_key(port_ir, port_type, "wn"), _key(port_ir, port_type, "b")]
    ref = ref_sort.topn_page(ref_page, ref_keys, [asc, True], n)
    got = port_sort.topn_page(port_page, port_keys, [asc, True], n)
    _live_rows_equal(got, ref)
    if n <= k7.MAX_N:
        ids, count = k7.topn_plain(port_sort.topn_keys(port_page, port_keys, [asc, True]),
                                   port_page.row_mask, n)
        assert int(count[0]) == min(n, int(port_page.row_mask.sum()))
