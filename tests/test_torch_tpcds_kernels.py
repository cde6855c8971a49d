"""The sixth slice's kernel work against the reference, on the same
numpy inputs made from a seed, with NULLs and dead rows: K1's new
opcodes (coalesce, floor/ceil, round, cast_decimal, long-decimal add
and subtract, string CASE / IF / coalesce over a merged dictionary,
comparison of two string columns, a string literal) against
``ExprCompiler.compile``; the variance states, double sums, sum over a
long decimal, sum0 and a long sum collapsed to a short decimal in K2
(packed-direct and global partials, ``_partial_states``), K3 (Chan's
fold, ``combine_packed_states``; the finalizes, ``_finalize``) and K6
(sort-path partials and ``_merge_states``); and the fixed order in
which the port adds doubles.  Integers and decimals compare exactly,
doubles at the parity harness's tolerance (relative 1e-9, absolute
1e-6, ``tests/oracle.py``), or bit for bit where both sides add in one
order."""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from presto_tpu.expr import compile as ref_compile
from presto_tpu.expr import ir as ref_ir
from presto_tpu.ops import aggregate as ref_agg
from presto_tpu.page import Block as RefBlock, Dictionary as RefDictionary, Page as RefPage
from presto_tpu.types import parse_type as ref_type
from presto_tpu_torch.expr import compile as port_compile
from presto_tpu_torch.expr import ir as port_ir
from presto_tpu_torch.kernels import expr_eval as k1
from presto_tpu_torch.kernels import packed_group_agg as k2
from presto_tpu_torch.kernels import sorted_group_agg as k6
from presto_tpu_torch.ops import aggregate as port_agg
from presto_tpu_torch.types import parse_type as port_type
from torch_parity import to_port, with_nulls_and_dead_rows

COLUMNS = [("x", "double"), ("y", "double"), ("q", "decimal(12,2)"), ("p", "decimal(18,2)"),
           ("l", "decimal(36,4)"), ("m", "decimal(36,4)"), ("i", "integer"), ("b", "bigint"),
           ("s1", "varchar"), ("s2", "varchar"), ("g", "bigint"), ("id", "bigint")]
WORDS_A = ["red", "green", "blue", "grey", "red", "cyan"]  # "red" under two codes
WORDS_B = ["blue", "pink", "red", "white", "black"]


def _page(seed: int, n: int = 3000) -> RefPage:
    rng = np.random.default_rng(seed)
    # multiples of 1/8: x * 10^2 and x * 10^1 land on exact halves
    x = rng.integers(-4000, 4000, n) / 8.0
    y = rng.normal(0.0, 50.0, n)
    y[rng.random(n) < 0.1] = 0.0
    # decimals with ties for round: ...50 at scale 2, either sign
    q = rng.integers(-10 ** 6, 10 ** 6, n)
    tie = rng.random(n) < 0.3
    q[tie] = rng.integers(-1000, 1000, tie.sum()) * 100 + 50
    p = rng.integers(-10 ** 15, 10 ** 15, n)
    g = rng.integers(0, 28, n)
    g[:3] = 29  # group 29: three rows, one of them kept live and non-null below
    cols = [x, y, q, p,
            np.stack([rng.integers(-3, 3, n), rng.integers(0, 10 ** 18, n)], 1),
            np.stack([rng.integers(-3, 3, n), rng.integers(0, 10 ** 18, n)], 1),
            rng.integers(-1000, 1000, n).astype(np.int32), rng.integers(-10 ** 12, 10 ** 12, n),
            rng.integers(0, len(WORDS_A), n).astype(np.int32),
            rng.integers(0, len(WORDS_B), n).astype(np.int32), g, np.arange(n)]
    dicts = {"s1": RefDictionary(WORDS_A), "s2": RefDictionary(WORDS_B)}
    blocks = [RefBlock(jnp.asarray(c), jnp.ones(n, jnp.bool_), ref_type(t), dicts.get(name))
              for c, (name, t) in zip(cols, COLUMNS)]
    page = with_nulls_and_dead_rows(RefPage(tuple(blocks), jnp.ones(n, jnp.bool_)), rng,
                                    null_rate=0.1, dead_rate=0.1)
    keep = []
    for b, (name, _) in zip(page.blocks, COLUMNS):
        v = np.asarray(b.valid).copy()
        if name in ("id", "g"):
            v[:] = True
        v[:3] = [True, False, False]  # group 29: one non-null argument
        if name == "g":  # group 28: every argument NULL (rows 3..5)
            data = np.asarray(b.data).copy()
            data[3:6] = 28
            keep.append(RefBlock(jnp.asarray(data), jnp.asarray(v), b.type, b.dictionary))
            continue
        if name not in ("id", "g"):
            v[3:6] = False
        keep.append(RefBlock(b.data, jnp.asarray(v), b.type, b.dictionary))
    mask = np.asarray(page.row_mask).copy()
    mask[:6] = True
    return RefPage(tuple(keep), jnp.asarray(mask))


def _col(ir, parse_type, name):
    i = [c for c, _ in COLUMNS].index(name)
    return ir.ColumnRef(type=parse_type(COLUMNS[i][1]), index=i)


def _expr(spec, ir, parse_type):
    if isinstance(spec, str):
        return _col(ir, parse_type, spec)
    if spec[0] == "lit":
        return ir.Literal(type=parse_type(spec[2]), value=spec[1])
    fn, t, *args = spec
    return ir.Call(type=parse_type(t), fn=fn, args=tuple(_expr(a, ir, parse_type) for a in args))


POS_I = ("gt", "boolean", "i", ("lit", 0, "integer"))
EXPRS = {
    "coalesce_int_bigint": ("coalesce", "bigint", "i", "b"),
    "coalesce_decimal_literal": ("coalesce", "decimal(12,2)", "q", ("lit", 0, "decimal(12,2)")),
    "coalesce_three_doubles": ("coalesce", "double", "x", "y", ("lit", 1.5, "double")),
    "coalesce_decimal_to_double": ("coalesce", "double", "q", "x"),
    "coalesce_long": ("coalesce", "decimal(36,4)", "l", "m"),
    "coalesce_short_to_long": ("coalesce", "decimal(36,4)", "l", "q"),
    "floor_decimal": ("floor", "decimal(12,0)", "q"),
    "ceil_decimal": ("ceil", "decimal(12,0)", "q"),
    "floor_double": ("floor", "double", "y"),
    "ceil_double": ("ceil", "double", "y"),
    "floor_integer": ("floor", "integer", "i"),
    "round_decimal_ties": ("round", "decimal(12,0)", "q"),
    "round_decimal_digits": ("round", "decimal(12,2)", "q", ("lit", 1, "integer")),
    "round_decimal_keeps": ("round", "decimal(12,2)", "q", ("lit", 3, "integer")),
    "round_double_ties": ("round", "double", "x"),
    "round_double_digits": ("round", "double", "y", ("lit", 2, "integer")),
    "cast_decimal_double_half_even": ("cast_decimal", "decimal(12,2)",
                                      ("div", "double", "x", ("lit", 8.0, "double"))),
    "cast_decimal_double_scale1": ("cast_decimal", "decimal(12,1)", "x"),
    "cast_decimal_double_long": ("cast_decimal", "decimal(36,4)",
                                 ("mul", "double", "y", ("lit", 1e6, "double"))),
    "cast_decimal_downscale": ("cast_decimal", "decimal(12,1)", "q"),
    "cast_decimal_upscale": ("cast_decimal", "decimal(18,4)", "q"),
    "cast_decimal_integer": ("cast_decimal", "decimal(18,2)", "b"),
    "long_add": ("add", "decimal(36,4)", "l", "m"),
    "long_sub_short": ("sub", "decimal(36,4)", "l", "q"),
    "string_case": ("case", "varchar", POS_I, "s1", "s2"),
    "string_case_literals": ("case", "varchar", POS_I, ("lit", "hot", "varchar"),
                             ("gt", "boolean", "b", ("lit", 0, "bigint")),
                             ("lit", "warm", "varchar"), ("lit", None, "varchar")),
    "string_if_literal": ("if", "varchar", POS_I, "s1", ("lit", "none", "varchar")),
    "string_coalesce": ("coalesce", "varchar", "s1", "s2", ("lit", "?", "varchar")),
    "string_eq": ("eq", "boolean", "s1", "s2"),
    "string_ne": ("ne", "boolean", "s2", "s1"),
    "string_eq_same_column": ("eq", "boolean", "s1", "s1"),
    "string_literal": ("lit", "channel", "varchar"),
}
OPCODE = {"coalesce_int_bigint": k1.COAL, "floor_decimal": k1.SFLOOR, "ceil_decimal": k1.SFLOOR,
          "floor_double": k1.DFLOOR, "round_decimal_ties": k1.SROUND,
          "round_double_ties": k1.DROUND, "cast_decimal_double_half_even": k1.D2S,
          "cast_decimal_double_long": k1.D2L, "cast_decimal_downscale": k1.SFLOOR,
          "long_add": k1.LADD, "string_case": k1.CANON, "string_coalesce": k1.COAL,
          "string_eq": k1.CANON}
STRINGS = {"string_case", "string_case_literals", "string_if_literal", "string_coalesce",
           "string_literal"}


def _same(ref, got, what):
    """Equal validity; equal data where valid (doubles bit for bit)."""
    rd, rv = np.asarray(ref[0]), np.asarray(ref[1])
    gd, gv = got[0].numpy(), got[1].numpy()
    np.testing.assert_array_equal(gv, rv, err_msg=f"{what} valid")
    if rd.dtype == np.float64:
        rd, gd = rd.view(np.int64), gd.view(np.int64)
    np.testing.assert_array_equal(gd[rv], rd[rv].astype(gd.dtype), err_msg=f"{what} data")


@pytest.mark.parametrize("name", sorted(EXPRS))
@pytest.mark.parametrize("seed", [0, 1])
def test_new_opcodes_equal_reference(name, seed):
    ref_page = _page(seed)
    port_page = to_port(ref_page)
    ref_e, port_e = _expr(EXPRS[name], ref_ir, ref_type), _expr(EXPRS[name], port_ir, port_type)
    ref = ref_compile.ExprCompiler.for_page(ref_page).compile(ref_e)(ref_page)
    got = port_compile.ExprCompiler.for_page(port_page).compile(port_e)(port_page)
    if name in STRINGS:  # codes into the same merged dictionary
        ref_d = ref_compile.expr_dictionary(ref_e, [b.dictionary for b in ref_page.blocks])
        port_d = port_compile.expr_dictionary(port_e, [b.dictionary for b in port_page.blocks])
        assert list(port_d.values) == list(ref_d.values)
    _same(ref, got, name)
    if ref_e.type.name == "boolean":
        want = ref_compile.compile_filter(ref_e, ref_page)(ref_page)
        mask = port_compile.compile_filter(port_e, port_page)(port_page)
        np.testing.assert_array_equal(mask.numpy(), np.asarray(want))


@pytest.mark.parametrize("name", sorted(OPCODE))
def test_new_opcodes_lower_as_expected(name):
    c = port_compile.ExprCompiler.for_page(to_port(_page(2, 16)))
    prog, _ = c.lower(_expr(EXPRS[name], port_ir, port_type))
    assert OPCODE[name] in prog.ops
    if name.startswith("string"):
        assert any(t.kind in k1.COUNTED_TABLES for t in prog.luts)


def test_rounding_ties_by_hand():
    """round() of a decimal and of a double goes half away from zero;
    cast_decimal of a double half to even (jnp.round's rule)."""
    n = 6
    q = np.array([250, -250, 150, -150, 249, -251])  # 2.50 -2.50 1.50 -1.50 2.49 -2.51
    x = np.array([0.125, -0.125, 0.375, 2.5, -2.5, 0.0625])
    blocks = [RefBlock(jnp.asarray(x), jnp.ones(n, jnp.bool_), ref_type("double")),
              RefBlock(jnp.asarray(q), jnp.ones(n, jnp.bool_), ref_type("decimal(12,2)"))]
    page = to_port(RefPage(tuple(blocks), jnp.ones(n, jnp.bool_)))
    c = port_compile.ExprCompiler.for_page(page)
    xc = port_ir.ColumnRef(type=port_type("double"), index=0)
    qc = port_ir.ColumnRef(type=port_type("decimal(12,2)"), index=1)

    def run(fn, t, *args):
        return c.compile(port_ir.Call(type=port_type(t), fn=fn, args=args))(page)[0].tolist()

    assert run("round", "decimal(12,0)", qc) == [3, -3, 2, -2, 2, -3]
    assert run("round", "double", xc) == [0.0, -0.0, 0.0, 3.0, -3.0, 0.0]
    assert run("cast_decimal", "decimal(12,2)", xc) == [12, -12, 38, 250, -250, 6]
    assert run("floor", "decimal(12,0)", qc) == [2, -3, 1, -2, 2, -3]
    assert run("ceil", "decimal(12,0)", qc) == [3, -2, 2, -1, 3, -2]


def test_ordered_string_column_comparison_raises():
    from presto_tpu_torch import NotPorted

    c = port_compile.ExprCompiler.for_page(to_port(_page(2, 16)))
    with pytest.raises(NotPorted) as e:
        c.lower(_expr(("lt", "boolean", "s1", "s2"), port_ir, port_type))
    assert e.value.what == "ordered comparison (lt) of two string columns"


# -- aggregation states ---------------------------------------------------------

VAR_ARGS = ("i", "q", "y", "l")
VAR_FNS = ("stddev", "stddev_samp", "stddev_pop", "variance", "var_samp", "var_pop")


def _aggs(ir, parse_type, mod, which):
    specs = {
        "variance": [(fn, a) for fn in VAR_FNS for a in VAR_ARGS[:2]]
        + [("stddev_samp", a) for a in VAR_ARGS[2:]] + [("count", "i")],
        "double_sum": [("sum", "y"), ("avg", "y"), ("sum", "x"), ("count", "y")],
        "sums": [("sum", "l"), ("avg", "l"), ("sum0", "b"), ("sum0", "q"), ("sum0", "l"),
                 ("sum", "b")],
    }[which]
    out = []
    for fn, col in specs:
        arg = _col(ir, parse_type, col)
        out.append(ir.AggCall(fn=fn, arg=arg, type=mod.output_type(
            ir.AggCall(fn=fn, arg=arg, type=parse_type("bigint")))))
    if which == "sums":  # the mixed-DISTINCT rewrite's outer sums: limbs back to short
        for fn in ("sum", "sum0"):
            out.append(ir.AggCall(fn=fn, arg=_col(ir, parse_type, "p"),
                                  type=parse_type("decimal(18,2)")))
    return out


def _close(a, b) -> bool:
    if a is None or b is None:
        return a is None and b is None
    if isinstance(a, float) or isinstance(b, float):
        return math.isclose(float(a), float(b), rel_tol=1e-9, abs_tol=1e-6) or (
            math.isnan(float(a)) and math.isnan(float(b)))
    return a == b


def _rows_close(got, want):
    assert len(got) == len(want)
    for rg, rw in zip(got, want):
        assert len(rg) == len(rw)
        assert all(_close(a, b) for a, b in zip(rg, rw)), (rg, rw)


def _pages_close(got, want):
    assert [str(b.type) for b in got.blocks] == [str(b.type) for b in want.blocks]
    np.testing.assert_array_equal(got.row_mask.numpy(), np.asarray(want.row_mask))
    _rows_close(got.to_pylist(), want.to_pylist())


BRANCHES = {"global": ([], 1, None), "packed": (["g"], 32, [(0, 29)]),
            "sort_path": (["g"], 32, None)}


@pytest.mark.parametrize("which", ["variance", "double_sum", "sums"])
@pytest.mark.parametrize("branch", sorted(BRANCHES))
def test_partial_and_finalize_equal_reference(which, branch):
    ref_page = _page(4)
    keys, mg, kd = BRANCHES[branch]
    ra, pa = _aggs(ref_ir, ref_type, ref_agg, which), _aggs(port_ir, port_type, port_agg, which)
    for mode in ("partial", "single"):
        want = ref_agg.grouped_aggregate(ref_page, [_col(ref_ir, ref_type, k) for k in keys],
                                         ra, mg, key_domains=kd, mode=mode)
        got = port_agg.grouped_aggregate(to_port(ref_page),
                                         [_col(port_ir, port_type, k) for k in keys],
                                         pa, mg, key_domains=kd, mode=mode)
        if branch == "sort_path" or (branch == "packed" and which != "sums"):
            # the port emits the groups it finds, in key order (a keyed
            # double state takes the sort path: takes_sort_path)
            _rows_close(got.to_pylist(), want.to_pylist())
            continue
        _pages_close(got, want)
    if which == "variance" and branch != "global":
        rows = {r[0]: r for r in got.to_pylist()}
        # one value: every sample form NULL, stddev_pop(i) and var_pop(i) 0
        assert rows[29][3] is None and rows[29][5] == 0.0 and rows[29][11] == 0.0
        assert rows[28][1] is None and rows[28][-1] == 0  # all NULL: NULL, count 0
    if which == "sums" and branch != "global":
        rows = {r[0]: r for r in got.to_pylist()}
        assert rows[28][3:6] == (0, 0, 0)  # sum0 over no value is 0, not NULL


def test_sum0_of_an_empty_input_is_zero():
    ref_page = _page(5, 16)
    empty = RefPage(ref_page.blocks, jnp.zeros(16, jnp.bool_))
    ra, pa = _aggs(ref_ir, ref_type, ref_agg, "sums"), _aggs(port_ir, port_type, port_agg, "sums")
    want = ref_agg.grouped_aggregate(empty, [], ra, 1, mode="single")
    got = port_agg.grouped_aggregate(to_port(empty), [], pa, 1, mode="single")
    _pages_close(got, want)
    assert got.to_pylist()[0][2] == 0


@pytest.mark.parametrize("which", ["variance", "double_sum", "sums"])
def test_fold_and_merge_equal_reference(which):
    """Two splits' partial states folded slot by slot (K3, Chan's update
    for variance) and merged on the sort path (K6), then finalized.  The
    fold runs over packed-direct tables grouped by g, or for a double
    state (which K2 adds only for the global aggregate) over the two
    splits' global tables."""
    from presto_tpu.exec.local import concat_pages_device as ref_concat
    from presto_tpu_torch.page import concat_pages_device as port_concat

    pages = [_page(s) for s in (6, 7)]
    keyed = which == "sums"
    kd, mg, nk = ([(0, 29)], 32, 1) if keyed else (None, 1, 0)
    ref_k = [_col(ref_ir, ref_type, "g")] if keyed else []
    port_k = [_col(port_ir, port_type, "g")] if keyed else []
    ra, pa = _aggs(ref_ir, ref_type, ref_agg, which), _aggs(port_ir, port_type, port_agg, which)
    rp = [ref_agg.grouped_aggregate(p, ref_k, ra, mg, key_domains=kd, mode="partial")
          for p in pages]
    pp = [port_agg.grouped_aggregate(to_port(p), port_k, pa, mg, key_domains=kd,
                                     mode="partial") for p in pages]
    folded_ref = ref_agg.combine_packed_states(rp[0], rp[1], nk, ra)
    folded = port_agg.combine_packed_states(pp[0], pp[1], nk, pa)
    _pages_close(folded, folded_ref)
    _pages_close(port_agg.finalize_packed(folded, nk, pa),
                 ref_agg.finalize_packed(folded_ref, nk, ra))
    ref_k, port_k = [_col(ref_ir, ref_type, "g")], [_col(port_ir, port_type, "g")]
    sp = [port_agg.grouped_aggregate(to_port(p), port_k, pa, 32, mode="partial") for p in pages]
    rs = [ref_agg.grouped_aggregate(p, ref_k, ra, 32, mode="partial") for p in pages]
    for mode in ("partial", "single"):
        got = port_agg.merge_aggregate(port_concat(sp), 1, pa, 32, mode=mode)
        want = ref_agg.merge_aggregate(ref_concat(rs), 1, ra, 32, mode=mode)
        _rows_close(got.to_pylist(), want.to_pylist())


def test_double_states_past_the_slot_limit_take_the_sort_path():
    """K2 adds double states for the global aggregate only: a keyed
    grouping with one takes the sort path, whatever its key domain,
    where the same keys without one stay packed-direct."""
    keys = [_col(port_ir, port_type, "g")]
    for which in ("variance", "double_sum"):
        aggs = _aggs(port_ir, port_type, port_agg, which)
        assert port_agg.takes_sort_path(keys, [(0, 29)], 32, aggs)
        assert port_agg.takes_sort_path(keys, [(0, 200)], 1024, aggs)
        assert not port_agg.takes_sort_path([], None, 1, aggs)
    sums = _aggs(port_ir, port_type, port_agg, "sums")
    assert not port_agg.takes_sort_path(keys, [(0, 200)], 1024, sums)
    assert port_agg.takes_sort_path(keys, [(0, 200)], 1024, sums, presorted=True)
    assert port_agg.takes_sort_path(keys, [None], 1024, sums)
    # K2 itself refuses a double state over more than the global slot
    n = 8
    x = torch.ones(n, dtype=torch.float64)
    ok = torch.ones(n, dtype=torch.bool)
    key = [(torch.zeros(n, dtype=torch.int64), ok, 0, 2)]
    with pytest.raises(ValueError):
        k2.packed_group_agg(n, ok, key, [(k2.VARIANCE, x, ok)], 2)


# -- the fixed order of double sums -------------------------------------------

def _chunked_by_hand(vals, slots, n_slots, chunk):
    """Sequential within each chunk of rows, pairwise across chunks."""
    parts = []
    for c0 in range(0, max(len(vals), 1), chunk):
        acc = [0.0] * n_slots
        for v, s in zip(vals[c0:c0 + chunk], slots[c0:c0 + chunk]):
            if s < n_slots:
                acc[s] = acc[s] + v
        parts.append(acc)
    while len(parts) > 1:
        parts = [[a + b for a, b in zip(parts[i], parts[i + 1])] if i + 1 < len(parts)
                 else parts[i] for i in range(0, len(parts), 2)]
    return parts[0]


@pytest.mark.parametrize("n", [0, 1, 255, 256, 257, 3000])
def test_chunk_sums_follow_the_stated_order(n):
    rng = np.random.default_rng(n)
    vals = rng.normal(0.0, 1e6, n) * 10.0 ** rng.integers(-8, 8, n)
    slots = rng.integers(0, 9, n)  # 8 = dropped
    got = k2.chunk_sums_plain(torch.from_numpy(vals), torch.from_numpy(slots), 8)
    want = _chunked_by_hand(vals.tolist(), slots.tolist(), 8, k2.DSUM_CHUNK)
    assert got.numpy().view(np.int64).tolist() == np.array(want).view(np.int64).tolist()


def test_run_sums_follow_the_stated_order():
    rng = np.random.default_rng(3)
    lengths = [1, 255, 256, 257, 1100, 3, 513]
    gid = np.repeat(np.arange(len(lengths)), lengths)
    vals = rng.normal(0.0, 1e6, gid.shape[0]) * 10.0 ** rng.integers(-8, 8, gid.shape[0])
    got = k6.run_sums_plain(torch.from_numpy(vals), torch.from_numpy(gid), len(lengths))
    want = []
    pos = 0
    for ln in lengths:
        want.append(_chunked_by_hand(vals[pos:pos + ln].tolist(), [0] * ln, 1,
                                     k6.DSUM_CHUNK)[0])
        pos += ln
    assert got.numpy().view(np.int64).tolist() == np.array(want).view(np.int64).tolist()


def test_stddev_finalize_rounds_its_square_root():
    """K3's twin takes a correctly rounded square root, as the kernel's
    __dsqrt_rn does (PyTorch's CPU sqrt over a large double tensor may
    differ in the last bit)."""
    from presto_tpu_torch.kernels import packed_fold_finalize as k3

    rng = np.random.default_rng(5)
    m2 = torch.from_numpy(rng.random(1 << 16) * 10.0 ** rng.integers(-3, 9, 1 << 16))
    cnt = torch.from_numpy(rng.integers(1, 1000, 1 << 16))
    mask = torch.ones(1 << 16, dtype=torch.bool)
    (got, valid), = k3.packed_finalize_plain([(k3.FIN_STDDEV_POP, m2, cnt)], mask)
    want = [math.sqrt(a / b) for a, b in zip(m2.tolist(), cnt.tolist())]
    assert got.tolist() == want and bool(valid.all())
