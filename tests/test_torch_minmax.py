"""The fourth slice's kernels at the kernel level, against the reference
on the same numpy inputs made from a seed: K1's date parts, short
decimal to double, long-decimal comparisons and null tests
(ExprCompiler.compile); the min/max states of K2, K3 and K6 on the
global, packed-direct, sort-path and merge branches (grouped_aggregate,
combine_packed_states, finalize_packed, merge_aggregate); K6's
presorted mode (grouped_aggregate's streaming branch); K7 at n = 33 and
n = 100 (topn_page).  Integer and decimal results are exact, doubles
bit for bit."""

import numpy as np
import pytest
import jax.numpy as jnp

from presto_tpu.exec.local import concat_pages_device as ref_concat
from presto_tpu.expr import compile as ref_compile
from presto_tpu.expr import ir as ref_ir
from presto_tpu.ops import aggregate as ref_agg
from presto_tpu.ops import sort as ref_sort
from presto_tpu.page import Block as RefBlock, Page as RefPage
from presto_tpu.types import parse_type as ref_type
from presto_tpu_torch.expr import compile as port_compile
from presto_tpu_torch.expr import ir as port_ir
from presto_tpu_torch.kernels import expr_eval as k1
from presto_tpu_torch.ops import aggregate as port_agg
from presto_tpu_torch.ops import sort as port_sort
from presto_tpu_torch.page import concat_pages_device as port_concat
from presto_tpu_torch.types import parse_type as port_type
from torch_parity import assert_same_lanes, to_port, with_nulls_and_dead_rows

# name, type of each column of the synthetic page
COLUMNS = [("dt", "date"), ("q", "decimal(12,2)"), ("n", "bigint"),
           ("l4", "decimal(36,4)"), ("l2", "decimal(36,2)"), ("l6", "decimal(36,6)"),
           ("g", "bigint"), ("s", "bigint")]
LEAP_DAYS = [-672, 789, 11016, 12477, 19417]  # 1968-02-29 ... 2023-02-28 (not leap)


def _limbs(rng, n, hi_lo, hi_hi, huge=False):
    """Canonical two-limb values; few distinct high limbs, so rows tie
    on the high limb often; ``huge`` puts some high limbs near the
    36-digit limit, where an up-scale wraps."""
    hi = rng.integers(hi_lo, hi_hi, n)
    if huge:
        pick = rng.random(n) < 0.1
        hi[pick] = rng.choice([10 ** 17, -(10 ** 17), 9 * 10 ** 17, (1 << 62) // 10 ** 3], pick.sum())
    lo = rng.choice([0, 1, 5 * 10 ** 17, 10 ** 18 - 1], n)
    lo = np.where(rng.random(n) < 0.5, lo, rng.integers(0, 10 ** 18, n))
    return np.stack([hi, lo], 1)


def _page(seed: int, n: int = 4000) -> RefPage:
    rng = np.random.default_rng(seed)
    days = rng.integers(-1500, 25000, n)
    leap = rng.random(n) < 0.1
    days[leap] = rng.choice(LEAP_DAYS, leap.sum())
    cols = [days.astype(np.int32), rng.integers(-10 ** 9, 10 ** 9, n),
            rng.integers(-50, 50, n), _limbs(rng, n, -3, 3), _limbs(rng, n, -3, 3, huge=True),
            _limbs(rng, n, -3, 3),
            rng.integers(0, 40, n),  # a group key; some groups see only NULLs below
            np.sort(rng.integers(0, n // 6, n))]  # a presorted key, runs of ~6 rows
    blocks = [RefBlock(jnp.asarray(c), jnp.ones(n, jnp.bool_), ref_type(t))
              for c, (_, t) in zip(cols, COLUMNS)]
    page = with_nulls_and_dead_rows(RefPage(tuple(blocks), jnp.ones(n, jnp.bool_)), rng,
                                    null_rate=0.1, dead_rate=0.2)
    # groups 0-2 of "g" only ever see NULL values of every argument
    g = np.asarray(page.blocks[6].data)
    blocks = [RefBlock(b.data, jnp.asarray(np.asarray(b.valid) & (g >= 3)), b.type)
              if i not in (6, 7) else b for i, b in enumerate(page.blocks)]
    return RefPage(tuple(blocks), page.row_mask)


def _col(ir, parse_type, name):
    i = [c for c, _ in COLUMNS].index(name)
    return ir.ColumnRef(type=parse_type(COLUMNS[i][1]), index=i)


def _expr(spec, ir, parse_type):
    if isinstance(spec, str):
        return _col(ir, parse_type, spec)
    if spec[0] == "lit":
        return ir.Literal(type=parse_type(spec[2]), value=spec[1])
    fn, t, *args = spec
    return ir.Call(type=parse_type(t), fn=fn,
                   args=tuple(_expr(a, ir, parse_type) for a in args))


EXPRS = {
    "year": ("year", "bigint", "dt"),
    "month": ("month", "bigint", "dt"),
    "day": ("day", "bigint", "dt"),
    "quarter": ("quarter", "bigint", "dt"),
    "s2d_div": ("div", "double", "q", "n"),
    "s2d_literal": ("div", "double", "q", ("lit", 70, "decimal(2,1)")),
    "lcmp_gt_scales": ("gt", "boolean", "l2", "l6"),
    "lcmp_ge_same_scale": ("ge", "boolean", "l4", "l4"),
    "lcmp_lt_short": ("lt", "boolean", "q", "l4"),
    "lcmp_eq_long_short": ("eq", "boolean", "l6", "n"),
    "lcmp_ne_wraps": ("ne", "boolean", "l2", "l6"),
    "lcmp_le": ("le", "boolean", "l6", "l4"),
    "not_null": ("not_null", "boolean", "l4"),
    "is_null": ("is_null", "boolean", "dt"),
    "long_product": ("mul", "decimal(36,6)", "l2", ("lit", 25, "decimal(4,4)")),
}


@pytest.mark.parametrize("name", sorted(EXPRS))
@pytest.mark.parametrize("seed", [0, 1])
def test_new_opcodes_equal_reference(name, seed):
    ref_page = _page(seed)
    port_page = to_port(ref_page)
    ref_e, port_e = _expr(EXPRS[name], ref_ir, ref_type), _expr(EXPRS[name], port_ir, port_type)
    ref = ref_compile.ExprCompiler.for_page(ref_page).compile(ref_e)(ref_page)
    got = port_compile.ExprCompiler.for_page(port_page).compile(port_e)(port_page)
    assert_same_lanes(ref, got, name)  # doubles bit for bit: no tolerance
    if ref_e.type.name == "boolean":
        want = ref_compile.compile_filter(ref_e, ref_page)(ref_page)
        mask = port_compile.compile_filter(port_e, port_page)(port_page)
        np.testing.assert_array_equal(mask.numpy(), np.asarray(want))


def test_new_opcodes_lower_as_expected():
    """Each expression takes the opcode it is here for; a long
    comparison and a double conversion run on the wide interpreter."""
    page = to_port(_page(2))
    c = port_compile.ExprCompiler.for_page(page)
    want = {"year": (k1.DATEPART, False), "s2d_div": (k1.S2D, True),
            "lcmp_gt_scales": (k1.LSCALE, True), "lcmp_lt_short": (k1.S2L, True),
            "is_null": (k1.NOTNULL, False)}
    for name, (op, wide) in want.items():
        prog, _ = c.lower(_expr(EXPRS[name], port_ir, port_type))
        assert op in prog.ops and prog.wide == wide, name


def test_date_parts_before_1970_and_on_29_february():
    """The floor divisions of the civil-calendar walk, straight from
    days: 1968-02-29, 1969-12-31, 1970-01-01, 2000-02-29, and the
    proleptic 0000-03-01 and 0000-02-29 (an era boundary)."""
    import torch

    days = torch.tensor([-672, -1, 0, 11016, -719468, -719469], dtype=torch.int64)
    got = [k1.date_part(days, p).tolist() for p in range(4)]
    assert got == [[1968, 1969, 1970, 2000, 0, 0], [2, 12, 1, 2, 3, 2], [29, 31, 1, 29, 1, 29],
                   [1, 4, 1, 1, 1, 1]]


# -- min/max states ----------------------------------------------------------

AGGS = [("min", "q"), ("max", "q"), ("min", "n"), ("max", "dt"), ("min", "dt"),
        ("min", "l4"), ("max", "l4"), ("count", "l4"), ("count_star", None)]


def _aggs(ir, parse_type, mod):
    out = []
    for fn, col in AGGS:
        arg = None if col is None else _col(ir, parse_type, col)
        call = ir.AggCall(fn=fn, arg=arg, type=parse_type("bigint"))
        out.append(ir.AggCall(fn=fn, arg=arg, type=mod.output_type(call)))
    return out


def _same_page(port, ref):
    """Every slot of the reference's packed layout, state data too (an
    empty min/max holds its storage's identity in both)."""
    assert [str(b.type) for b in port.blocks] == [str(b.type) for b in ref.blocks]
    np.testing.assert_array_equal(port.row_mask.numpy(), np.asarray(ref.row_mask))
    for pb, rb in zip(port.blocks, ref.blocks):
        np.testing.assert_array_equal(pb.valid.numpy(), np.asarray(rb.valid))
        np.testing.assert_array_equal(pb.data.numpy(), np.asarray(rb.data))
    assert port.to_pylist() == ref.to_pylist()


def _live_rows_equal(port, ref):
    assert [str(b.type) for b in port.blocks] == [str(b.type) for b in ref.blocks]
    assert port.to_pylist() == ref.to_pylist()
    assert len(port.to_pylist()) >= 30


def _grouped(seed, keys, mg, kd, mode, presorted=False):
    ref_page = _page(seed)
    ref = ref_agg.grouped_aggregate(ref_page, [_col(ref_ir, ref_type, k) for k in keys],
                                    _aggs(ref_ir, ref_type, ref_agg), mg, key_domains=kd,
                                    mode=mode, presorted=presorted)
    got = port_agg.grouped_aggregate(to_port(ref_page),
                                     [_col(port_ir, port_type, k) for k in keys],
                                     _aggs(port_ir, port_type, port_agg), mg, key_domains=kd,
                                     mode=mode, presorted=presorted)
    return got, ref


@pytest.mark.parametrize("mode", ["partial", "single"])
def test_global_minmax(mode):
    got, ref = _grouped(3, [], 1, None, mode)
    _same_page(got, ref)


@pytest.mark.parametrize("mode", ["partial", "single"])
def test_packed_direct_minmax(mode):
    """40 groups in a 64-slot table; groups 0-2 have only NULL values
    (count 0, NULL out, the identity in the state)."""
    got, ref = _grouped(4, ["g"], 64, [(0, 39)], mode)
    _same_page(got, ref)
    if mode == "single":
        assert got.to_pylist()[1][1] is None


@pytest.mark.parametrize("num_keys", [0, 1])
def test_minmax_fold_and_finalize(num_keys):
    keys = ["g"] if num_keys else []
    mg, kd = (64, [(0, 39)]) if num_keys else (1, None)
    parts = [_grouped(seed, keys, mg, kd, "partial") for seed in (5, 6)]
    ref_aggs, port_aggs = _aggs(ref_ir, ref_type, ref_agg), _aggs(port_ir, port_type, port_agg)
    ref_fold = ref_agg.combine_packed_states(parts[0][1], parts[1][1], num_keys, ref_aggs)
    port_fold = port_agg.combine_packed_states(parts[0][0], parts[1][0], num_keys, port_aggs)
    _same_page(port_fold, ref_fold)
    _same_page(port_agg.finalize_packed(port_fold, num_keys, port_aggs),
               ref_agg.finalize_packed(ref_fold, num_keys, ref_aggs))


@pytest.mark.parametrize("mode", ["partial", "single"])
@pytest.mark.parametrize("hashed", [False, True])
def test_sort_path_minmax(mode, hashed):
    """Groups past the direct table (exact packed key, or hashed)."""
    kd = [None, None] if hashed else [(0, 39), (0, 700)]
    got, ref = _grouped(7, ["g", "s"], 1 << 15, kd, mode)
    _live_rows_equal(got, ref)


@pytest.mark.parametrize("mode", ["partial", "single"])
def test_merge_minmax(mode):
    """Two splits' sort-path partials merged (K6's merge branch); every
    state kind's empty groups take part."""
    kd = [(0, 39), (0, 700)]
    parts = [_grouped(seed, ["g", "s"], 1 << 15, kd, "partial") for seed in (8, 9)]
    ref_aggs, port_aggs = _aggs(ref_ir, ref_type, ref_agg), _aggs(port_ir, port_type, port_agg)
    ref = ref_agg.merge_aggregate(ref_concat([r for _, r in parts]), 2, ref_aggs, 1 << 16,
                                  key_domains=kd, mode=mode)
    got = port_agg.merge_aggregate(port_concat([g for g, _ in parts]), 2, port_aggs, 1 << 16,
                                   key_domains=kd, mode=mode)
    _live_rows_equal(got, ref)


# -- presorted (streaming) grouping ------------------------------------------

@pytest.mark.parametrize("mode", ["partial", "single"])
def test_presorted_grouping(mode):
    """Runs of equal keys in page order, with dead rows (20%) between
    equal keys; groups in first-appearance order."""
    got, ref = _grouped(10, ["s"], 1 << 12, [(0, 700)], mode, presorted=True)
    _live_rows_equal(got, ref)


def test_presorted_group_straddling_two_splits():
    """A run of equal keys cut by a split boundary comes out of both
    splits' partials and once from the merge, as the whole page grouped
    at once gives it."""
    whole = _page(11)
    n = whole.capacity
    key, live = np.asarray(whole.blocks[7].data), np.asarray(whole.row_mask)
    # the first cut past the middle between two live rows of one run
    cut = next(i for i in range(n // 2, n) if key[i - 1] == key[i] and live[i - 1] and live[i])
    halves = [RefPage(tuple(RefBlock(b.data[a:z], b.valid[a:z], b.type) for b in whole.blocks),
                      whole.row_mask[a:z]) for a, z in ((0, cut), (cut, n))]
    kd = [(0, 700)]
    ref_keys, port_keys = [_col(ref_ir, ref_type, "s")], [_col(port_ir, port_type, "s")]
    ref_aggs, port_aggs = _aggs(ref_ir, ref_type, ref_agg), _aggs(port_ir, port_type, port_agg)
    ref_parts = [ref_agg.grouped_aggregate(h, ref_keys, ref_aggs, 1 << 12, key_domains=kd,
                                           mode="partial", presorted=True) for h in halves]
    port_parts = [port_agg.grouped_aggregate(to_port(h), port_keys, port_aggs, 1 << 12,
                                             key_domains=kd, mode="partial", presorted=True)
                  for h in halves]
    boundary = int(key[cut])
    assert any(r[0] == boundary for r in port_parts[0].to_pylist())
    assert any(r[0] == boundary for r in port_parts[1].to_pylist())
    ref = ref_agg.merge_aggregate(ref_concat(ref_parts), 1, ref_aggs, 1 << 13,
                                  key_domains=kd, mode="single")
    got = port_agg.merge_aggregate(port_concat(port_parts), 1, port_aggs, 1 << 13,
                                   key_domains=kd, mode="single")
    _live_rows_equal(got, ref)
    rows = got.to_pylist()
    assert [r[0] for r in rows].count(boundary) == 1
    once = port_agg.grouped_aggregate(to_port(whole), port_keys, port_aggs, 1 << 13,
                                      key_domains=kd, mode="single")
    def by_key(r):
        return (r[0] is None, r[0] or 0)

    assert sorted(rows, key=by_key) == sorted(once.to_pylist(), key=by_key)


# -- top-N past 32 -------------------------------------------------------------

def _topn_page(seed: int, n: int = 3000) -> RefPage:
    """Few distinct values per key, so rows tie on every key often."""
    rng = np.random.default_rng(seed)
    cols = [(np.stack([rng.integers(-2, 2, n), rng.choice([0, 5, 10 ** 17], n)], 1),
             "decimal(36,4)"), (rng.integers(9000, 9004, n).astype(np.int32), "date"),
            (rng.integers(-3, 3, n), "bigint")]
    blocks = [RefBlock(jnp.asarray(c), jnp.ones(n, jnp.bool_), ref_type(t)) for c, t in cols]
    page = RefPage(tuple(blocks), jnp.ones(n, jnp.bool_))
    return with_nulls_and_dead_rows(page, rng, null_rate=0.2, dead_rate=0.2)


@pytest.mark.parametrize("n", [33, 100])
def test_topn_past_32_equals_reference(n):
    """Q18's ORDER BY (a decimal descending, a date) at LIMIT 33 and
    100, ties broken by position as the reference's stable sorts."""
    ref_page = _topn_page(n)
    types = ["decimal(36,4)", "date", "bigint"]
    ref_e = [ref_ir.ColumnRef(type=ref_type(t), index=i) for i, t in enumerate(types)]
    port_e = [port_ir.ColumnRef(type=port_type(t), index=i) for i, t in enumerate(types)]
    asc, nf = [False, True, True], [False, True, False]
    ref = ref_sort.topn_page(ref_page, ref_e, asc, n, nf)
    got = port_sort.topn_page(to_port(ref_page), port_e, asc, n, nf)
    assert got.capacity == n
    assert got.to_pylist() == ref.to_pylist()
    assert len(got.to_pylist()) == n
