"""Window functions (K10 ``window_eval`` behind ``ops/window.py``
``window_page``) against the reference's ``window_page`` on the same
seeded numpy pages, with NULLs in every column and dead rows: every
``WindowFunc`` kind; the default frame with and without ORDER BY,
``("whole",)``, and ROWS frames with bounded, unbounded and empty
ends; IGNORE NULLS; ties in the order keys (``row_number`` follows the
stable sort chain); a double order key with -0.0, 0.0 and NaN; a
long-decimal order key; exact and hashed partition keys.  Results
are exact: integers and decimals equal, doubles bit for bit."""

import numpy as np
import pytest
import jax.numpy as jnp

from presto_tpu.expr import ir as ref_ir
from presto_tpu.ops import window as ref_window
from presto_tpu.page import Block as RefBlock, Dictionary as RefDictionary, Page as RefPage
from presto_tpu.types import parse_type as ref_type
from presto_tpu_torch.expr import ir as port_ir
from presto_tpu_torch.kernels import window_eval as k10
from presto_tpu_torch.ops import window as port_window
from presto_tpu_torch.types import parse_type as port_type
from torch_parity import to_port, with_nulls_and_dead_rows

COLUMNS = [("p", "bigint"), ("s", "varchar"), ("o", "integer"), ("od", "double"),
           ("ol", "decimal(36,4)"), ("x", "decimal(12,2)"), ("xi", "integer"),
           ("xd", "double"), ("xb", "bigint"), ("xs", "varchar")]
WORDS = ["ash", "birch", "cedar", "ash", "elm", "fir", "birch", "gum"]  # repeats


def _page(seed: int, n: int = 3000) -> RefPage:
    rng = np.random.default_rng(seed)
    od = rng.integers(-20, 20, n).astype(np.float64) / 4
    odd = rng.random(n)
    od[odd < 0.05] = -0.0
    od[(odd >= 0.05) & (odd < 0.08)] = np.nan
    hi = rng.integers(-2, 2, n)
    lo = rng.choice([0, 7, 10 ** 18 - 1], n)
    cols = [rng.integers(0, 8, n), rng.integers(0, len(WORDS), n).astype(np.int32),
            rng.integers(0, 60, n).astype(np.int32), od, np.stack([hi, lo], 1),
            rng.integers(-10 ** 6, 10 ** 6, n), rng.integers(-1000, 1000, n).astype(np.int32),
            rng.normal(0.0, 1000.0, n), rng.integers(-10 ** 12, 10 ** 12, n),
            rng.integers(0, len(WORDS), n).astype(np.int32)]
    d = RefDictionary(WORDS)
    blocks = [RefBlock(jnp.asarray(c), jnp.ones(n, jnp.bool_), ref_type(t),
                       d if t == "varchar" else None) for c, (_, t) in zip(cols, COLUMNS)]
    return with_nulls_and_dead_rows(RefPage(tuple(blocks), jnp.ones(n, jnp.bool_)), rng,
                                    null_rate=0.15, dead_rate=0.15)


def _col(ir, parse_type, name):
    i = [c for c, _ in COLUMNS].index(name)
    return ir.ColumnRef(type=parse_type(COLUMNS[i][1]), index=i)


def _funcs(mod, ir, parse_type, specs):
    return [mod.WindowFunc(kind=k, arg=None if a is None else _col(ir, parse_type, a),
                           offset=off, frame=fr, ignore_nulls=ign)
            for k, a, off, fr, ign in specs]


def _spec(kind, arg=None, offset=1, frame=None, ignore_nulls=False):
    return (kind, arg, offset, frame, ignore_nulls)


RANKS = [_spec(k) for k in ("row_number", "rank", "dense_rank", "percent_rank",
                            "cume_dist")] + [_spec("ntile", offset=n) for n in (1, 3, 7)]
SHIFTS = [_spec(k, a, off, None, ign) for k in ("lead", "lag") for a in ("x", "xd", "xs")
          for off in (0, 1, 3) for ign in (False, True)]
FRAMES = [None, ("whole",), ("rows", None, 0), ("rows", -2, 1), ("rows", -3, None),
          ("rows", 1, 3), ("rows", -3, -1), ("rows", 2, 1), ("rows", None, -1)]
VALUES = [_spec(k, a, off, fr, ign) for k, off in (("first_value", 1), ("last_value", 1),
                                                  ("nth_value", 2))
          for a in ("xi", "xd") for fr in FRAMES for ign in (False, True)]
AGGS = [_spec(k, a, 1, fr) for k in ("count", "sum", "avg") for a in ("x", "xi", "xb", "xd")
        for fr in FRAMES] + [_spec("count_star", None, 1, fr) for fr in FRAMES]
# min/max over decimal, bigint and double arguments (the reference's
# int32 case: test_min_max_over_int32_skips_nulls; signed zeros: XLA
# picks either zero inside its scan, so "xd" has none)
MINMAX_FRAMES = (None, ("whole",), ("rows", None, 0), ("rows", None, -1), ("rows", None, 2))
MINMAX = [_spec(k, a, 1, fr) for k in ("min", "max") for a in ("x", "xb", "xd")
          for fr in MINMAX_FRAMES]

# (partition columns, key domains, order columns, ascending)
SHAPES = {
    "exact_partition_int_order": (["p"], [(0, 7)], ["o"], [True]),
    "hashed_partition_two_orders": (["s", "p"], None, ["ol", "o"], [False, True]),
    "double_order_desc": ([], None, ["od"], [False]),
    "double_order_asc_in_partitions": (["p"], [(0, 7)], ["od", "xi"], [True, False]),
    "string_order": (["p"], [(0, 7)], ["xs"], [True]),
    "no_order": (["p"], [(0, 7)], [], []),
    "no_partition_no_order": ([], None, [], []),
}
GROUPS = {"ranks": RANKS, "shifts": SHIFTS, "values": VALUES, "aggregates": AGGS,
          "minmax": MINMAX}


def _assert_exact(got, want, what):
    gd, gv = got.data.numpy(), got.valid.numpy()
    wd, wv = np.asarray(want.data), np.asarray(want.valid)
    assert str(got.type) == str(want.type), what
    np.testing.assert_array_equal(gv, wv, err_msg=f"{what} valid")
    if wd.dtype == np.float64:  # bit for bit: -0.0 and NaN included
        gd, wd = gd.view(np.int64), wd.view(np.int64)
    np.testing.assert_array_equal(gd[wv], wd[wv], err_msg=f"{what} data")


@pytest.mark.parametrize("group", sorted(GROUPS))
@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_window_page_equals_reference(shape, group):
    parts, domains, orders, asc = SHAPES[shape]
    specs = GROUPS[group]
    ref_page = _page(len(shape) * 7 + len(group))
    want = ref_window.window_page(
        ref_page, [_col(ref_ir, ref_type, c) for c in parts],
        [_col(ref_ir, ref_type, c) for c in orders], asc,
        _funcs(ref_window, ref_ir, ref_type, specs), partition_domains=domains)
    got = port_window.window_page(
        to_port(ref_page), [_col(port_ir, port_type, c) for c in parts],
        [_col(port_ir, port_type, c) for c in orders], asc,
        _funcs(port_window, port_ir, port_type, specs), partition_domains=domains)
    k = len(COLUMNS)
    assert len(got.blocks) == len(want.blocks) == k + len(specs)
    for j, s in enumerate(specs):
        _assert_exact(got.blocks[k + j], want.blocks[k + j], f"{shape} {s}")


def test_row_number_follows_the_stable_sort_on_ties():
    """Rows tied on every key number in page order, as the reference's
    stable passes leave them."""
    ref_page = _page(11, n=64)
    e = [_col(port_ir, port_type, "p")]
    page = to_port(ref_page)
    got = port_window.window_page(page, e, e, [True], _funcs(port_window, port_ir, port_type,
                                                            [_spec("row_number")]))
    live = page.row_mask.numpy()
    p = page.blocks[0].data.numpy()
    pv = page.blocks[0].valid.numpy()
    rn = got.blocks[-1].data.numpy()
    for key in set(zip(p[live & pv].tolist())):
        rows = np.flatnonzero(live & pv & (p == key[0]))
        assert rn[rows].tolist() == list(range(1, len(rows) + 1))


@pytest.mark.parametrize("kind", ["min", "max"])
def test_min_max_over_int32_skips_nulls(kind):
    """A running min/max over an int32 argument with NULLs, against the
    SQL answer walked row by row.  The reference fills NULL rows with
    int64's extreme cast to int32, which wraps (-1 for min, 0 for max)
    and can win; the port fills with int32's own."""
    ref_page = _page(13, n=400)
    page = to_port(ref_page)
    p = [_col(port_ir, port_type, "p")]
    o = [_col(port_ir, port_type, "o")]
    f = _funcs(port_window, port_ir, port_type, [_spec(kind, "xi", 1, ("rows", None, 0))])
    got = port_window.window_page(page, p, o, [True], f, partition_domains=[(0, 7)])
    perm, _ = port_window.window_perm(page, p, o, [True], [(0, 7)])
    perm = perm.numpy()
    live = page.row_mask.numpy()
    pd, pv = page.blocks[0].data.numpy(), page.blocks[0].valid.numpy()
    x, xv = page.blocks[6].data.numpy(), page.blocks[6].valid.numpy()
    gd, gv = got.blocks[-1].data.numpy(), got.blocks[-1].valid.numpy()
    best, prev = None, None
    for q in perm:
        if not live[q]:
            break
        key = (pv[q], pd[q] if pv[q] else 0)
        if key != prev:
            best, prev = None, key
        if xv[q]:
            best = x[q] if best is None else (min if kind == "min" else max)(best, x[q])
        assert gv[q] == (best is not None)
        if best is not None:
            assert gd[q] == best


def test_window_sum_over_a_long_decimal_is_not_ported():
    ref_page = _page(12, n=32)
    f = port_window.WindowFunc(kind="sum", arg=_col(port_ir, port_type, "ol"))
    with pytest.raises(Exception, match="not ported"):
        port_window.window_page(to_port(ref_page), [], [], [], [f])


def test_kernel_descriptors():
    """The frames resolve as the reference's ``_compute_sorted`` does,
    and avg over a decimal divides by its scale."""
    fx = _col(port_ir, port_type, "x")
    d = port_window._func(port_window.WindowFunc("avg", fx), has_order=True)
    assert (d.kind, d.frame, d.scale) == (k10.AVG, k10.FRAME_PEERS, 2)
    d = port_window._func(port_window.WindowFunc("sum", fx), has_order=False)
    assert d.frame == k10.FRAME_WHOLE and d.scale is None
    d = port_window._func(port_window.WindowFunc("count", fx, frame=("rows", -2, None)), True)
    assert (d.frame, d.start, d.end) == (k10.FRAME_ROWS, -2, None)
