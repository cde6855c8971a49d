"""The fifth slice's double lanes at the kernel level, against the
reference on the same numpy inputs made from a seed: K1's double
columns and literals, ``+ - * /``, negation and ``abs`` (doubles and
integer lanes), comparisons in double space (double against double,
short and long decimal, integer) and CASE producing a double
(``ExprCompiler.compile``); the avg of an integer finalized as a double
by K3 on the global, packed-direct, fold and sort-path branches
(``grouped_aggregate``, ``combine_packed_states``, ``finalize_packed``,
``merge_aggregate``); K7's double keys (``topn_page``) and
``sort_page`` over doubles, with -0.0, NaN and ties.  Doubles compare
bit for bit."""

import numpy as np
import pytest
import jax.numpy as jnp

from presto_tpu.expr import compile as ref_compile
from presto_tpu.expr import ir as ref_ir
from presto_tpu.ops import aggregate as ref_agg
from presto_tpu.ops import sort as ref_sort
from presto_tpu.page import Block as RefBlock, Page as RefPage
from presto_tpu.types import parse_type as ref_type
from presto_tpu_torch.expr import compile as port_compile
from presto_tpu_torch.expr import ir as port_ir
from presto_tpu_torch.kernels import expr_eval as k1
from presto_tpu_torch.kernels import topn as k7
from presto_tpu_torch.ops import aggregate as port_agg
from presto_tpu_torch.ops import sort as port_sort
from presto_tpu_torch.types import parse_type as port_type
from torch_parity import to_port, with_nulls_and_dead_rows

COLUMNS = [("x", "double"), ("y", "double"), ("q", "decimal(12,2)"), ("l", "decimal(36,4)"),
           ("b", "bigint"), ("i", "integer"), ("g", "bigint"), ("id", "bigint")]


def _page(seed: int, n: int = 3000) -> RefPage:
    rng = np.random.default_rng(seed)
    x = rng.normal(0.0, 50.0, n)
    x[rng.random(n) < 0.05] = 0.0
    x[rng.random(n) < 0.05] = -0.0
    x[rng.random(n) < 0.03] = np.nan
    x[rng.random(n) < 0.2] = 1.25  # ties
    y = rng.normal(0.0, 50.0, n)
    y[rng.random(n) < 0.1] = 0.0
    i = rng.integers(-1000, 1000, n).astype(np.int32)
    i[rng.random(n) < 0.02] = np.iinfo(np.int32).min
    b = rng.integers(-10 ** 12, 10 ** 12, n)
    b[rng.random(n) < 0.02] = np.iinfo(np.int64).min
    cols = [x, y, rng.integers(-10 ** 6, 10 ** 6, n),
            np.stack([rng.integers(-3, 3, n), rng.integers(0, 10 ** 18, n)], 1), b, i,
            rng.integers(0, 30, n), np.arange(n)]
    blocks = [RefBlock(jnp.asarray(c), jnp.ones(n, jnp.bool_), ref_type(t))
              for c, (_, t) in zip(cols, COLUMNS)]
    page = with_nulls_and_dead_rows(RefPage(tuple(blocks), jnp.ones(n, jnp.bool_)), rng,
                                    null_rate=0.1, dead_rate=0.1)
    keep = [RefBlock(b.data, jnp.ones(n, jnp.bool_), b.type) if name == "id" else b
            for b, (name, _) in zip(page.blocks, COLUMNS)]
    return RefPage(tuple(keep), page.row_mask)


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


EXPRS = {
    "dadd": ("add", "double", "x", "y"),
    "dsub_decimal": ("sub", "double", "q", "x"),
    "dmul_integer": ("mul", "double", "i", "y"),
    "ddiv_zero_divisor": ("div", "double", "x", "y"),
    "ddiv_long": ("div", "double", "l", "x"),
    "dneg": ("neg", "double", "x"),
    "dabs": ("abs", "double", ("sub", "double", "q", "x")),
    "abs_decimal": ("abs", "decimal(12,2)", "q"),
    "abs_int32_least": ("abs", "integer", "i"),
    "neg_int64_least": ("neg", "bigint", "b"),
    "dlit": ("mul", "double", "x", ("lit", 0.1, "double")),
    "dlt": ("lt", "boolean", "x", "y"),
    "dge_decimal": ("ge", "boolean", "q", "x"),
    "deq_long": ("eq", "boolean", "l", "x"),
    "dne_integer": ("ne", "boolean", "i", "x"),
    "dgt_literal": ("gt", "boolean", ("div", "double", ("abs", "double", ("sub", "double", "q", "x")),
                                      "y"), ("lit", 1, "decimal(1,1)")),
    "dbetween": ("between", "boolean", "x", ("lit", -10, "integer"), "q"),
    "case_double": ("case", "double", ("gt", "boolean", "y", ("lit", 0, "integer")),
                    ("div", "double", "x", "y"), ("lit", None, "double")),
    "cast_double": ("cast_double", "double", "b"),
}
OPCODE = {"dadd": k1.DADD, "dsub_decimal": k1.DSUB, "dmul_integer": k1.DMUL, "dneg": k1.DNEG,
          "dabs": k1.DABS, "abs_int32_least": k1.ABS, "neg_int64_least": k1.NEG,
          "dlit": k1.DLIT, "dlt": k1.DCMP, "dge_decimal": k1.S2D, "deq_long": k1.L2D,
          "cast_double": k1.S2D}


def _same_bits(ref, got, what):
    rd, rv = np.asarray(ref[0]), np.asarray(ref[1])
    gd, gv = got[0].numpy(), got[1].numpy()
    np.testing.assert_array_equal(gv, rv, err_msg=f"{what} valid")
    if rd.dtype == np.float64:
        rd, gd = rd.view(np.int64), gd.view(np.int64)
    np.testing.assert_array_equal(gd[rv], rd[rv], err_msg=f"{what} data")


@pytest.mark.parametrize("name", sorted(EXPRS))
@pytest.mark.parametrize("seed", [0, 1])
def test_double_lanes_equal_reference(name, seed):
    ref_page = _page(seed)
    port_page = to_port(ref_page)
    ref_e, port_e = _expr(EXPRS[name], ref_ir, ref_type), _expr(EXPRS[name], port_ir, port_type)
    ref = ref_compile.ExprCompiler.for_page(ref_page).compile(ref_e)(ref_page)
    got = port_compile.ExprCompiler.for_page(port_page).compile(port_e)(port_page)
    _same_bits(ref, got, name)
    if ref_e.type.name == "boolean":
        want = ref_compile.compile_filter(ref_e, ref_page)(ref_page)
        mask = port_compile.compile_filter(port_e, port_page)(port_page)
        np.testing.assert_array_equal(mask.numpy(), np.asarray(want))


@pytest.mark.parametrize("name", sorted(OPCODE))
def test_double_lanes_lower_as_expected(name):
    """Each expression takes its opcode; a program with a double lane
    runs on the wide interpreter, integer negation on either."""
    c = port_compile.ExprCompiler.for_page(to_port(_page(2, 16)))
    prog, _ = c.lower(_expr(EXPRS[name], port_ir, port_type))
    assert OPCODE[name] in prog.ops
    assert prog.wide == (name not in ("abs_int32_least", "neg_int64_least"))


def test_double_literal_subtrees_fold():
    """0.1 * 3 folds on the host into one double constant."""
    c = port_compile.ExprCompiler.for_page(to_port(_page(3, 16)))
    e = _expr(("add", "double", "x", ("mul", "double", ("lit", 0.1, "double"),
                                      ("lit", 3, "integer"))), port_ir, port_type)
    prog, _ = c.lower(e)
    assert prog.ops == (k1.LOAD_F64, k1.DLIT, k1.DADD)
    assert k1.bits_double(prog.consts[0]) == 0.1 * 3.0


# -- avg of an integer, finalized as a double --------------------------------

def _aggs(ir, parse_type, mod):
    out = []
    for fn, col in (("avg", "i"), ("avg", "b"), ("avg", "g"), ("count", "i")):
        call = ir.AggCall(fn=fn, arg=_col(ir, parse_type, col), type=parse_type("bigint"))
        out.append(ir.AggCall(fn=fn, arg=call.arg, type=mod.output_type(call)))
    return out


def _both_pages(got, want):
    assert [str(b.type) for b in got.blocks] == [str(b.type) for b in want.blocks]
    assert "double" in [str(b.type) for b in got.blocks]
    np.testing.assert_array_equal(got.row_mask.numpy(), np.asarray(want.row_mask))
    for gb, wb in zip(got.blocks, want.blocks):
        _same_bits((wb.data, wb.valid), (gb.data, gb.valid), str(wb.type))


def _small_ints(page: RefPage) -> RefPage:
    """Sums that stay inside 2^63: the least bigint only where NULL."""
    b = np.asarray(page.blocks[4].data)
    blocks = list(page.blocks)
    blocks[4] = RefBlock(jnp.asarray(np.where(b == np.iinfo(np.int64).min, 0, b)),
                         page.blocks[4].valid, page.blocks[4].type)
    return RefPage(tuple(blocks), page.row_mask)


@pytest.mark.parametrize("branch", ["global", "packed", "sort_path"])
def test_avg_of_integers_finalizes_to_double(branch):
    ref_page = _small_ints(_page(4))
    keys, mg, kd = {"global": ([], 1, None), "packed": (["g"], 32, [(0, 29)]),
                    "sort_path": (["g"], 32, None)}[branch]
    want = ref_agg.grouped_aggregate(ref_page, [_col(ref_ir, ref_type, k) for k in keys],
                                     _aggs(ref_ir, ref_type, ref_agg), mg, key_domains=kd,
                                     mode="single")
    got = port_agg.grouped_aggregate(to_port(ref_page),
                                     [_col(port_ir, port_type, k) for k in keys],
                                     _aggs(port_ir, port_type, port_agg), mg, key_domains=kd,
                                     mode="single")
    if branch == "sort_path":  # the port emits the groups it finds, in key order
        assert got.to_pylist() == [r for r in want.to_pylist()]
        return
    _both_pages(got, want)


def test_avg_double_folds_and_merges():
    """Two splits' partial states: folded slot by slot (packed) and
    merged (sort path), then finalized as doubles."""
    pages = [_small_ints(_page(s)) for s in (5, 6)]
    kd = [(0, 29)]
    ref_k, port_k = [_col(ref_ir, ref_type, "g")], [_col(port_ir, port_type, "g")]
    ra, pa = _aggs(ref_ir, ref_type, ref_agg), _aggs(port_ir, port_type, port_agg)
    rp = [ref_agg.grouped_aggregate(p, ref_k, ra, 32, key_domains=kd, mode="partial")
          for p in pages]
    pp = [port_agg.grouped_aggregate(to_port(p), port_k, pa, 32, key_domains=kd,
                                     mode="partial") for p in pages]
    want = ref_agg.finalize_packed(ref_agg.combine_packed_states(rp[0], rp[1], 1, ra), 1, ra)
    got = port_agg.finalize_packed(port_agg.combine_packed_states(pp[0], pp[1], 1, pa), 1, pa)
    _both_pages(got, want)
    from presto_tpu.exec.local import concat_pages_device as ref_concat
    from presto_tpu_torch.page import concat_pages_device as port_concat

    sp = [port_agg.grouped_aggregate(to_port(p), port_k, pa, 32, mode="partial")
          for p in pages]
    got = port_agg.merge_aggregate(port_concat(sp), 1, pa, 32, mode="single")
    rs = [ref_agg.grouped_aggregate(p, ref_k, ra, 32, mode="partial") for p in pages]
    want = ref_agg.merge_aggregate(ref_concat(rs), 1, ra, 32, mode="single")
    assert got.to_pylist() == want.to_pylist()


# -- double sort keys -----------------------------------------------------------

ORDERS = {"asc": (["x", "id"], [True, True], [False, False]),
          "desc_nulls_first": (["x"], [False], [True]),
          "two_doubles": (["y", "x"], [False, True], [False, False]),
          "decimal_then_double": (["q", "x"], [True, False], None)}


def _ids(page) -> list:
    ids = page.blocks[-1].data
    mask = np.asarray(page.row_mask) if not hasattr(page.row_mask, "numpy") \
        else page.row_mask.numpy()
    ids = np.asarray(ids) if not hasattr(ids, "numpy") else ids.numpy()
    return ids[mask].tolist()


@pytest.mark.parametrize("order", sorted(ORDERS))
@pytest.mark.parametrize("n", [7, 100])
def test_topn_over_double_keys_equals_reference(order, n):
    """K7's twin picks the reference's rows, in its order: -0.0 ties
    0.0, NaN last either way, ties by position."""
    names, asc, nf = ORDERS[order]
    ref_page = _page(len(order) + n)
    want = ref_sort.topn_page(ref_page, [_col(ref_ir, ref_type, c) for c in names], asc, n, nf)
    got = port_sort.topn_page(to_port(ref_page), [_col(port_ir, port_type, c) for c in names],
                              asc, n, nf)
    assert _ids(got) == _ids(want)[:n]
    assert len(_ids(got)) == n


@pytest.mark.parametrize("order", sorted(ORDERS))
def test_sort_over_double_keys_equals_reference(order):
    names, asc, nf = ORDERS[order]
    ref_page = _page(len(order))
    want = ref_sort.sort_page(ref_page, [_col(ref_ir, ref_type, c) for c in names], asc, nf)
    got = port_sort.sort_page(to_port(ref_page), [_col(port_ir, port_type, c) for c in names],
                              asc, nf)
    assert _ids(got) == _ids(want)


def test_double_sort_key_orders_as_xla():
    """-0.0 and 0.0 tie, NaN (either sign) after +inf, a descending key
    negated first."""
    import torch

    x = torch.tensor([1.0, -0.0, float("nan"), 0.0, float("-inf"), -2.5, float("inf"),
                      -float("nan")], dtype=torch.float64)
    asc = k7.double_sort_key(x, True)
    assert torch.argsort(asc, stable=True).tolist() == [4, 5, 1, 3, 0, 6, 2, 7]
    desc = k7.double_sort_key(x, False)
    assert torch.argsort(desc, stable=True).tolist() == [6, 0, 1, 3, 5, 4, 2, 7]
