"""presto_tpu_torch's CUDA kernels against their plain PyTorch versions
on the card, and the ported TPC-H queries on the card against the
port's own CPU run.  Marked ``gpu``: each test skips without a CUDA device.  This file
imports neither JAX nor the reference package, so it also runs where
JAX is absent:

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_gpu.py
"""

import numpy as np
import pytest
import torch

from presto_tpu_torch.expr import ir
from presto_tpu_torch.expr.compile import ExprCompiler
from presto_tpu_torch.kernels import expr_eval as k1
from presto_tpu_torch.kernels import join_build as k4
from presto_tpu_torch.kernels import join_expand as k8
from presto_tpu_torch.kernels import join_probe as k5
from presto_tpu_torch.kernels import keys as pk
from presto_tpu_torch.kernels import packed_fold_finalize as k3
from presto_tpu_torch.kernels import packed_group_agg as k2
from presto_tpu_torch.kernels import sorted_group_agg as k6
from presto_tpu_torch.kernels import topn as k7
from presto_tpu_torch.kernels import window_eval as k10
from presto_tpu_torch.page import Block, Dictionary, Page
from presto_tpu_torch.types import parse_type
from tpch_queries import QUERIES

pytestmark = pytest.mark.gpu

I64_MAX = (1 << 63) - 1
EDGES = np.array([I64_MAX, -I64_MAX - 1, I64_MAX - 1, 1 << 62, -(1 << 62), 3037000499,
                  -3037000500, I64_MAX // 100, I64_MAX // 100 + 1, 0, 1, -1],
                 dtype=np.int64)


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _page(n: int, seed: int, device) -> Page:
    rng = np.random.default_rng(seed)
    types = ["decimal(12,2)", "decimal(18,2)", "bigint", "bigint", "date", "boolean"]
    blocks = []
    for t in types:
        if t == "boolean":
            data = rng.random(n) < 0.5
        elif t == "date":
            data = rng.integers(8000, 11000, n).astype(np.int32)
        else:
            data = rng.integers(-10 ** 12, 10 ** 12, n)
            pick = rng.random(n) < 0.3
            data[pick] = rng.choice(EDGES, pick.sum())
        blocks.append(Block(torch.from_numpy(data).to(device),
                            torch.from_numpy(rng.random(n) >= 0.15).to(device),
                            parse_type(t)))
    return Page(tuple(blocks), torch.from_numpy(rng.random(n) >= 0.1).to(device))


def _col(i, t):
    return ir.ColumnRef(type=parse_type(t), index=i)


def _call(fn, t, *args):
    return ir.Call(type=parse_type(t), fn=fn, args=tuple(args))


def _lit(v, t):
    return ir.Literal(type=parse_type(t), value=v)


EXPRS = [
    _call("add", "bigint", _col(2, "bigint"), _col(3, "bigint")),
    _call("sub", "bigint", _col(2, "bigint"), _col(3, "bigint")),
    _call("mul", "bigint", _col(2, "bigint"), _col(3, "bigint")),
    _call("add", "decimal(18,2)", _col(1, "decimal(18,2)"), _col(3, "bigint")),
    _call("mul", "decimal(18,4)", _col(1, "decimal(18,2)"), _col(0, "decimal(12,2)")),
    _call("sub", "decimal(13,2)", _lit(1, "bigint"), _col(0, "decimal(12,2)")),
    _call("lt", "boolean", _col(1, "decimal(18,2)"), _col(2, "bigint")),
    _call("between", "boolean", _col(1, "decimal(18,2)"), _col(2, "bigint"),
          _lit(5, "decimal(12,2)")),
    _call("and", "boolean", _call("le", "boolean", _col(4, "date"), _lit(10471, "date")),
          _call("or", "boolean", _col(5, "boolean"),
                _call("not", "boolean", _call("eq", "boolean", _col(2, "bigint"),
                                              _col(3, "bigint"))))),
]


@pytest.mark.parametrize("i", range(len(EXPRS)))
def test_expr_eval_kernel_matches_plain(i):
    dev = _cuda()
    page = _page(1 << 20, i, dev)
    prog, cols = ExprCompiler.for_page(page).lower(EXPRS[i])
    ins = [(page.blocks[c].data, page.blocks[c].valid) for c in cols]
    n = page.capacity
    before = k1.launches
    got = k1.expr_eval(prog, ins, n)
    assert k1.launches == before + 1
    want = k1.expr_eval_plain(prog, ins, n)
    torch.cuda.synchronize()
    assert torch.equal(got[1], want[1])
    assert torch.equal(got[0], want[0])
    if EXPRS[i].type.name == "boolean":
        assert torch.equal(k1.expr_eval(prog, ins, n, row_mask=page.row_mask),
                           k1.expr_eval_plain(prog, ins, n, row_mask=page.row_mask))


def _agg_inputs(page):
    b = page.blocks
    return [(k2.COUNT_STAR, None, None), (k2.COUNT, b[0].data, b[0].valid),
            (k2.SUM_SHORT, b[0].data, b[0].valid), (k2.SUM_LONG, b[1].data, b[1].valid),
            (k2.SUM_SHORT, b[2].data, b[2].valid)]


@pytest.mark.parametrize("slots", [1, 12, 16, 16384])
def test_packed_group_agg_kernel_matches_plain(slots):
    dev = _cuda()
    page = _page(1 << 20, slots, dev)
    n = page.capacity
    if slots == 1:
        keys = []
    elif slots == 16384:  # global-atomics path
        keys = [(torch.remainder(page.blocks[2].data, 16383), page.blocks[2].valid, 0, 16384)]
    else:  # shared-memory path; codes out of the key domain are dropped
        card = 4 if slots == 16 else 3
        keys = [(torch.remainder(page.blocks[4].data, 4), page.blocks[4].valid, 0, 4),
                (torch.remainder(page.blocks[2].data, card), page.blocks[3].valid, 0, card)]
    got = k2.packed_group_agg(n, page.row_mask, keys, _agg_inputs(page), slots)
    want = k2.packed_group_agg_plain(n, page.row_mask, keys, _agg_inputs(page), slots)
    torch.cuda.synchronize()
    assert torch.equal(got[1], want[1])
    for g, w in zip(got[0], want[0]):
        for a, b in zip(g, w):
            assert torch.equal(a, b)


def test_packed_fold_finalize_kernel_matches_plain():
    dev = _cuda()
    parts = []
    for seed in (1, 2):
        page = _page(1 << 18, seed, dev)
        keys = [(torch.remainder(page.blocks[4].data, 4), page.blocks[4].valid, 0, 4)]
        states, present = k2.packed_group_agg(page.capacity, page.row_mask, keys,
                                              _agg_inputs(page), 4)
        parts.append((states, present))
    kinds = [k3.COL_I64] * 4 + [k3.COL_D128] + [k3.COL_I64] * 3

    def cols(states, present):
        flat = [t for s in states for t in s]
        return [(k, t, present) for k, t in zip(kinds, flat)]

    a, b = cols(*parts[0]), cols(*parts[1])
    got = k3.packed_fold(a, b, parts[0][1], parts[1][1])
    want = k3.packed_fold_plain(a, b, parts[0][1], parts[1][1])
    torch.cuda.synchronize()
    for x, y in zip(got[0], want[0]):
        assert torch.equal(x[0], y[0]) and torch.equal(x[1], y[1])
    assert torch.equal(got[1], want[1])
    f = [c for c, _ in got[0]]
    items = [(k3.FIN_COUNT, f[0], f[0]), (k3.FIN_COUNT, f[1], f[1]),
             (k3.FIN_SUM, f[2], f[3]), (k3.FIN_AVG_SHORT, f[2], f[3]),
             (k3.FIN_SUM_D128, f[4], f[5]), (k3.FIN_AVG_D128, f[4], f[5]),
             (k3.FIN_AVG_D128_NARROW, f[4], f[5]), (k3.FIN_AVG_SHORT, f[6], f[7])]
    for (gd, gv), (wd, wv) in zip(k3.packed_finalize(items, got[1]),
                                  k3.packed_finalize_plain(items, got[1])):
        assert torch.equal(gd, wd) and torch.equal(gv, wv)


def _wide_page(n: int, seed: int, device) -> Page:
    """Dictionary codes, short and long decimals (with zeros and
    negatives), NULLs and dead rows."""
    rng = np.random.default_rng(seed)
    words = ["PROMO BRUSHED", "STANDARD TIN", "PROMO PLATED", "ECONOMY", "BUILDING"]
    long_a = np.stack([rng.integers(-10 ** 6, 10 ** 6, n),
                       rng.integers(0, 10 ** 18, n)], 1)
    long_b = long_a.copy()
    long_b[rng.random(n) < 0.2] = 0  # zero divisors
    cols = [(rng.integers(0, len(words), n).astype(np.int32), "varchar"),
            (rng.integers(-10 ** 12, 10 ** 12, n), "decimal(18,2)"),
            (long_a, "decimal(36,4)"), (long_b, "decimal(36,4)"),
            (rng.random(n) < 0.5, "boolean")]
    blocks = [Block(torch.from_numpy(d).to(device),
                    torch.from_numpy(rng.random(n) >= 0.15).to(device), parse_type(t),
                    Dictionary(words) if t == "varchar" else None) for d, t in cols]
    return Page(tuple(blocks), torch.from_numpy(rng.random(n) >= 0.1).to(device))


WIDE_EXPRS = [
    _call("like", "boolean", _col(0, "varchar"), _lit("PROMO%", "varchar")),
    _call("ne", "boolean", _col(0, "varchar"), _lit("BUILDING", "varchar")),
    _call("case", "decimal(18,2)",
          _call("like", "boolean", _col(0, "varchar"), _lit("%TIN", "varchar")),
          _col(1, "decimal(18,2)"), _col(4, "boolean"), _lit(7, "decimal(18,2)"),
          _lit(0, "bigint")),
    _call("div", "double", _call("mul", "decimal(36,6)", _lit(10000, "decimal(18,2)"),
                                 _col(2, "decimal(36,4)")), _col(3, "decimal(36,4)")),
]


@pytest.mark.parametrize("i", range(len(WIDE_EXPRS)))
def test_expr_eval_new_opcodes_match_plain(i):
    dev = _cuda()
    page = _wide_page(1 << 20, i, dev)
    prog, cols = ExprCompiler.for_page(page).lower(WIDE_EXPRS[i])
    ins = [(page.blocks[c].data, page.blocks[c].valid) for c in cols]
    got = k1.expr_eval(prog, ins, page.capacity)
    want = k1.expr_eval_plain(prog, ins, page.capacity)
    torch.cuda.synchronize()
    assert torch.equal(got[1], want[1])
    assert torch.equal(got[0][want[1]], want[0][want[1]])  # doubles bit for bit


def _join_keys(n: int, seed: int, device, domain: int, dup: bool):
    rng = np.random.default_rng(seed)
    keys = rng.permutation(domain)[:n] + 1  # unique, in [1, domain]
    if dup:
        keys[n // 2] = keys[0]
    valid = rng.random(n) >= 0.05
    mask = rng.random(n) >= 0.05
    return ((torch.from_numpy(keys).to(device), torch.from_numpy(valid).to(device), 1,
             domain + 1), torch.from_numpy(mask).to(device))


@pytest.mark.parametrize("dup", [False, True])
def test_join_build_kernel_matches_plain(dup):
    dev = _cuda()
    key, mask = _join_keys(1 << 18, 3, dev, 1 << 20, dup)
    prod = (1 << 20) + 2
    got = k4.join_build_unique([key], mask, prod)
    want = k4.join_build_unique_plain([key], mask, prod)
    torch.cuda.synchronize()
    assert bool(got[3]) == (not dup) == bool(want[3])
    assert torch.equal(got[0], want[0]) and torch.equal(got[2], want[2])
    assert torch.equal(got[4], want[4]) and got[4].tolist() == [1, 1]  # NULL key, live
    if not dup:  # a collision leaves which row wins a slot open
        assert torch.equal(got[1], want[1])
    for domain in (prod, None):
        g = k4.join_build_sorted([key], mask, domain)
        w = k4.join_build_sorted_plain([key], mask, domain)
        torch.cuda.synchronize()
        assert torch.equal(g[0], w[0]) and torch.equal(g[1], w[1])
        assert (g[2] is None and w[2] is None) or torch.equal(g[2], w[2])
        assert torch.equal(g[3], w[3])


@pytest.mark.parametrize("direct", [True, False])
def test_join_probe_kernel_matches_plain(direct):
    dev = _cuda()
    bkey, bmask = _join_keys(1 << 16, 4, dev, 1 << 18, False)
    prod = (1 << 18) + 2
    sk, perm, starts, _ = k4.join_build_sorted_plain([bkey], bmask, prod if direct else None)
    rng = np.random.default_rng(5)
    n = 1 << 20
    pkey = (torch.from_numpy(rng.integers(-2, (1 << 18) + 3, n)).to(dev),
            torch.from_numpy(rng.random(n) >= 0.05).to(dev), 1, prod)
    pmask = torch.from_numpy(rng.random(n) >= 0.05).to(dev)
    build_cols = [(bkey[0], bkey[1]),
                  (torch.from_numpy(rng.integers(0, 9, (1 << 16, 2))).to(dev), bmask),
                  (torch.from_numpy(rng.integers(0, 9, 1 << 16).astype(np.int32)).to(dev),
                   bmask), (bmask, bkey[1])]
    got = k5.join_probe([pkey], pmask, sk, perm, starts, build_cols)
    want = k5.join_probe_plain([pkey], pmask, sk, perm, starts, build_cols)
    torch.cuda.synchronize()
    assert torch.equal(got[1], want[1]) and int(got[1].sum()) > 0
    for (gd, gv), (wd, wv) in zip(got[0], want[0]):
        assert torch.equal(gd, wd) and torch.equal(gv, wv)


def test_sorted_group_agg_kernel_matches_plain():
    dev = _cuda()
    page = _page(1 << 20, 7, dev)
    b = page.blocks
    keys = [(torch.remainder(b[2].data, 50000), b[2].valid, 0, 50001),
            (b[4].data, b[4].valid, 8000, 3002)]
    states = [(k6.S_ONE, None, None), (k6.S_VALID, None, b[0].valid),
              (k6.S_SUM, b[3].data, b[3].valid), (k6.S_LIMBS_SHORT, b[1].data, b[1].valid),
              (k6.S_LIMBS_LONG, torch.stack([b[2].data, torch.remainder(b[3].data, 10 ** 18)],
                                            1), b[0].valid)]
    got = k6.sorted_group_agg(keys, page.row_mask, states)
    want = k6.sorted_group_agg_plain(keys, page.row_mask, states)
    torch.cuda.synchronize()
    assert got[2] == want[2] > 1000
    for x, y in zip(got[0] + got[1], want[0] + want[1]):
        if isinstance(x, tuple):
            assert torch.equal(x[0], y[0]) and torch.equal(x[1], y[1])
        else:
            assert torch.equal(x, y)


def test_topn_kernel_matches_plain():
    dev = _cuda()
    rng = np.random.default_rng(8)
    n = 1 << 20
    limbs = torch.from_numpy(np.stack([rng.integers(-3, 3, n), rng.integers(0, 4, n)], 1))
    keys = [(limbs.to(dev), torch.from_numpy(rng.random(n) >= 0.01).to(dev), False, True),
            (torch.from_numpy(rng.integers(0, 5, n).astype(np.int32)).to(dev),
             torch.from_numpy(rng.random(n) >= 0.3).to(dev), True, False)]
    mask = torch.from_numpy(rng.random(n) >= 0.2).to(dev)
    for k in (1, 10, 32):
        got = k7.topn(keys, mask, k)
        want = k7.topn_plain(keys, mask, k)
        torch.cuda.synchronize()
        assert torch.equal(got[1], want[1]) and torch.equal(got[0], want[0])


def test_q6_q1_on_the_card_equal_the_cpu_run():
    _cuda()
    from presto_tpu_torch.testing import LocalQueryRunner

    gpu = LocalQueryRunner(sf=0.01, device="cuda")
    cpu = LocalQueryRunner(sf=0.01, device="cpu")
    for mod in (k1, k2, k3):
        mod.launches = 0
    for q in (6, 1):
        assert gpu.execute(QUERIES[q]).rows == cpu.execute(QUERIES[q]).rows
    assert k1.launches > 0 and k2.launches > 0 and k3.launches > 0


def test_q14_q3_on_the_card_equal_the_cpu_run():
    _cuda()
    from presto_tpu_torch.testing import LocalQueryRunner

    gpu = LocalQueryRunner(sf=0.01, device="cuda")
    cpu = LocalQueryRunner(sf=0.01, device="cpu")
    mods = (k1, k3, k4, k5, k6, k7)
    for mod in mods:
        mod.launches = 0
    for q in (14, 3):
        assert gpu.execute(QUERIES[q]).rows == cpu.execute(QUERIES[q]).rows
    assert all(mod.launches > 0 for mod in mods)


@pytest.mark.parametrize("q", [6, 1])
def test_cpu_runner_over_a_card_connector_equals_the_cpu_run(q):
    _cuda()
    from presto_tpu_torch.catalog import Catalog
    from presto_tpu_torch.connectors.memory import MemoryConnector
    from presto_tpu_torch.connectors.tpch import Tpch
    from presto_tpu_torch.runner import QueryRunner

    def runner(table_device, device):
        mem = MemoryConnector(device=table_device)
        mem.load_from(Tpch(sf=0.01), "lineitem")
        cat = Catalog()
        cat.register("tpch", mem)
        return QueryRunner(cat, device=device)

    # every split the CPU runner reads is copied off the card first
    assert (runner("cuda", "cpu").execute(QUERIES[q]).rows
            == runner("cpu", "cpu").execute(QUERIES[q]).rows)


def _skewed_build(dev, n=1 << 16, domain=1 << 12, seed=10):
    """Build keys with repeats and one hot key (7) on a quarter of the
    rows, NULL keys and dead rows."""
    rng = np.random.default_rng(seed)
    keys = rng.integers(1, domain + 1, n)
    keys[rng.random(n) < 0.25] = 7
    valid = rng.random(n) >= 0.05
    mask = rng.random(n) >= 0.05
    return (torch.from_numpy(keys).to(dev), torch.from_numpy(valid).to(dev)), \
        torch.from_numpy(mask).to(dev)


def _probe_keys(dev, n, domain, seed):
    rng = np.random.default_rng(seed)
    keys = rng.integers(-2, domain + 3, n)
    keys[rng.random(n) < 0.001] = 7
    return (torch.from_numpy(keys).to(dev), torch.from_numpy(rng.random(n) >= 0.05).to(dev)), \
        torch.from_numpy(rng.random(n) >= 0.05).to(dev)


def _keys_for(col, mode, domain):
    if mode == "hashed":
        return [(col[0], col[1], 0, 0)]
    return [(col[0], col[1], 1, domain + 1)]


@pytest.mark.parametrize("mode", ["direct", "search", "hashed"])
@pytest.mark.parametrize("null_aware", [False, True])
@pytest.mark.parametrize("kind", [k5.LEFT, k5.SEMI, k5.ANTI, k5.MARK])
def test_join_probe_kinds_kernel_matches_plain(kind, null_aware, mode):
    dev = _cuda()
    domain = 1 << 12
    bcol, bmask = _skewed_build(dev, domain=domain)
    bkeys = _keys_for(bcol, mode, domain)
    sk, perm, starts, flags = k4.join_build_sorted(bkeys, bmask,
                                                   domain + 2 if mode == "direct" else None)
    pcol, pmask = _probe_keys(dev, 1 << 20, domain, 11)
    pkeys = _keys_for(pcol, mode, domain)
    cols = [(bcol[0], bcol[1]), (bmask, bcol[1])] if kind == k5.LEFT else []
    args = (pkeys, pmask, sk, perm, starts, cols, kind, False, null_aware, flags)
    got = k5.join_probe(*args)
    want = k5.join_probe_plain(*args)
    torch.cuda.synchronize()
    assert torch.equal(got[1], want[1])
    # the build holds a NULL key: NOT IN keeps no row
    assert (int(got[1].sum()) == 0) == (kind == k5.ANTI and null_aware)
    for (gd, gv), (wd, wv) in zip(got[0], want[0]):
        assert torch.equal(gd, wd) and torch.equal(gv, wv)


@pytest.mark.parametrize("mode", ["direct", "search", "hashed"])
@pytest.mark.parametrize("kind", ["inner", "left", "full"])
def test_join_expand_kernel_matches_plain(kind, mode):
    dev = _cuda()
    domain = 1 << 12
    bcol, bmask = _skewed_build(dev, domain=domain)
    bkeys = _keys_for(bcol, mode, domain)
    sk, perm, starts, _ = k4.join_build_sorted(bkeys, bmask,
                                               domain + 2 if mode == "direct" else None)
    pcol, pmask = _probe_keys(dev, 1 << 16, domain, 12)
    pkeys = _keys_for(pcol, mode, domain)
    rng = np.random.default_rng(13)
    probe_cols = [pcol, (torch.from_numpy(rng.integers(0, 9, (1 << 16, 2))).to(dev), pmask)]
    build_cols = [bcol, (torch.from_numpy(rng.integers(0, 9, 1 << 16).astype(np.int32))
                         .to(dev), bmask), (bmask, bcol[1])]
    wide_build = build_cols + build_cols[1:11]  # 71 columns: two runs of K5
    k8.launches = k5.launches = 0
    outs = []
    for fn in (k8.join_expand, k8.join_expand_plain):
        matched = torch.zeros(1 << 16, dtype=torch.bool, device=dev) if kind == "full" else None
        outs.append(fn(pkeys, pmask, sk, perm, starts, probe_cols, build_cols,
                       kind != "inner", False, matched) + (matched,))
    torch.cuda.synchronize()
    (gp, gb, gt, gm), (wp, wb, wt, wm) = outs
    assert gt == wt > 4 * (1 << 16)  # the hot key expands past the probe's size
    for (gd, gv), (wd, wv) in zip(gp + gb, wp + wb):
        assert torch.equal(gd, wd) and torch.equal(gv, wv)
    assert (gm is None and wm is None) or (torch.equal(gm, wm) and bool(gm.any()))


def test_hash_keys_kernel_matches_plain():
    dev = _cuda()
    page = _page(1 << 20, 14, dev)
    b = page.blocks
    keys = [(b[2].data, b[2].valid, 0, 0), (b[4].data, b[4].valid, 0, 0),
            (b[5].data, b[5].valid, 0, 0)]
    for sentinel in (False, True):
        pk.launches = 0
        got = pk.hash_keys(keys, page.row_mask, sentinel)
        want = pk.masked_plain(keys, page.row_mask, sentinel)[0]
        torch.cuda.synchronize()
        assert pk.launches == 1 and torch.equal(got, want)


def test_expr_eval_in_and_canon_match_plain():
    dev = _cuda()
    page = _page(1 << 20, 15, dev)
    rng = np.random.default_rng(15)
    words = ["MAIL", "SHIP", "AIR", "MAIL", "AIR REG"]
    codes = torch.from_numpy(rng.integers(0, len(words), 1 << 20).astype(np.int32)).to(dev)
    blocks = page.blocks + (Block(codes, page.blocks[0].valid, parse_type("varchar"),
                                  Dictionary(words)),)
    page = Page(blocks, page.row_mask)
    c = ExprCompiler.for_page(page)
    exprs = [_call("in", "boolean", _col(4, "date"), *[_lit(v, "date") for v in
                                                       range(8000, 11000, 97)]),
             _call("in", "boolean", _col(6, "varchar"), _lit("MAIL", "varchar"),
                   _lit("AIR REG", "varchar"))]
    for e in exprs:
        prog, cols = c.lower(e)
        ins = [(page.blocks[i].data, page.blocks[i].valid) for i in cols]
        for mask in (None, page.row_mask):
            got = k1.expr_eval(prog, ins, 1 << 20, row_mask=mask)
            want = k1.expr_eval_plain(prog, ins, 1 << 20, row_mask=mask)
            torch.cuda.synchronize()
            assert all(torch.equal(g, w) for g, w in zip(got, want)) if mask is None \
                else torch.equal(got, want)
    prog, cols = c.lower_key(_col(6, "varchar"))
    ins = [(page.blocks[i].data, page.blocks[i].valid) for i in cols]
    k1.launches = 0
    canon = c.compile_key(_col(6, "varchar"))(page)
    want = k1.expr_eval_plain(prog, ins, 1 << 20)
    torch.cuda.synchronize()
    assert k1.launches == 1
    assert torch.equal(canon[0], want[0]) and torch.equal(canon[1], want[1])
    assert set(canon[0].unique().tolist()) == {0, 1, 2, 4}  # the second MAIL maps to 0


def test_join_slice_on_the_card_equals_the_cpu_run():
    """TPC-H Q4, Q5, Q10, Q12, Q13, Q16, Q19 and Q20 at sf 0.01 on the
    card, with K5's new kinds, K8 and K9 launched."""
    _cuda()
    from presto_tpu_torch.testing import LocalQueryRunner

    gpu = LocalQueryRunner(sf=0.01, device="cuda")
    cpu = LocalQueryRunner(sf=0.01, device="cpu")
    for mod in (k5, k8, pk):
        mod.launches = 0
    for q in (4, 5, 10, 12, 13, 16, 19, 20):
        got = gpu.execute(QUERIES[q]).rows
        assert got == cpu.execute(QUERIES[q]).rows and got
    assert k5.launches > 0 and k8.launches > 0 and pk.launches > 0


def _minmax_page(n: int, seed: int, device) -> Page:
    """Dates around 1970 (and 29 February), short decimals, long
    decimals whose high limbs tie often, bigint keys; NULLs and dead
    rows."""
    rng = np.random.default_rng(seed)
    days = rng.integers(-800, 20000, n)
    days[rng.random(n) < 0.1] = 11016  # 2000-02-29
    long_v = np.stack([rng.integers(-3, 3, n), rng.integers(0, 10 ** 18, n)], 1)
    cols = [(days.astype(np.int32), "date"),
            (rng.integers(-10 ** 9, 10 ** 9, n), "decimal(12,2)"),
            (long_v, "decimal(36,4)"),
            (np.stack([rng.integers(-3, 3, n), rng.integers(0, 10 ** 18, n)], 1),
             "decimal(36,2)"),
            (rng.integers(0, 40, n), "bigint")]
    blocks = [Block(torch.from_numpy(d).to(device),
                    torch.from_numpy(rng.random(n) >= 0.1).to(device), parse_type(t))
              for d, t in cols]
    return Page(tuple(blocks), torch.from_numpy(rng.random(n) >= 0.1).to(device))


SLICE4_EXPRS = [
    _call("year", "bigint", _col(0, "date")),
    _call("month", "bigint", _col(0, "date")),
    _call("day", "bigint", _col(0, "date")),
    _call("quarter", "bigint", _col(0, "date")),
    _call("div", "double", _col(1, "decimal(12,2)"), _col(4, "bigint")),
    _call("gt", "boolean", _col(3, "decimal(36,2)"), _col(2, "decimal(36,4)")),
    _call("le", "boolean", _col(2, "decimal(36,4)"), _col(1, "decimal(12,2)")),
    _call("eq", "boolean", _col(2, "decimal(36,4)"), _col(2, "decimal(36,4)")),
    _call("not_null", "boolean", _col(2, "decimal(36,4)")),
    _call("is_null", "boolean", _col(4, "bigint")),
    _call("mul", "decimal(36,6)", _col(3, "decimal(36,2)"), _lit(3, "decimal(5,4)")),
]


@pytest.mark.parametrize("i", range(len(SLICE4_EXPRS)))
def test_expr_eval_fourth_slice_opcodes_match_plain(i):
    """DATEPART, S2D, S2L/LSCALE/LCMP, NOTNULL and a long output."""
    dev = _cuda()
    page = _minmax_page(1 << 20, 40 + i, dev)
    prog, cols = ExprCompiler.for_page(page).lower(SLICE4_EXPRS[i])
    ins = [(page.blocks[c].data, page.blocks[c].valid) for c in cols]
    got = k1.expr_eval(prog, ins, page.capacity)
    want = k1.expr_eval_plain(prog, ins, page.capacity)
    torch.cuda.synchronize()
    assert torch.equal(got[1], want[1])
    assert torch.equal(got[0][want[1]], want[0][want[1]])  # doubles bit for bit


def _minmax_args(page):
    b = page.blocks
    return [(k2.MIN_SHORT, b[0].data, b[0].valid), (k2.MAX_SHORT, b[0].data, b[0].valid),
            (k2.MIN_SHORT, b[1].data, b[1].valid), (k2.MAX_SHORT, b[1].data, b[1].valid),
            (k2.MIN_LONG, b[2].data, b[2].valid), (k2.MAX_LONG, b[2].data, b[2].valid),
            (k2.COUNT_STAR, None, None)]


@pytest.mark.parametrize("slots", [1, 40, 16384])
def test_packed_group_agg_minmax_matches_plain(slots):
    """min/max states on the global, shared-memory and global-atomics
    paths; some groups see only NULLs."""
    dev = _cuda()
    page = _minmax_page(1 << 20, slots, dev)
    b = page.blocks
    keys = [] if slots == 1 else [(torch.remainder(b[4].data * 977, slots - 1), b[4].valid,
                                   0, slots)]
    args = _minmax_args(page)
    got = k2.packed_group_agg(page.capacity, page.row_mask, keys, args, slots)
    want = k2.packed_group_agg_plain(page.capacity, page.row_mask, keys, args, slots)
    torch.cuda.synchronize()
    assert torch.equal(got[1], want[1])
    for g, w in zip(got[0], want[0]):
        for x, y in zip(g, w):
            assert x.dtype == y.dtype and torch.equal(x, y)
    # fold two partial tables and finalize, every min/max kind
    other = k2.packed_group_agg(page.capacity, ~page.row_mask, keys, args, slots)
    kinds = [k3.COL_MIN_I32, k3.COL_I64, k3.COL_MAX_I32, k3.COL_I64, k3.COL_MIN_I64,
             k3.COL_I64, k3.COL_MAX_I64, k3.COL_I64, k3.COL_MIN_D128, k3.COL_I64,
             k3.COL_MAX_D128, k3.COL_I64, k3.COL_I64]

    def cols(states, present):
        return [(k, t, present) for k, t in zip(kinds, [t for s in states for t in s])]

    a, c = cols(*got), cols(*other)
    fold = k3.packed_fold(a, c, got[1], other[1])
    fold_want = k3.packed_fold_plain(a, c, got[1], other[1])
    torch.cuda.synchronize()
    for x, y in zip(fold[0], fold_want[0]):
        assert torch.equal(x[0], y[0]) and torch.equal(x[1], y[1])
    f = [d for d, _ in fold[0]]
    items = [(k3.FIN_VALUE_I32, f[0], f[1]), (k3.FIN_VALUE_I32, f[2], f[3]),
             (k3.FIN_SUM, f[4], f[5]), (k3.FIN_SUM, f[6], f[7]),
             (k3.FIN_SUM_D128, f[8], f[9]), (k3.FIN_SUM_D128, f[10], f[11])]
    for (gd, gv), (wd, wv) in zip(k3.packed_finalize(items, fold[1]),
                                  k3.packed_finalize_plain(items, fold[1])):
        assert torch.equal(gv, wv) and torch.equal(gd[wv], wd[wv])


@pytest.mark.parametrize("presorted", [False, True])
def test_sorted_group_agg_minmax_matches_plain(presorted):
    """K6's min/max states (sort path and presorted mode, whose keys
    come in runs with dead rows between equal keys)."""
    dev = _cuda()
    page = _minmax_page(1 << 20, 50, dev)
    b = page.blocks
    key = torch.arange(1 << 20, device=dev) // 7 if presorted else \
        torch.remainder(b[1].data, 50000)
    keys = [(key, torch.ones_like(b[4].valid), 0, 0 if presorted else 50001)]
    states = [(k6.S_MIN, b[0].data, b[0].valid), (k6.S_MAX, b[0].data, b[0].valid),
              (k6.S_MIN, b[4].data, b[4].valid), (k6.S_MAX, b[4].data, b[4].valid),
              (k6.S_MIN_LONG, b[2].data, b[2].valid), (k6.S_MAX_LONG, b[2].data, b[2].valid),
              (k6.S_ONE, None, None), (k6.S_SUM, b[4].data, b[4].valid)]
    got = k6.sorted_group_agg(keys, page.row_mask, states, presorted)
    want = k6.sorted_group_agg_plain(keys, page.row_mask, states, presorted)
    torch.cuda.synchronize()
    assert got[2] == want[2] > 1000
    for x, y in zip(got[0] + got[1], want[0] + want[1]):
        if isinstance(x, tuple):
            assert torch.equal(x[0], y[0]) and torch.equal(x[1], y[1])
        else:
            assert x.dtype == y.dtype and torch.equal(x, y)


def test_topn_up_to_100_matches_plain():
    dev = _cuda()
    rng = np.random.default_rng(9)
    n = 1 << 20
    limbs = torch.from_numpy(np.stack([rng.integers(-3, 3, n), rng.integers(0, 4, n)], 1))
    keys = [(limbs.to(dev), torch.from_numpy(rng.random(n) >= 0.01).to(dev), False, True),
            (torch.from_numpy(rng.integers(0, 5, n).astype(np.int32)).to(dev),
             torch.from_numpy(rng.random(n) >= 0.3).to(dev), True, False)]
    mask = torch.from_numpy(rng.random(n) >= 0.2).to(dev)
    for k in (33, 64, 100):
        got = k7.topn(keys, mask, k)
        want = k7.topn_plain(keys, mask, k)
        torch.cuda.synchronize()
        assert torch.equal(got[1], want[1]) and torch.equal(got[0], want[0])
    few = torch.zeros_like(mask)
    few[::50000] = True  # fewer live rows than n
    got, want = k7.topn(keys, few, 100), k7.topn_plain(keys, few, 100)
    assert torch.equal(got[1], want[1]) and torch.equal(got[0], want[0])


def test_aggregation_slice_on_the_card_equals_the_cpu_run():
    """TPC-H Q2, Q7, Q8, Q9, Q11, Q15, Q17, Q18, Q21 and Q22 at sf 0.01
    on the card, with K1's new opcodes, the min/max states, K6's
    presorted mode and K7 at n = 100 launched."""
    _cuda()
    from presto_tpu_torch.testing import LocalQueryRunner

    gpu = LocalQueryRunner(sf=0.01, device="cuda")
    cpu = LocalQueryRunner(sf=0.01, device="cpu")
    k1.op_launches.clear()
    for mod in (k2, k6):
        mod.minmax_launches = 0
    k6.presorted_launches = k7.wide_launches = 0
    for q in (2, 7, 8, 9, 11, 15, 17, 18, 21, 22):
        assert gpu.execute(QUERIES[q]).rows == cpu.execute(QUERIES[q]).rows
    # Q17's 7.0 folds to a double constant (DLIT) on the host
    assert set(k1.op_launches) == {"year", "s2d", "lcmp", "not_null", "dlit"}
    assert k2.minmax_launches > 0 and k6.minmax_launches > 0
    assert k6.presorted_launches > 0 and k7.wide_launches > 0


# -- the fifth slice: double lanes, the double avg, double keys, K10 ------------

def _double_page(n: int, seed: int, device) -> Page:
    """Doubles with zeros of both signs, NaN and ties; a short and a
    long decimal; int32 and int64 lanes holding their least values."""
    rng = np.random.default_rng(seed)
    x = rng.normal(0.0, 50.0, n)
    for v, rate in ((0.0, 0.05), (-0.0, 0.05), (np.nan, 0.03), (1.25, 0.2)):
        x[rng.random(n) < rate] = v
    i32 = rng.integers(-1000, 1000, n).astype(np.int32)
    i32[rng.random(n) < 0.02] = np.iinfo(np.int32).min
    i64 = rng.integers(-10 ** 12, 10 ** 12, n)
    i64[rng.random(n) < 0.02] = np.iinfo(np.int64).min
    cols = [(x, "double"), (rng.normal(0.0, 50.0, n), "double"),
            (rng.integers(-10 ** 6, 10 ** 6, n), "decimal(12,2)"),
            (np.stack([rng.integers(-3, 3, n), rng.integers(0, 10 ** 18, n)], 1),
             "decimal(36,4)"), (i64, "bigint"), (i32, "integer"),
            (rng.integers(0, 5000, n), "bigint")]
    blocks = [Block(torch.from_numpy(d).to(device),
                    torch.from_numpy(rng.random(n) >= 0.1).to(device), parse_type(t))
              for d, t in cols]
    return Page(tuple(blocks), torch.from_numpy(rng.random(n) >= 0.1).to(device))


DOUBLE_EXPRS = [
    _call("add", "double", _col(0, "double"), _col(1, "double")),
    _call("sub", "double", _col(2, "decimal(12,2)"), _col(0, "double")),
    _call("mul", "double", _col(5, "integer"), _col(1, "double")),
    _call("div", "double", _col(3, "decimal(36,4)"), _col(0, "double")),
    _call("neg", "double", _col(0, "double")),
    _call("abs", "double", _call("sub", "double", _col(2, "decimal(12,2)"), _col(0, "double"))),
    _call("abs", "integer", _col(5, "integer")),
    _call("neg", "bigint", _col(4, "bigint")),
    _call("mul", "double", _col(0, "double"), _lit(0.1, "double")),
    _call("lt", "boolean", _col(0, "double"), _col(1, "double")),
    _call("ge", "boolean", _col(2, "decimal(12,2)"), _col(0, "double")),
    _call("eq", "boolean", _col(3, "decimal(36,4)"), _col(0, "double")),
    _call("case", "double", _call("gt", "boolean", _col(1, "double"), _lit(0, "integer")),
          _call("div", "double", _col(0, "double"), _col(1, "double")), _lit(None, "double")),
]


@pytest.mark.parametrize("i", range(len(DOUBLE_EXPRS)))
def test_expr_eval_double_opcodes_match_plain(i):
    """LOAD_F64, DLIT, DADD/DSUB/DMUL, DNEG/DABS, DCMP, NEG/ABS and CASE
    producing a double, bit for bit."""
    dev = _cuda()
    page = _double_page(1 << 20, 60 + i, dev)
    prog, cols = ExprCompiler.for_page(page).lower(DOUBLE_EXPRS[i])
    ins = [(page.blocks[c].data, page.blocks[c].valid) for c in cols]
    got = k1.expr_eval(prog, ins, page.capacity)
    want = k1.expr_eval_plain(prog, ins, page.capacity)
    torch.cuda.synchronize()
    assert torch.equal(got[1], want[1])
    g, w = got[0][want[1]], want[0][want[1]]
    if w.dtype == torch.float64:
        g, w = g.view(torch.int64), w.view(torch.int64)
    assert torch.equal(g, w)


def test_packed_finalize_avg_double_matches_plain():
    dev = _cuda()
    rng = np.random.default_rng(70)
    g = 1 << 16
    s = torch.from_numpy(rng.integers(-10 ** 15, 10 ** 15, g)).to(dev)
    cnt = torch.from_numpy(rng.integers(0, 10 ** 6, g)).to(dev)
    mask = torch.from_numpy(rng.random(g) >= 0.1).to(dev)
    items = [(k3.FIN_AVG_DOUBLE, s, cnt), (k3.FIN_COUNT, cnt, cnt)]
    got, want = k3.packed_finalize(items, mask), k3.packed_finalize_plain(items, mask)
    torch.cuda.synchronize()
    for (gd, gv), (wd, wv) in zip(got, want):
        assert torch.equal(gv, wv)
        assert torch.equal(gd[wv].view(torch.int64), wd[wv].view(torch.int64))


def test_topn_double_keys_match_plain():
    """-0.0 ties 0.0, NaN last either way, ties by position."""
    dev = _cuda()
    page = _double_page(1 << 20, 71, dev)
    b = page.blocks
    for asc in (True, False):
        keys = [(b[0].data, b[0].valid, asc, not asc), (b[6].data, b[6].valid, True, False)]
        for n in (10, 100):
            got, want = k7.topn(keys, page.row_mask, n), k7.topn_plain(keys, page.row_mask, n)
            torch.cuda.synchronize()
            assert torch.equal(got[1], want[1]) and torch.equal(got[0], want[0])


WINDOW_FUNCS = (
    [k10.Func(k) for k in (k10.ROW_NUMBER, k10.RANK, k10.DENSE_RANK, k10.PERCENT_RANK,
                           k10.CUME_DIST)]
    + [k10.Func(k10.NTILE, offset=5)]
    + [k10.Func(k, offset=o, ignore_nulls=ign) for k in (k10.LEAD, k10.LAG) for o in (0, 2)
       for ign in (False, True)]
    + [k10.Func(k, fr, st, en, offset=2, ignore_nulls=ign)
       for k in (k10.FIRST_VALUE, k10.LAST_VALUE, k10.NTH_VALUE)
       for fr, st, en in ((k10.FRAME_PEERS, None, None), (k10.FRAME_ROWS, -3, 1))
       for ign in (False, True)]
    + [k10.Func(k, fr, st, en, scale=sc)
       for k, sc in ((k10.COUNT, None), (k10.COUNT_STAR, None), (k10.SUM, None),
                     (k10.AVG, 2))
       for fr, st, en in ((k10.FRAME_PEERS, None, None), (k10.FRAME_WHOLE, None, None),
                          (k10.FRAME_ROWS, None, 0), (k10.FRAME_ROWS, -5, 2),
                          (k10.FRAME_ROWS, 2, 1))]
    + [k10.Func(k, fr, None, en) for k in (k10.MIN, k10.MAX)
       for fr, en in ((k10.FRAME_PEERS, None), (k10.FRAME_ROWS, 0), (k10.FRAME_ROWS, -1))]
)


def _window_case(n, seed, dev, parts):
    page = _double_page(n, seed, dev)
    b = page.blocks
    perm = torch.argsort(torch.remainder(b[6].data, parts), stable=True)
    perm = perm[torch.argsort((~page.row_mask)[perm].to(torch.int32), stable=True)]
    pkey = torch.remainder(b[6].data, parts)
    order = [(b[5].data, b[5].valid), (b[0].data, b[0].valid)]
    return page, perm, pkey, order


@pytest.mark.parametrize("arg", [0, 2, 5])
@pytest.mark.parametrize("n,parts", [(1, 1), (17, 3), (1 << 20, 977), (1 << 20, 1)])
def test_window_eval_kernel_matches_plain(n, parts, arg):
    """Every kind and frame over a double, a short decimal and an int32
    argument; one row, a few rows, many partitions and one partition
    of 2^20 rows (the double sums' three levels of runs)."""
    dev = _cuda()
    page, perm, pkey, order = _window_case(n, 72 + arg, dev, parts)
    a = (page.blocks[arg].data, page.blocks[arg].valid)
    funcs = list(WINDOW_FUNCS)
    args = [None if f.kind in k10._RANKS or f.kind == k10.COUNT_STAR else a for f in funcs]
    got = k10.window_eval(perm, page.row_mask, pkey, order, funcs, args)
    want = k10.window_eval_plain(perm, page.row_mask, pkey, order, funcs, args)
    torch.cuda.synchronize()
    for f, (gd, gv), (wd, wv) in zip(funcs, got, want):
        assert torch.equal(gv, wv), f
        g, w = gd[wv], wd[wv]
        if w.dtype == torch.float64:
            g, w = g.view(torch.int64), w.view(torch.int64)
        assert torch.equal(g, w), f


def test_tpcds_slice_on_the_card_equals_the_cpu_run():
    """The fifth slice's TPC-DS queries at sf 0.01 on the card, with K10,
    K1's double opcodes, K3's double avg and K7's double keys launched."""
    _cuda()
    from presto_tpu_torch.runner import QueryRunner
    from presto_tpu_torch.testing import tpcds_catalog
    from tpcds_queries import QUERIES as DS

    args = dict(sf=0.01, split_rows=16384, cd_rows=2 * 5 * 7 * 20, inv_rows=60000)
    gpu = QueryRunner(tpcds_catalog(**args), device="cuda")
    cpu = QueryRunner(tpcds_catalog(**args), device="cpu")
    k1.op_launches.clear()
    k10.launches = k3.double_avg_launches = k7.double_launches = 0
    for q in (3, 7, 12, 20, 98, 53, 63, 89, 44, 47, 57, 51, 13):
        got, want = gpu.execute(DS[q]).rows, cpu.execute(DS[q]).rows
        assert got == want, q
    assert k10.launches > 0 and k3.double_avg_launches > 0 and k7.double_launches > 0
    assert {"load_f64", "dcmp", "dsub", "dabs"} <= set(k1.op_launches)


# -- the sixth slice: coalesce, floor/round/cast_decimal, string CASE and
# column comparisons, long add/sub; double sums and variance in K2/K6/K3;
# sum0 and collapsed sums; hashed double keys --------------------------------

WORDS_A = ["red", "green", "blue", "grey", "red", "cyan"]
WORDS_B = ["blue", "pink", "red", "white", "black"]


def _slice6_page(n: int, seed: int, device) -> Page:
    """Doubles on exact halves and normal ones, a short decimal with
    ties, two long decimals, int32/int64 lanes, two dictionary strings
    (one repeating a value) and a group key."""
    rng = np.random.default_rng(seed)
    q = rng.integers(-10 ** 6, 10 ** 6, n)
    tie = rng.random(n) < 0.3
    q[tie] = rng.integers(-1000, 1000, tie.sum()) * 100 + 50
    cols = [(rng.integers(-4000, 4000, n) / 8.0, "double", None),
            (rng.normal(0.0, 50.0, n), "double", None),
            (q, "decimal(12,2)", None),
            (np.stack([rng.integers(-3, 3, n), rng.integers(0, 10 ** 18, n)], 1),
             "decimal(36,4)", None),
            (np.stack([rng.integers(-3, 3, n), rng.integers(0, 10 ** 18, n)], 1),
             "decimal(36,4)", None),
            (rng.integers(-1000, 1000, n).astype(np.int32), "integer", None),
            (rng.integers(-10 ** 12, 10 ** 12, n), "bigint", None),
            (rng.integers(0, len(WORDS_A), n).astype(np.int32), "varchar", Dictionary(WORDS_A)),
            (rng.integers(0, len(WORDS_B), n).astype(np.int32), "varchar", Dictionary(WORDS_B)),
            (rng.integers(0, 5000, n), "bigint", None),
            (rng.integers(-10 ** 15, 10 ** 15, n), "decimal(18,2)", None)]
    blocks = [Block(torch.from_numpy(d).to(device),
                    torch.from_numpy(rng.random(n) >= 0.1).to(device), parse_type(t), dic)
              for d, t, dic in cols]
    return Page(tuple(blocks), torch.from_numpy(rng.random(n) >= 0.1).to(device))


_POS = _call("gt", "boolean", _col(5, "integer"), _lit(0, "integer"))
SLICE6_EXPRS = [
    _call("coalesce", "bigint", _col(5, "integer"), _col(6, "bigint")),
    _call("coalesce", "double", _col(2, "decimal(12,2)"), _col(0, "double"), _lit(1.5, "double")),
    _call("coalesce", "decimal(36,4)", _col(3, "decimal(36,4)"), _col(2, "decimal(12,2)")),
    _call("floor", "decimal(12,0)", _col(2, "decimal(12,2)")),
    _call("ceil", "decimal(12,0)", _col(2, "decimal(12,2)")),
    _call("floor", "double", _col(1, "double")),
    _call("ceil", "double", _col(1, "double")),
    _call("round", "decimal(12,0)", _col(2, "decimal(12,2)")),
    _call("round", "decimal(12,2)", _col(2, "decimal(12,2)"), _lit(1, "integer")),
    _call("round", "double", _col(0, "double")),
    _call("round", "double", _col(1, "double"), _lit(2, "integer")),
    _call("cast_decimal", "decimal(12,2)", _call("div", "double", _col(0, "double"),
                                                 _lit(8.0, "double"))),
    _call("cast_decimal", "decimal(36,4)", _call("mul", "double", _col(1, "double"),
                                                 _lit(1e6, "double"))),
    _call("cast_decimal", "decimal(12,1)", _col(2, "decimal(12,2)")),
    _call("add", "decimal(36,4)", _col(3, "decimal(36,4)"), _col(4, "decimal(36,4)")),
    _call("sub", "decimal(36,4)", _col(3, "decimal(36,4)"), _col(2, "decimal(12,2)")),
    _call("case", "varchar", _POS, _col(7, "varchar"), _col(8, "varchar")),
    _call("if", "varchar", _POS, _col(7, "varchar"), _lit("none", "varchar")),
    _call("coalesce", "varchar", _col(7, "varchar"), _col(8, "varchar"), _lit("?", "varchar")),
    _call("eq", "boolean", _col(7, "varchar"), _col(8, "varchar")),
    _call("ne", "boolean", _col(8, "varchar"), _col(7, "varchar")),
]


def _same_lanes(got, want):
    assert torch.equal(got[1], want[1])
    g, w = got[0][want[1]], want[0][want[1]]
    if w.dtype == torch.float64:
        g, w = g.view(torch.int64), w.view(torch.int64)
    assert g.dtype == w.dtype and torch.equal(g, w)


@pytest.mark.parametrize("i", range(len(SLICE6_EXPRS)))
def test_expr_eval_sixth_slice_opcodes_match_plain(i):
    """COAL, SFLOOR, SROUND, DFLOOR, DROUND, D2S, D2L, LADD, the remap
    and value-id tables (CANON), bit for bit; with ties on both sides
    of zero for the roundings."""
    dev = _cuda()
    page = _slice6_page(1 << 20, 90 + i, dev)
    prog, cols = ExprCompiler.for_page(page).lower(SLICE6_EXPRS[i])
    ins = [(page.blocks[c].data, page.blocks[c].valid) for c in cols]
    got = k1.expr_eval(prog, ins, page.capacity)
    want = k1.expr_eval_plain(prog, ins, page.capacity)
    torch.cuda.synchronize()
    _same_lanes(got, want)


def _slice6_args(page):
    b = page.blocks
    return [(k2.SUM_DOUBLE, b[1].data, b[1].valid), (k2.VARIANCE, b[0].data, b[0].valid),
            (k2.VARIANCE, b[1].data, b[1].valid), (k2.SUM_LONG_ARG, b[3].data, b[3].valid),
            (k2.SUM_SHORT, b[6].data, b[6].valid), (k2.COUNT_STAR, None, None)]


def test_packed_group_agg_double_states_match_plain():
    """K2's double sum and variance states of the global aggregate (its
    one slot; fixed order: chunks of 256 rows, then pairwise) and a
    long-argument sum, bit for bit; then K3's fold (double add, Chan's
    m2) and every new finalize kind."""
    dev = _cuda()
    slots = 1
    page = _slice6_page(1 << 20, 120 + slots, dev)
    keys = []
    args = _slice6_args(page)
    got = k2.packed_group_agg(page.capacity, page.row_mask, keys, args, slots)
    want = k2.packed_group_agg_plain(page.capacity, page.row_mask, keys, args, slots)
    other = k2.packed_group_agg(page.capacity, ~page.row_mask, keys, args, slots)
    torch.cuda.synchronize()
    assert torch.equal(got[1], want[1])
    for g, w in zip(got[0], want[0]):
        for x, y in zip(g, w):
            assert x.dtype == y.dtype and torch.equal(x.view(torch.int64) if x.is_floating_point()
                                                      else x, y.view(torch.int64)
                                                      if y.is_floating_point() else y)
    kinds = [k3.COL_F64, k3.COL_I64, k3.COL_F64, k3.COL_VAR_M2, k3.COL_I64, k3.COL_F64,
             k3.COL_VAR_M2, k3.COL_I64, k3.COL_D128, k3.COL_I64, k3.COL_I64, k3.COL_I64,
             k3.COL_I64]

    def cols(states, present):
        return [(k, t, present) for k, t in zip(kinds, [t for s in states for t in s])]

    a, c = cols(*got), cols(*other)
    fold = k3.packed_fold(a, c, got[1], other[1])
    fold_want = k3.packed_fold_plain(a, c, got[1], other[1])
    torch.cuda.synchronize()
    for x, y in zip(fold[0], fold_want[0]):
        assert torch.equal(x[1], y[1])
        assert torch.equal(x[0].view(torch.int64) if x[0].is_floating_point() else x[0],
                           y[0].view(torch.int64) if y[0].is_floating_point() else y[0])
    f = [d for d, _ in fold[0]]
    items = [(k3.FIN_SUM_F64, f[0], f[1]), (k3.FIN_AVG_F64, f[0], f[1]),
             (k3.FIN_VAR_POP, f[3], f[4]), (k3.FIN_VAR_SAMP, f[3], f[4]),
             (k3.FIN_STDDEV_POP, f[6], f[7]), (k3.FIN_STDDEV_SAMP, f[6], f[7]),
             (k3.FIN_SUM0_D128, f[8], f[9]), (k3.FIN_SUM_COLLAPSE, f[8], f[9]),
             (k3.FIN_SUM0_COLLAPSE, f[8], f[9]), (k3.FIN_SUM0, f[10], f[11])]
    for got_f, want_f in zip(k3.packed_finalize(items, fold[1]),
                             k3.packed_finalize_plain(items, fold[1])):
        _same_lanes(got_f, want_f)


@pytest.mark.parametrize("presorted", [False, True])
def test_sorted_group_agg_double_states_match_plain(presorted):
    """K6's double sum, variance partial and variance merge (runs of up
    to ~2,000 rows, so groups span several chunks), bit for bit."""
    dev = _cuda()
    page = _slice6_page(1 << 20, 140 + presorted, dev)
    b = page.blocks
    key = torch.arange(1 << 20, device=dev) // 2000 if presorted else \
        torch.remainder(b[9].data, 500)
    keys = [(key, torch.ones_like(b[9].valid), 0, 0 if presorted else 501)]
    states = [(k6.S_DSUM, b[1].data, b[1].valid), (k6.S_VALID, None, b[1].valid),
              (k6.S_VAR, b[0].data, b[0].valid), (k6.S_VAR, b[1].data, b[1].valid),
              (k6.S_LIMBS_LONG, b[3].data, b[3].valid), (k6.S_ONE, None, None)]
    got = k6.sorted_group_agg(keys, page.row_mask, states, presorted)
    want = k6.sorted_group_agg_plain(keys, page.row_mask, states, presorted)
    torch.cuda.synchronize()
    assert got[2] == want[2] > 100

    def bits(t):
        return t.view(torch.int64) if t.is_floating_point() else t

    for x, y in zip(got[1], want[1]):
        assert x.dtype == y.dtype and torch.equal(bits(x), bits(y))
    # merge the variance partials (s, m2, cnt) of two halves of the rows
    half = torch.arange(1 << 20, device=dev) < (1 << 19)
    parts = [k6.sorted_group_agg_plain(keys, page.row_mask & h, states[2:3], presorted)
             for h in (half, ~half)]
    mkey = torch.cat([p[0][0][0] for p in parts])
    mkeys = [(mkey, torch.ones_like(mkey, dtype=torch.bool), 0, 0 if presorted else 501)]
    live = torch.ones(mkey.shape[0], dtype=torch.bool, device=dev)
    cols = tuple(torch.cat([p[1][j] for p in parts]) for j in range(3))
    merge = [(k6.S_VAR_MERGE, cols, live)]
    got = k6.sorted_group_agg(mkeys, live, merge)
    want = k6.sorted_group_agg_plain(mkeys, live, merge)
    torch.cuda.synchronize()
    assert got[2] == want[2]
    for x, y in zip(got[1], want[1]):
        assert torch.equal(bits(x), bits(y))


def test_hash_keys_double_match_plain():
    """A double key hashes its value truncated to int64 (K9)."""
    dev = _cuda()
    page = _slice6_page(1 << 20, 150, dev)
    b = page.blocks
    keys = [(b[1].data, b[1].valid, 0, 0), (b[9].data, b[9].valid, 0, 0)]
    got = pk.hash_keys(keys, page.row_mask)
    want = pk.masked_plain(keys, page.row_mask, False)[0]
    torch.cuda.synchronize()
    assert torch.equal(got, want)


SLICE6_DS = (2, 4, 11, 33, 49, 54, 56, 60, 66, 71, 74, 75, 76, 5, 14, 18, 22, 27, 67, 77,
             80, 6, 8, 19, 46, 68, 36, 70, 86, 16, 28, 95, 17, 39, 40, 78, 23)


def test_sixth_slice_on_the_card_equals_the_cpu_run():
    """The sixth slice's 37 TPC-DS queries at sf 0.01 on the card, equal
    to the CPU run (doubles bit for bit), with the new kinds launched."""
    _cuda()
    from presto_tpu_torch.runner import QueryRunner
    from presto_tpu_torch.testing import tpcds_catalog
    from tpcds_queries import QUERIES as DS

    args = dict(sf=0.01, split_rows=16384, cd_rows=2 * 5 * 7 * 20, inv_rows=60000)
    gpu = QueryRunner(tpcds_catalog(**args), device="cuda")
    cpu = QueryRunner(tpcds_catalog(**args), device="cpu")
    k1.op_launches.clear()
    k6.variance_launches = k6.variance_merge_launches = k3.sum0_launches = 0
    for q in SLICE6_DS:
        got, want = gpu.execute(DS[q]).rows, cpu.execute(DS[q]).rows
        assert got == want, q
    assert k6.variance_launches > 0 and k3.sum0_launches > 0
    # cast_decimal is absent: these queries cast only literals, folded on the host
    assert {"coalesce", "remap", "string_eq", "floor", "round", "ladd"} <= set(k1.op_launches)


@pytest.mark.parametrize("kind", ["inner", "full"])
def test_join_kernels_gather_past_64_columns(kind):
    """K8 and K5 gather a join of more than 64 columns in runs of 64,
    one launch (and one count) per run (TPC-DS joins over every column
    of their tables do)."""
    dev = _cuda()
    domain = 1 << 12
    bcol, bmask = _skewed_build(dev, domain=domain)
    bkeys = _keys_for(bcol, "search", domain)
    sk, perm, starts, _ = k4.join_build_sorted(bkeys, bmask, None)
    pcol, pmask = _probe_keys(dev, 1 << 14, domain, 12)
    pkeys = _keys_for(pcol, "search", domain)
    rng = np.random.default_rng(31)
    probe_cols = [pcol] + [(torch.from_numpy(rng.integers(0, 9, 1 << 14)).to(dev), pmask)
                           for _ in range(40)]
    build_cols = [bcol] + [(torch.from_numpy(rng.integers(0, 9, 1 << 16).astype(np.int32))
                            .to(dev), bmask) for _ in range(60)]
    wide_build = build_cols + build_cols[1:11]  # 71 columns: two runs of K5
    k8.launches = k5.launches = 0
    outs = []
    for fn in (k8.join_expand, k8.join_expand_plain):
        matched = torch.zeros(1 << 16, dtype=torch.bool, device=dev) if kind == "full" else None
        outs.append(fn(pkeys, pmask, sk, perm, starts, probe_cols, build_cols,
                       kind != "inner", False, matched) + (matched,))
    got = k5.join_probe(pkeys, pmask, sk, perm, starts, wide_build, k5.LEFT)
    want = k5.join_probe_plain(pkeys, pmask, sk, perm, starts, wide_build, k5.LEFT)
    torch.cuda.synchronize()
    assert k8.launches == 2 and k5.launches == 2  # 102 output columns; 71 build columns
    (gp, gb, gt, gm), (wp, wb, wt, wm) = outs
    assert gt == wt > 0
    for (gd, gv), (wd, wv) in zip(gp + gb, wp + wb):
        assert torch.equal(gd, wd) and torch.equal(gv, wv)
    assert (gm is None and wm is None) or torch.equal(gm, wm)
    assert torch.equal(got[1], want[1])
    for (gd, gv), (wd, wv) in zip(got[0], want[0]):
        assert torch.equal(gd, wd) and torch.equal(gv, wv)


# -- the seventh slice: K11 spill_partition, K4's null_flags, spill ---------

@pytest.mark.parametrize("num_buckets", [1, 13, 64, 256])
@pytest.mark.parametrize("hashed", [False, True])
def test_spill_partition_kernel_matches_plain(hashed, num_buckets):
    """K11's bucket ids, permutation (each bucket in row order) and
    counts equal the twin's, with NULL keys and dead rows; then its
    gather equals the plain gather."""
    from presto_tpu_torch.kernels import spill_partition as k11

    dev = _cuda()
    page = _page((1 << 20) + 77, 171, dev)
    b = page.blocks
    if hashed:
        keys = [(b[2].data, b[2].valid, 0, 0), (b[4].data, b[4].valid, 0, 0)]
    else:
        keys = [(b[4].data, b[4].valid, 8000, 3002)]  # dates in [8000, 11000)
    got = k11.spill_partition(keys, page.row_mask, num_buckets)
    want = k11.spill_partition_plain(keys, page.row_mask, num_buckets)
    torch.cuda.synchronize()
    total = int(want[2].sum())
    assert torch.equal(got[0], want[0]) and torch.equal(got[2], want[2])
    assert torch.equal(got[1][:total], want[1][:total])
    cols = [(x.data, x.valid) for x in b]
    assert torch.equal(k11.gather_columns(cols, got[1], total),
                       k11.gather_columns_plain(cols, want[1], total))


def test_null_flags_kernel_matches_plain():
    dev = _cuda()
    page = _page((1 << 20) + 5, 172, dev)
    valids = [page.blocks[2].valid, page.blocks[3].valid]
    all_ok = torch.ones_like(valids[0])
    dead = torch.zeros_like(page.row_mask)
    for vs, mask in ((valids, page.row_mask), ([all_ok], page.row_mask), (valids, dead)):
        got = k4.null_flags(vs, mask)
        want = k4.null_flags_plain(vs, mask)
        torch.cuda.synchronize()
        assert torch.equal(got, want)


def test_spilled_queries_on_the_card_equal_the_cpu_run():
    """The reference's spill queries (tests/test_spill.py) at sf 0.004
    on the card under a pool at 0.6x their spill site, equal to the
    unconstrained CPU run, with K11 launched."""
    _cuda()
    from presto_tpu_torch.exec.local import LocalRunner
    from presto_tpu_torch.kernels import spill_partition as k11
    from presto_tpu_torch.memory import MemoryPool
    from presto_tpu_torch.sql.binder import Binder
    from presto_tpu_torch.testing import tpch_catalog

    class PeekPool(MemoryPool):
        def __init__(self, limit):
            super().__init__(limit)
            self.peek = {}

        def reserve(self, tag, nbytes, enforce=True):
            self.peek[tag] = nbytes
            super().reserve(tag, nbytes, enforce=enforce)

    catalog = tpch_catalog(sf=0.004, split_rows=1 << 12)
    for sql, site in ((SPILL_SQL["AGG_SQL"], "agg_accumulator@"),
                      (SPILL_SQL["JOIN_SQL"], "join_build@"),
                      (SPILL_SQL["FULL_SQL"], "join_build@")):
        want = LocalRunner(catalog, device="cpu").run(Binder(catalog).plan(sql)).rows
        peek = PeekPool(1 << 40)
        LocalRunner(catalog, device="cuda", memory_pool=peek).run(Binder(catalog).plan(sql))
        limit = int(0.6 * max(n for t, n in peek.peek.items() if site in t))
        k11.launches = 0
        runner = LocalRunner(catalog, device="cuda", memory_pool=MemoryPool(limit))
        got = runner.run(Binder(catalog).plan(sql)).rows
        assert sorted(got, key=repr) == sorted(want, key=repr)
        assert k11.launches > 0 and runner.last_spill.bytes > 0


def _spill_sql():
    """AGG_SQL, JOIN_SQL and FULL_SQL of tests/test_spill.py, read
    without importing it (it imports the reference package)."""
    import ast
    import pathlib

    tree = ast.parse((pathlib.Path(__file__).parent / "test_spill.py").read_text())
    return {t.id: ast.literal_eval(node.value) for node in tree.body
            if isinstance(node, ast.Assign) for t in node.targets
            if isinstance(t, ast.Name) and t.id.endswith("_SQL")}


SPILL_SQL = _spill_sql()


# -- the eighth slice: the function surface --------------------------------

def _slice8_page(n: int, seed: int, device) -> Page:
    """Doubles with NaN, infinities, signed zeros and halves; int64 edges
    and shift counts past 63; decimals with .50 ties; dates before 1970;
    long decimals; a dictionary varchar whose dictionary repeats a
    value; booleans; a small key."""
    rng = np.random.default_rng(seed)
    edges = np.array([0.0, -0.0, np.nan, np.inf, -np.inf, 2.5, -2.5, 1e300, -1e-310, 0.5])
    x = rng.normal(size=n) * 10.0 ** rng.uniform(-3, 6, n)
    pick = rng.random(n) < 0.05
    x[pick] = rng.choice(edges, pick.sum())
    y = rng.uniform(1e-3, 1e6, n)
    a = rng.integers(-10 ** 12, 10 ** 12, n)
    pick = rng.random(n) < 0.2
    a[pick] = rng.choice(EDGES, pick.sum())
    b = rng.integers(-5, 80, n)
    d = rng.integers(-10 ** 6, 10 ** 6, n)
    d[rng.random(n) < 0.2] = 250
    dt = rng.integers(-800, 20000, n).astype(np.int32)
    limbs = np.stack([rng.integers(-10 ** 3, 10 ** 3, n), rng.integers(0, 10 ** 18, n)], 1)
    words = [f"w{i % 37:02d}" for i in range(50)]
    s = rng.integers(0, len(words), n).astype(np.int32)
    f = rng.random(n) < 0.5
    k = rng.integers(0, 40, n)
    cols = [(x, "double"), (y, "double"), (a, "bigint"), (b, "bigint"), (d, "decimal(12,2)"),
            (dt, "date"), (limbs, "decimal(36,4)"), (s, "varchar"), (f, "boolean"),
            (k, "bigint")]
    blocks = [Block(torch.from_numpy(v).to(device),
                    torch.from_numpy(rng.random(n) >= 0.1).to(device), parse_type(t),
                    Dictionary(words) if t == "varchar" else None) for v, t in cols]
    return Page(tuple(blocks), torch.from_numpy(rng.random(n) >= 0.1).to(device))


_X, _Y, _A, _B = _col(0, "double"), _col(1, "double"), _col(2, "bigint"), _col(3, "bigint")
_D, _DT, _L, _S = _col(4, "decimal(12,2)"), _col(5, "date"), _col(6, "decimal(36,4)"), \
    _col(7, "varchar")
# (expression, transcendental): the families of K1's new opcodes
SLICE8_EXPRS = (
    [(_call(fn, "double", _X if fn not in ("ln", "log2", "log10", "sqrt") else _Y),
      k1.DUN_FNS.index(fn) in k1.TRANSCENDENTAL)
     for fn in k1.DUN_FNS if fn not in ("sign", "is_nan", "is_finite", "is_infinite")]
    + [(_call(fn, "bigint" if fn == "sign" else "boolean", _X), False)
       for fn in ("sign", "is_nan", "is_finite", "is_infinite")]
    + [(_call("sign", "bigint", _D), False),
       (_call("power", "double", _Y, _call("div", "double", _X, _lit(1000.0, "double"))), True),
       (_call("atan2", "double", _X, _Y), True),
       (_call("mod", "double", _X, _Y), False),
       (_call("mod", "double", _X, _lit(0.0, "double")), False)]
    + [(_call(fn, "bigint", _A, _B), False) for fn in ("bitwise_and", "bitwise_or",
                                                       "bitwise_xor")]
    + [(_call("bitwise_not", "bigint", _A), False)]
    + [(_call(fn, "bigint", _A, _B, _lit(bits, "integer")), False)
       for fn in ("bitwise_shift_left", "bitwise_shift_right") for bits in (64, 8)]
    + [(_call("bit_count", "bigint", _A, _lit(bits, "integer")), False) for bits in (64, 8)]
    + [(_call("greatest", "bigint", _A, _B), False),
       (_call("least", "decimal(12,2)", _D, _lit(250, "decimal(12,2)")), False),
       (_call("greatest", "double", _X, _Y, _lit(-0.0, "double")), False),
       (_call("least", "double", _X, _lit(0.0, "double")), False),
       (_call("greatest", "decimal(36,4)", _L, _D), False),
       (_call("nullif", "bigint", _A, _B), False),
       (_call("nullif", "double", _X, _lit(2.5, "double")), False),
       (_call("nullif", "decimal(12,2)", _D, _lit(250, "decimal(12,2)")), False),
       (_call("cast_bigint", "bigint", _X), False),
       (_call("cast_bigint", "bigint", _D), False),
       (_call("cast_bigint", "bigint", _L), False)]
    + [(_call(fn, "bigint", c), False) for fn in ("hll_bucket", "hll_rho")
       for c in (_A, _X, _S, _DT)]
    + [(_call("width_bucket", "bigint", _X, _lit(0.0, "double"), _lit(1000.0, "double"),
              _lit(10, "bigint")), False),
       (_call("mod", "bigint", _A, _B), False), (_call("div", "bigint", _A, _B), False),
       (_call("mod", "decimal(12,2)", _D, _lit(700, "decimal(12,2)")), False)]
    + [(_call(fn, "date" if fn == "last_day_of_month" else "bigint", _DT), False)
       for fn in ("day_of_week", "day_of_year", "week", "year_of_week", "last_day_of_month")]
)


def ulp_gap(got: torch.Tensor, want: torch.Tensor) -> int:
    """The largest distance in units in the last place between two
    double tensors (NaN against NaN: 0; -0.0 and 0.0: 1)."""
    both_nan = torch.isnan(got) & torch.isnan(want)
    gap = (k1.double_key(got) - k1.double_key(want)).abs()
    return int(torch.where(both_nan, torch.zeros_like(gap), gap).max()) if gap.numel() else 0


@pytest.mark.parametrize("i", range(len(SLICE8_EXPRS)))
def test_expr_eval_eighth_slice_opcodes_match_plain(i):
    """DUN, DBIN, BITW, GL, NULLIF, CASTBI, HLL, WBUCKET, IMOD and the
    new date parts against the twin on the card: exact, but within 2
    ulp where libdevice's transcendental and torch's may round apart."""
    dev = _cuda()
    page = _slice8_page(1 << 20, 200 + i, dev)
    expr, transcendental = SLICE8_EXPRS[i]
    prog, cols = ExprCompiler.for_page(page).lower(expr)
    ins = [(page.blocks[c].data, page.blocks[c].valid) for c in cols]
    got = k1.expr_eval(prog, ins, page.capacity)
    want = k1.expr_eval_plain(prog, ins, page.capacity)
    torch.cuda.synchronize()
    if not transcendental:
        _same_lanes(got, want)
        return
    assert torch.equal(got[1], want[1])
    assert ulp_gap(got[0][want[1]], want[0][want[1]]) <= 2


def _slice8_states(page):
    b = page.blocks
    rho = torch.remainder(b[2].data, 30) + 1
    return [(k2.MIN_DOUBLE, b[0].data, b[0].valid), (k2.MAX_DOUBLE, b[0].data, b[0].valid),
            (k2.BOOL_COUNT, b[8].data, b[8].valid), (k2.BIT_AND, b[2].data, b[2].valid),
            (k2.BIT_OR, b[3].data, b[3].valid), (k2.MIN_SHORT, b[8].data, b[8].valid),
            (k2.MAX_SHORT, b[8].data, b[8].valid), (k2.MAX_SHORT, b[7].data, b[7].valid),
            (k2.HLL_SUM, rho, b[2].valid), (k2.COUNT, b[8].data, b[8].valid)]


def _bits(t):
    return t.view(torch.int64) if t.is_floating_point() else t


@pytest.mark.parametrize("slots", [1, 41])
def test_packed_group_agg_function_states_match_plain(slots):
    """K2's double, boolean and varchar-rank min/max, bool counts,
    bitwise folds and (global) HLL sum, bit for bit; then K3's fold of
    two such tables and its finalizes (the HLL estimate included)."""
    dev = _cuda()
    page = _slice8_page(1 << 20, 300 + slots, dev)
    keys = [] if slots == 1 else [(page.blocks[9].data, page.blocks[9].valid, 0, 41)]
    args = [s for s in _slice8_states(page) if slots == 1 or s[0] != k2.HLL_SUM]
    got = k2.packed_group_agg(page.capacity, page.row_mask, keys, args, slots)
    want = k2.packed_group_agg_plain(page.capacity, page.row_mask, keys, args, slots)
    other = k2.packed_group_agg(page.capacity, ~page.row_mask, keys, args, slots)
    torch.cuda.synchronize()
    assert torch.equal(got[1], want[1])
    for g, w in zip(got[0], want[0]):
        for x, y in zip(g, w):
            assert x.dtype == y.dtype and torch.equal(_bits(x), _bits(y))
    col_kinds = {k2.MIN_DOUBLE: k3.COL_MIN_F64, k2.MAX_DOUBLE: k3.COL_MAX_F64,
                 k2.BOOL_COUNT: k3.COL_I64, k2.BIT_AND: k3.COL_BAND, k2.BIT_OR: k3.COL_BOR,
                 k2.HLL_SUM: k3.COL_F64}

    def cols(states, present):
        out = []
        for (kind, data, _), s in zip(args, states):
            if kind in (k2.MIN_SHORT, k2.MAX_SHORT):
                first = (k3.COL_MIN_BOOL if kind == k2.MIN_SHORT else k3.COL_MAX_BOOL) \
                    if data.dtype == torch.bool else k3.COL_MAX_I32
            else:
                first = col_kinds.get(kind, k3.COL_I64)
            out += [(first if j == 0 else k3.COL_I64, t, present) for j, t in enumerate(s)]
        return out

    a, c = cols(*got), cols(*other)
    fold = k3.packed_fold(a, c, got[1], other[1])
    fold_want = k3.packed_fold_plain(a, c, got[1], other[1])
    torch.cuda.synchronize()
    for x, y in zip(fold[0], fold_want[0]):
        assert torch.equal(x[1], y[1]) and torch.equal(_bits(x[0]), _bits(y[0]))
    f = [d for d, _ in fold[0]]
    items = [(k3.FIN_SUM_F64, f[0], f[1]), (k3.FIN_BOOL_AND, f[4], f[5]),
             (k3.FIN_BOOL_OR, f[4], f[5]), (k3.FIN_SUM, f[6], f[7]),
             (k3.FIN_VALUE_BOOL, f[10], f[11]), (k3.FIN_VALUE_I32, f[14], f[15])]
    if slots == 1:
        items.append((k3.FIN_HLL, f[16], f[17]))
    for got_f, want_f in zip(k3.packed_finalize(items, fold[1]),
                             k3.packed_finalize_plain(items, fold[1])):
        _same_lanes(got_f, want_f)


@pytest.mark.parametrize("presorted", [False, True])
def test_sorted_group_agg_function_states_match_plain(presorted):
    """K6's double and boolean min/max, bitwise folds and HLL sum, bit
    for bit."""
    dev = _cuda()
    page = _slice8_page(1 << 20, 320 + presorted, dev)
    b = page.blocks
    key = torch.arange(1 << 20, device=dev) // 1500 if presorted else \
        torch.remainder(b[2].data, 700)
    keys = [(key, torch.ones_like(b[2].valid), 0, 0 if presorted else 701)]
    rho = torch.remainder(b[2].data, 30) + 1
    states = [(k6.S_MIN_F64, b[0].data, b[0].valid), (k6.S_MAX_F64, b[0].data, b[0].valid),
              (k6.S_MIN, b[8].data, b[8].valid), (k6.S_MAX, b[8].data, b[8].valid),
              (k6.S_BAND, b[2].data, b[2].valid), (k6.S_BOR, b[3].data, b[3].valid),
              (k6.S_SUM, b[8].data, b[8].valid), (k6.S_HLL, rho, b[2].valid),
              (k6.S_VALID, None, b[2].valid)]
    got = k6.sorted_group_agg(keys, page.row_mask, states, presorted)
    want = k6.sorted_group_agg_plain(keys, page.row_mask, states, presorted)
    torch.cuda.synchronize()
    assert got[2] == want[2] > 100
    for x, y in zip(got[1], want[1]):
        assert x.dtype == y.dtype and torch.equal(_bits(x), _bits(y))


SLICE8_SQL = [
    ("select approx_distinct(l_partkey) from lineitem", ()),
    ("select l_returnflag, l_linestatus, approx_distinct(l_orderkey) from lineitem "
     "group by l_returnflag, l_linestatus", ()),
    ("select l_shipmode, min(l_extendedprice / l_quantity), max(l_extendedprice / l_quantity),"
     " min(l_shipinstruct), max(l_shipinstruct), min(l_returnflag = 'R'),"
     " max(l_linestatus = 'F'), bool_and(l_quantity > 1), bool_or(l_quantity > 49),"
     " bitwise_and_agg(l_orderkey), bitwise_or_agg(l_partkey) from lineitem group by l_shipmode",
     ()),
    ("select l_returnflag, count_if(l_quantity > 25), count(*), sum(l_quantity) from lineitem "
     "group by l_returnflag", ()),
    ("select sum(sqrt(l_extendedprice)), sum(ln(l_extendedprice)), sum(power(l_quantity, 2)),"
     " sum(greatest(l_discount, l_tax)), sum(sign(l_quantity - 25)), count(nullif(l_linenumber, 1))"
     " from lineitem", (1, 2)),
    ("select l_orderkey, l_partkey from lineitem limit 10", ()),
    ("select count(*), sum(l_quantity) from lineitem tablesample bernoulli (10)", ()),
]


def test_eighth_slice_on_the_card_equals_the_cpu_run():
    """The function surface through SQL at sf 0.01 on the card, equal to
    the CPU run: exact, but doubles a transcendental produced (the
    listed columns) within a relative 1e-12."""
    _cuda()
    from presto_tpu_torch.runner import QueryRunner
    from presto_tpu_torch.testing import tpch_catalog

    gpu = QueryRunner(tpch_catalog(sf=0.01), device="cuda")
    cpu = QueryRunner(tpch_catalog(sf=0.01), device="cpu")
    k1.op_launches.clear()
    for sql, approx in SLICE8_SQL:
        got, want = gpu.execute(sql).rows, cpu.execute(sql).rows
        assert len(got) == len(want) > 0, sql
        for g, w in zip(got, want):
            for j, (x, y) in enumerate(zip(g, w)):
                if j in approx:
                    assert x == pytest.approx(y, rel=1e-12), sql
                else:
                    assert x == y, sql
    assert {"dun", "dbin", "gl", "nullif", "hll"} <= set(k1.op_launches)


# -- the ninth slice: dates and timestamps, dictionary tables, the
# coupled and statistical aggregates --------------------------------------

S9_WORDS = ["", "7", "42", "-9", "abc", "1.5e3", "NaN", "1_0", "2020-02-29", "ff", "ÉTÉ",
            "99999999999999999999", "FRANCE", "[1,2]", "3.25", "x9"]
S9_DAYS = np.array([-1, -4, 0, -671, 11016, 18321, 18686, 18658, 18992, -25508, 47482,
                    18651, 18652], dtype=np.int64)  # 1969, leap days, month ends, weeks
MPD = 86_400_000_000


def _slice9_page(n: int, seed: int, device) -> Page:
    """Timestamps and dates across 1880..2120 and the calendar's edge
    days, signed unit counts, epoch seconds, a dictionary varchar of
    numbers that do and do not parse, doubles (prices, quantities), a
    small key and booleans, with NULLs and dead rows."""
    rng = np.random.default_rng(seed)
    days = rng.integers(-32000, 55000, n)
    pick = rng.random(n) < 0.3
    days[pick] = rng.choice(S9_DAYS, pick.sum())
    cols = [(days * MPD + rng.integers(0, MPD, n), "timestamp"),
            (days.astype(np.int32), "date"), (rng.integers(-40, 40, n), "bigint"),
            (rng.uniform(-4e9, 4e9, n).round(3), "double"),
            (rng.integers(0, len(S9_WORDS), n).astype(np.int32), "varchar"),
            (rng.uniform(900.0, 1e5, n).round(2), "double"),
            (rng.integers(1, 51, n).astype(np.float64), "double"),
            (rng.integers(0, 41, n), "bigint"), (rng.random(n) < 0.5, "boolean"),
            (rng.permutation(days).astype(np.int32), "date")]
    blocks = [Block(torch.from_numpy(v).to(device),
                    torch.from_numpy(rng.random(n) >= 0.1).to(device), parse_type(t),
                    Dictionary(S9_WORDS) if t == "varchar" else None) for v, t in cols]
    return Page(tuple(blocks), torch.from_numpy(rng.random(n) >= 0.1).to(device))


_TS, _DT9, _N9, _U9, _S9 = (_col(0, "timestamp"), _col(1, "date"), _col(2, "bigint"),
                            _col(3, "double"), _col(4, "varchar"))


def _u(unit):
    return _lit(unit, "varchar")


SLICE9_EXPRS = (
    [_call(p, "bigint", _TS) for p in ("year", "month", "day", "quarter", "day_of_week",
                                       "day_of_year", "week", "year_of_week", "hour",
                                       "minute", "second", "millisecond")]
    + [_call("last_day_of_month", "date", _TS), _call("hour", "bigint", _DT9)]
    + [_call("date_trunc", "timestamp", _u(u), _TS)
       for u in ("second", "minute", "hour", "day", "week", "month", "quarter", "year")]
    + [_call("date_trunc", "date", _u(u), _DT9) for u in ("week", "month", "quarter", "year")]
    + [_call("date_add", "timestamp", _u(u), _N9, _TS)
       for u in ("millisecond", "hour", "week", "month", "quarter", "year")]
    + [_call("date_add", "date", _u(u), _N9, _DT9) for u in ("day", "week", "month", "year")]
    + [_call("date_diff", "bigint", _u(u), _TS, _call("ts_add_micros", "timestamp", _TS,
                                                      _call("mul", "bigint", _N9,
                                                            _lit(987654321012, "bigint"))))
       for u in ("millisecond", "second", "hour", "day", "week", "month", "quarter", "year")]
    + [_call("date_diff", "bigint", _u(u), _DT9, _col(9, "date"))
       for u in ("day", "month", "year")]
    + [_call("date_diff", "bigint", _u("month"), _DT9, _TS),
       _call("ts_add_months", "timestamp", _TS, _N9),
       _call("date_add_days", "date", _DT9, _N9),
       _call("cast_timestamp", "timestamp", _DT9), _call("cast_date", "date", _TS),
       _call("to_unixtime", "double", _TS), _call("to_unixtime", "double", _DT9),
       _call("from_unixtime", "timestamp", _U9),
       _call("date_format", "varchar", _DT9, _lit("%Y-%m-%d", "varchar")),
       _call("date_format", "varchar", _TS, _lit("%Y-%m", "varchar")),
       _call("lt", "boolean", _TS, _col(9, "date")),
       _call("between", "boolean", _TS, _DT9, _col(9, "date")),
       _call("length", "bigint", _S9), _call("strpos", "bigint", _S9, _lit("9", "varchar")),
       _call("codepoint", "integer", _S9), _call("cast_bigint", "bigint", _S9),
       _call("cast_double", "double", _S9),
       _call("levenshtein_distance", "bigint", _S9, _lit("FRANCE", "varchar")),
       _call("date_parse", "timestamp", _S9, _lit("%Y-%m-%d", "varchar")),
       _call("crc32", "bigint", _call("to_utf8", "varbinary", _S9)),
       _call("regexp_like", "boolean", _S9, _lit("^[0-9]+$", "varchar")),
       _call("try", "bigint", _call("cast_bigint", "bigint",
                                    _call("substr", "varchar", _S9, _lit(1, "bigint"),
                                          _lit(1, "bigint"))))]
)


@pytest.mark.parametrize("i", range(len(SLICE9_EXPRS)))
def test_expr_eval_ninth_slice_opcodes_match_plain(i):
    """TSPART, DTRUNC, DTADD, DTDIFF, CASTTS, UNIXT, DFMT, VLUT and
    DVLUT (and the LUT predicates) against the twin on the card, exact."""
    dev = _cuda()
    page = _slice9_page(1 << 20, 400 + i, dev)
    prog, cols = ExprCompiler.for_page(page).lower(SLICE9_EXPRS[i])
    ins = [(page.blocks[c].data, page.blocks[c].valid) for c in cols]
    got = k1.expr_eval(prog, ins, page.capacity)
    want = k1.expr_eval_plain(prog, ins, page.capacity)
    torch.cuda.synchronize()
    _same_lanes(got, want)


def test_expr_eval_checksum_hash_matches_plain():
    """HLL with P = 0 (checksum's whole splitmix64 hash) of an integer
    and of a double's bits, NULL to the constant, exact."""
    dev = _cuda()
    page = _slice9_page(1 << 20, 450, dev)
    for c in (2, 5):
        load = k1.LOAD_F64 if page.blocks[c].data.dtype == torch.float64 else k1.LOAD
        prog = k1.Program((load, k1.HLL, k1.LIT, k1.COAL), (0, 0, 0, 0), (-7046029254386353131,),
                          1, k1.KIND_I64)
        ins = [(page.blocks[c].data, page.blocks[c].valid)]
        got, want = k1.expr_eval(prog, ins, page.capacity), \
            k1.expr_eval_plain(prog, ins, page.capacity)
        torch.cuda.synchronize()
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def _slice9_k2_args(page, keyed):
    b = page.blocks
    price, qty, key = b[5], b[6], b[7]
    args = [(k2.CHECKSUM, b[2].data, b[2].valid),
            (k2.BY_X, b[2].data, b[2].valid), (k2.BY_Y_MIN, price.data, price.valid),
            (k2.BY_X, b[1].data, b[1].valid), (k2.BY_Y_MAX, qty.data, qty.valid),
            (k2.BY_X, b[8].data, b[8].valid), (k2.BY_Y_MAX, b[4].data, b[4].valid)]
    if not keyed:  # the moments, and the covariance sums of (qty, price) where both valid
        both = qty.valid & price.valid
        args += [(k2.MOMENTS, price.data, price.valid)] + [
            (k2.SUM_DOUBLE, lane, both) for lane in (qty.data, price.data, qty.data * price.data,
                                                     qty.data * qty.data,
                                                     price.data * price.data)]
    return args


@pytest.mark.parametrize("slots", [1, 42])
def test_packed_group_agg_tail_states_match_plain(slots):
    """K2's checksum, min_by / max_by (a double, a double with ties and a
    rank-like int32 y; int64, int32 and boolean x) and, in the global
    slot, the moments and the five covariance sums, bit for bit; then
    K3's fold of two such tables and its finalizes."""
    dev = _cuda()
    page = _slice9_page(1 << 20, 460 + slots, dev)
    keys = [] if slots == 1 else [(page.blocks[7].data, page.blocks[7].valid, 0, 42)]
    args = _slice9_k2_args(page, slots > 1)
    got = k2.packed_group_agg(page.capacity, page.row_mask, keys, args, slots)
    want = k2.packed_group_agg_plain(page.capacity, page.row_mask, keys, args, slots)
    other = k2.packed_group_agg(page.capacity, ~page.row_mask, keys, args, slots)
    torch.cuda.synchronize()
    assert torch.equal(got[1], want[1])
    for g, w in zip(got[0], want[0]):
        for x, y in zip(g, w):
            assert x.dtype == y.dtype and torch.equal(_bits(x), _bits(y))
    kinds = [k3.COL_I64]
    for y_kind in (k3.COL_BY_Y_MIN, k3.COL_BY_Y_MAX, k3.COL_BY_Y_MAX):
        kinds += [k3.COL_BY_X, k3.COL_BY_XV, y_kind, k3.COL_I64]
    if slots == 1:
        kinds += [k3.COL_F64, k3.COL_MOM_M2, k3.COL_MOM_M3, k3.COL_MOM_M4, k3.COL_I64] + \
            [k3.COL_F64, k3.COL_I64] * 5

    def cols(states, present):
        return [(k, t, present) for k, t in zip(kinds, [t for s in states for t in s])]

    a, c = cols(*got), cols(*other)
    fold = k3.packed_fold(a, c, got[1], other[1])
    fold_want = k3.packed_fold_plain(a, c, got[1], other[1])
    torch.cuda.synchronize()
    for x, y in zip(fold[0], fold_want[0]):
        assert torch.equal(x[1], y[1]) and torch.equal(_bits(x[0]), _bits(y[0]))
    f = [d for d, _ in fold[0]]
    items = [(k3.FIN_COUNT, f[0], f[0]), (k3.FIN_SUM, f[1], f[2]),
             (k3.FIN_VALUE_I32, f[5], f[6]), (k3.FIN_VALUE_BOOL, f[9], f[10])]
    if slots == 1:
        mom = torch.stack(f[14:17], dim=1)
        sums = torch.stack(f[18:28:2], dim=1)  # sx, sy, sxy, sxx, syy
        items += [(k3.FIN_KURTOSIS, mom, f[17])] + [
            (k, sums, f[19]) for k in (k3.FIN_COVAR_POP, k3.FIN_COVAR_SAMP, k3.FIN_CORR,
                                       k3.FIN_REGR_SLOPE, k3.FIN_REGR_INTERCEPT)]
    for got_f, want_f in zip(k3.packed_finalize(items, fold[1]),
                             k3.packed_finalize_plain(items, fold[1])):
        _same_lanes(got_f, want_f)
    if slots == 1:  # skewness: libdevice's pow and torch's may round apart
        sk = [(k3.FIN_SKEWNESS, torch.stack(f[14:17], dim=1), f[17])]
        g, w = k3.packed_finalize(sk, fold[1])[0], k3.packed_finalize_plain(sk, fold[1])[0]
        assert torch.equal(g[1], w[1]) and ulp_gap(g[0][w[1]], w[0][w[1]]) <= 2


@pytest.mark.parametrize("presorted", [False, True])
def test_sorted_group_agg_tail_states_match_plain(presorted):
    """K6's moments, min_by / max_by and a covariance-style double sum,
    bit for bit, then the merges of the partials (S_MOM_MERGE and the
    coupled states over their flags)."""
    dev = _cuda()
    page = _slice9_page(1 << 20, 480 + presorted, dev)
    b = page.blocks
    key = torch.arange(1 << 20, device=dev) // 1500 if presorted else \
        torch.remainder(b[2].data + 40, 70)
    keys = [(key, torch.ones_like(b[2].valid), 0, 0 if presorted else 71)]
    states = [(k6.S_MOM, b[5].data, b[5].valid),
              (k6.S_BY_X, b[2].data, b[2].valid), (k6.S_BY_XV, None, b[2].valid),
              (k6.S_BY_Y_MIN, b[6].data, b[6].valid), (k6.S_VALID, None, b[6].valid),
              (k6.S_BY_X, b[8].data, b[8].valid), (k6.S_BY_XV, None, b[8].valid),
              (k6.S_BY_Y_MAX, b[4].data, b[4].valid), (k6.S_VALID, None, b[4].valid),
              (k6.S_DSUM, b[6].data, b[6].valid), (k6.S_SUM, b[2].data, b[2].valid)]
    got = k6.sorted_group_agg(keys, page.row_mask, states, presorted)
    want = k6.sorted_group_agg_plain(keys, page.row_mask, states, presorted)
    torch.cuda.synchronize()
    assert got[2] == want[2] > 60
    for x, y in zip(got[1], want[1]):
        assert x.dtype == y.dtype and torch.equal(_bits(x), _bits(y))
    # the merge of two copies of the partial rows
    o = got[1]
    mkeys = [(torch.cat([got[0][0][0]] * 2), torch.cat([got[0][0][1]] * 2), 0, 0)]
    live = torch.ones(2 * got[2], dtype=torch.bool, device=dev)

    def twice(t):
        return torch.cat([t, t])

    merge = [(k6.S_MOM_MERGE, tuple(twice(t) for t in o[:5]), live)]
    for x, flag, y, cnt, kind in ((o[5], o[6], o[7], o[8], k6.S_BY_Y_MIN),
                                  (o[9], o[10], o[11], o[12], k6.S_BY_Y_MAX)):
        merge += [(k6.S_BY_X, twice(x), twice(flag) > 0), (k6.S_BY_XV, None, twice(flag) > 0),
                  (kind, twice(y), twice(cnt) > 0), (k6.S_SUM, twice(cnt), live)]
    got_m = k6.sorted_group_agg(mkeys, live, merge)
    want_m = k6.sorted_group_agg_plain(mkeys, live, merge)
    torch.cuda.synchronize()
    assert got_m[2] == want_m[2] == got[2]
    for x, y in zip(got_m[1], want_m[1]):
        assert x.dtype == y.dtype and torch.equal(_bits(x), _bits(y))


SLICE9_SQL = [
    ("select date_trunc('month', l_shipdate), count(*), sum(l_extendedprice) from lineitem "
     "group by date_trunc('month', l_shipdate)", ()),
    ("select l_shipmode, sum(date_diff('day', l_shipdate, l_receiptdate)), "
     "max(date_diff('month', l_commitdate, l_receiptdate)), min(date_add('month', 1, "
     "l_shipdate)) from lineitem group by l_shipmode", ()),
    ("select date_format(o_orderdate, '%Y-%m'), count(*), sum(o_totalprice) from orders "
     "group by 1", ()),
    ("select cast(substr(c_phone, 1, 2) as bigint), count(*), max(length(c_name)) "
     "from customer where regexp_like(c_name, '9$') group by 1", ()),
    ("select l_shipmode, min_by(l_orderkey, l_extendedprice), max_by(l_partkey, l_discount), "
     "skewness(l_quantity), kurtosis(l_extendedprice), covar_samp(l_extendedprice, l_quantity), "
     "corr(l_extendedprice, l_discount), checksum(l_orderkey) from lineitem "
     "group by l_shipmode", (3,)),
    ("select min_by(l_orderkey, l_extendedprice), skewness(l_quantity), "
     "regr_intercept(l_extendedprice, l_quantity), checksum(l_orderkey) from lineitem", (1,)),
]


def test_ninth_slice_on_the_card_equals_the_cpu_run():
    """The slice through SQL at sf 0.01 on the card, equal to the CPU
    run: exact, but skewness (the listed columns: pow) within a relative
    1e-12."""
    _cuda()
    from presto_tpu_torch.runner import QueryRunner
    from presto_tpu_torch.testing import tpch_catalog

    gpu = QueryRunner(tpch_catalog(sf=0.01), device="cuda")
    cpu = QueryRunner(tpch_catalog(sf=0.01), device="cpu")
    k1.op_launches.clear()
    for sql, approx in SLICE9_SQL:
        got, want = gpu.execute(sql).rows, cpu.execute(sql).rows
        assert len(got) == len(want) > 0, sql
        for g, w in zip(got, want):
            for j, (x, y) in enumerate(zip(g, w)):
                if j in approx:
                    assert x == pytest.approx(y, rel=1e-12), sql
                else:
                    assert x == y, sql
    assert {"dtrunc", "dtdiff", "dtadd", "dfmt", "vlut", "mix64"} <= set(k1.op_launches)


# -- the tenth slice: K12 container_eval, K13 unnest_expand, K14 group_collect --

def _slot_matrix(g, n, m, dtype, device):
    """A seeded (n, 1 + m) slot matrix: lengths 0..m, NULL elements,
    +-inf or the type's max, pads as the sentinel."""
    from presto_tpu_torch.kernels import container_eval as k12

    lens = torch.randint(0, m + 1, (n,), generator=g)
    s = torch.randint(-4, 5, (n, m), generator=g).to(dtype)
    s[torch.rand((n, m), generator=g) < 0.05] = (float("inf") if dtype.is_floating_point
                                                 else torch.iinfo(dtype).max)
    s[torch.rand((n, m), generator=g) < 0.1] = k12.sentinel(dtype)
    j = torch.arange(m)[None, :]
    s = torch.where(j < lens[:, None], s, torch.full_like(s, k12.sentinel(dtype)))
    return torch.cat([lens[:, None].to(dtype), s], 1).to(device)


def _bits(x):
    if isinstance(x, (tuple, list)):
        return [_bits(t) for t in x]
    return x.view(torch.int64) if x.dtype == torch.float64 else x


def _equal(a, b):
    a, b = _bits(a), _bits(b)
    if isinstance(a, list):
        return len(a) == len(b) and all(_equal(x, y) for x, y in zip(a, b))
    return a.shape == b.shape and a.dtype == b.dtype and torch.equal(a, b)


CONTAINER_OPS = ["card", "subscript", "map_get", "contains", "position", "reduce_min",
                 "reduce_max", "reduce_sum", "reduce_avg", "sort", "distinct", "slice",
                 "coerce", "coerce_up", "concat", "map_half", "construct", "construct_row",
                 "construct_map", "row_field", "compact", "compact_pairs", "intersect",
                 "except", "overlap", "remove", "map_concat", "transform_keys", "sequence",
                 "repeat", "assemble", "assemble_keys", "match", "slot", "table"]


@pytest.mark.parametrize("dtype", ["int64", "float64", "int32"])
@pytest.mark.parametrize("name", CONTAINER_OPS)
def test_container_eval_opcode_matches_plain(name, dtype):
    """Each K12 opcode against its twin on the card at 2^20 rows, bit for
    bit (the lambda opcodes over K13's offsets of the same rows)."""
    dev = _cuda()
    from presto_tpu_torch.kernels import container_eval as k12
    from presto_tpu_torch.kernels import unnest_expand as k13

    dt = getattr(torch, dtype)
    g = torch.Generator().manual_seed(CONTAINER_OPS.index(name))
    n, m = 1 << 20, 8
    a, b = _slot_matrix(g, n, m, dt, dev), _slot_matrix(g, n, m, dt, dev)
    mp = torch.cat([a, b[:, 1:]], 1).contiguous()
    av = (torch.rand(n, generator=g) < 0.9).to(dev)
    xv = (torch.rand(n, generator=g) < 0.9).to(dev)
    x = torch.randint(-3, 10, (n,), generator=g).to(dev)
    off, total = None, 0
    if name in ("compact", "compact_pairs", "transform_keys", "assemble", "assemble_keys",
                "match"):
        _, _, _, total, off = k13.unnest_expand(av, [(a, av, m, [(1, dt)])], [], False)
    yb = (torch.rand(max(total, 1), generator=g) < 0.5).to(dev)
    yv = (torch.rand(max(total, 1), generator=g) < 0.9).to(dev)
    yd = torch.randint(-5, 5, (max(total, 1),), generator=g).to(dt).to(dev)
    y2 = torch.stack([x.to(dt), (x * 3).to(dt)], 1).contiguous()
    y2v = torch.stack([xv, av], 1).contiguous()
    kw = {
        "card": dict(op=k12.CARD, a=a, av=av),
        "subscript": dict(op=k12.SUBSCRIPT, a=a, av=av, x=x, xv=xv),
        "map_get": dict(op=k12.MAP_GET, a=mp, av=av, x=x, xv=xv, p=[0, 0, 0, 0, 0, m]),
        "contains": dict(op=k12.CONTAINS, a=a, av=av, x=x, xv=xv),
        "position": dict(op=k12.POSITION, a=a, av=av, x=x, xv=xv),
        "reduce_min": dict(op=k12.REDUCE, a=a, av=av, p=[k12.R_MIN]),
        "reduce_max": dict(op=k12.REDUCE, a=a, av=av, p=[k12.R_MAX]),
        "reduce_sum": dict(op=k12.REDUCE, a=a, av=av, p=[k12.R_SUM]),
        "reduce_avg": dict(op=k12.REDUCE, a=a, av=av, p=[k12.R_AVG]),
        "sort": dict(op=k12.SORT, a=a), "distinct": dict(op=k12.DISTINCT, a=a),
        "slice": dict(op=k12.SLICE, a=a, p=[-3, 2]),
        "coerce": dict(op=k12.COERCE, a=a, out_dtype=torch.float64, p=[0, 0, 0, 0, 0, m]),
        "coerce_up": dict(op=k12.COERCE, a=mp, out_dtype=torch.int64,
                          p=[k12.C_UP, 100, k12.C_ASTYPE, 0, 1, m]),
        "concat": dict(op=k12.CONCAT, a=a, b=b, out_m=2 * m),
        "map_half": dict(op=k12.MAP_HALF, a=mp, out_dtype=torch.float64, p=[1, 0, 0, 0, 0, m]),
        "construct": dict(op=k12.CONSTRUCT, y=y2, yv=y2v, out_m=m, p=[1]),
        "construct_row": dict(op=k12.CONSTRUCT, y=y2, yv=y2v, out_m=2, p=[0]),
        "construct_map": dict(op=k12.CONSTRUCT_MAP, a=a, b=b, out_m=m),
        "row_field": dict(op=k12.ROW_FIELD, a=a, av=av, p=[3]),
        "compact": dict(op=k12.COMPACT, a=a, y=yb, yv=yv, off=off, out_m=m),
        "compact_pairs": dict(op=k12.COMPACT_PAIRS, a=mp, y=yb, yv=yv, off=off, out_m=m,
                              p=[0, 0, 0, 0, 0, m]),
        "intersect": dict(op=k12.SETOP, a=a, b=b, c=a, out_m=m, p=[k12.S_INTERSECT]),
        "except": dict(op=k12.SETOP, a=a, b=b, c=a, out_m=m, p=[k12.S_EXCEPT]),
        "overlap": dict(op=k12.OVERLAP, a=a, av=av, b=b, bv=xv, c=a),
        "remove": dict(op=k12.REMOVE, a=a, av=av, x=x, xv=xv),
        "map_concat": dict(op=k12.MAP_CONCAT, a=mp, b=mp.flip(0).contiguous(), out_m=m,
                           p=[0, 0, 0, 0, m, m]),
        "transform_keys": dict(op=k12.TKEYS, a=mp, y=yd, yv=yv, off=off, out_m=m,
                               p=[0, 0, 0, 0, 0, m]),
        "sequence": dict(op=k12.SEQUENCE, x=x, out_m=5, out_dtype=torch.int64, p=[3, -2]),
        "repeat": dict(op=k12.REPEAT, x=x, xv=xv, out_m=4, out_dtype=dt, p=[3]),
        "assemble": dict(op=k12.ASSEMBLE, y=yd, yv=yv, off=off, out_m=m),
        "assemble_keys": dict(op=k12.ASSEMBLE, a=mp, y=yd, yv=yv, off=off, out_m=m,
                              p=[1, k12._KIND[dt]]),
        "match": dict(op=k12.MATCH, av=av, y=yb, yv=yv, off=off, p=[k12.M_ALL, m]),
        "slot": dict(op=k12.SLOT, a=a, p=[2]),
        "table": dict(op=k12.TABLE, a=b[:1000].contiguous(), x=x.abs(), xv=xv),
    }[name]
    before = k12.launches
    got = k12.container_eval(**kw)
    assert k12.launches == before + 1
    pp = list(kw.get("p", [])) + [0] * (6 - len(kw.get("p", [])))
    want = k12.plain(kw["op"], kw.get("a"), kw.get("av"), kw.get("b"), kw.get("bv"),
                     kw.get("c"), kw.get("x"), kw.get("xv"), kw.get("y"), kw.get("yv"),
                     kw.get("off"), kw.get("out_m", 0), kw.get("out_dtype"), pp)
    torch.cuda.synchronize()
    assert _equal(got, want)


def test_container_eval_refuses_what_it_lacks():
    dev = _cuda()
    from presto_tpu_torch.kernels import container_eval as k12

    a = torch.zeros((4, 3), dtype=torch.int16, device=dev)
    with pytest.raises(ValueError):
        k12.container_eval(k12.CARD, a)
    with pytest.raises(ValueError):
        k12.container_eval(99, torch.zeros((4, 3), dtype=torch.int64, device=dev))


@pytest.mark.parametrize("dtype", ["int64", "float64"])
def test_unnest_and_group_collect_match_plain(dtype):
    """K13 (two containers zipped, an outer column, ordinality) and K14's
    collect and merge against their twins at 2^20 rows, bit for bit."""
    dev = _cuda()
    from presto_tpu_torch.kernels import group_collect as k14
    from presto_tpu_torch.kernels import unnest_expand as k13

    dt = getattr(torch, dtype)
    g = torch.Generator().manual_seed(5)
    n, m = 1 << 20, 8
    a, b = _slot_matrix(g, n, m, dt, dev), _slot_matrix(g, n, 4, torch.int64, dev)
    av, bv, rm = ((torch.rand(n, generator=g) < p).to(dev) for p in (0.9, 0.8, 0.9))
    x = torch.randint(-3, 10, (n,), generator=g).to(dev)
    args = [(a, av, m, [(1, dt)]), (b, bv, 4, [(1, torch.int32)])]
    got = k13.unnest_expand(rm, args, [(x, av), (a, bv)], True)
    want = k13.unnest_expand_plain(rm, args, [(x, av), (a, bv)], True)
    flat = lambda r: [t for c in r[0] + r[1] for t in c] + [r[2], r[4]]  # noqa: E731
    assert got[3] == want[3] and _equal(flat(got), flat(want))
    gid = torch.sort(torch.randint(0, n // 4, (n,), generator=g)).values
    starts = torch.searchsorted(gid, torch.arange(n // 4 + 1)).to(dev)
    order = torch.randperm(n, generator=g).to(dev)
    for halves in ([(x, av)], [(x, rm), (a[:, 1].contiguous(), av)]):
        assert _equal(k14.group_collect(order, starts, rm, halves, 64, dt),
                      k14.group_collect_plain(order, starts, rm, halves, 64, dt))
    parts = torch.cat([torch.clamp(a[:, :1], max=8), a[:, 1:]], 1).contiguous()
    assert _equal(k14.group_collect_merge(order, starts, rm, parts, 8),
                  k14.group_collect_merge_plain(order, starts, rm, parts, 8))


TENTH_SLICE_SQL = [
    "select o_orderkey, x.a from orders, (select l_orderkey k, array_agg(l_linenumber) a "
    "from lineitem group by 1) x where o_orderkey = x.k and o_orderkey < 1000 order by 1",
    "select l_orderkey, array_agg(l_partkey) from lineitem where l_orderkey < 2000 "
    "group by 1 order by 1",
    "select count(*), sum(e), sum(o) from (select l_orderkey, array_agg(l_partkey) a from "
    "lineitem group by l_orderkey) cross join unnest(a) with ordinality as u(e, o)",
    "select w, count(*) c from part cross join unnest(split(p_name, ' ')) as u(w) "
    "group by w order by c desc, w limit 10",
    "select l_returnflag, histogram(l_linenumber) from lineitem group by 1 order by 1",
    "select sum(case when contains(array[1, 5, 7], l_linenumber) then 1 else 0 end), "
    "sum(array[l_partkey, l_suppkey][2]), sum(cast(row(l_partkey, l_suppkey) as "
    "row(x bigint, y bigint)).x) from lineitem",
    "select count(*), sum(array_sum(transform(a, x -> x * 2))), sum(cardinality(filter(a, "
    "x -> x % 2 = 0))), sum(case when any_match(a, x -> x > 100) then 1 else 0 end), "
    "sum(reduce(a, 0, (s, x) -> s + x, s -> s)) from (select l_orderkey, "
    "array_agg(l_partkey) a from lineitem group by l_orderkey)",
]


def test_tenth_slice_on_the_card_equals_the_cpu_run():
    """ARRAY, MAP and ROW through SQL at sf 0.01 on the card, equal to
    the CPU run, through K12, K13 and K14."""
    _cuda()
    from presto_tpu_torch.kernels import container_eval as k12
    from presto_tpu_torch.kernels import group_collect as k14
    from presto_tpu_torch.kernels import unnest_expand as k13
    from presto_tpu_torch.runner import QueryRunner
    from presto_tpu_torch.testing import tpch_catalog

    gpu = QueryRunner(tpch_catalog(sf=0.01), device="cuda")
    cpu = QueryRunner(tpch_catalog(sf=0.01), device="cpu")
    before = (k12.launches, k13.launches, k14.launches)
    for sql in TENTH_SLICE_SQL:
        got, want = gpu.execute(sql).rows, cpu.execute(sql).rows
        assert got == want and got, sql
    assert all(x > y for x, y in zip((k12.launches, k13.launches, k14.launches), before))
