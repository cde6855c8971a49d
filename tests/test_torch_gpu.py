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
from presto_tpu_torch.types import INTERVAL_DAY_SECOND, parse_type
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


# -- the eleventh slice: REAL, SMALLINT, TINYINT and INTERVAL values ---------------

def _types_page(n, seed, device):
    """REALs over many magnitudes with signed zeros and infinities,
    SMALLINT and TINYINT over their whole range, bigints around the
    narrow ranges, a decimal, a small key, a timestamp and an interval."""
    rng = np.random.default_rng(seed)
    r = (rng.normal(size=(2, n)) * 10.0 ** rng.uniform(-6, 6, (2, n))).astype(np.float32)
    r[rng.random((2, n)) < 0.05] = np.float32(-0.0)
    r[rng.random((2, n)) < 0.02] = np.float32(np.inf)
    a = rng.integers(-10 ** 6, 10 ** 6, n)
    a[rng.random(n) < 0.3] = rng.choice([32767, 32768, -32769, 128, -129, (1 << 53) + 1,
                                         I64_MAX, -I64_MAX - 1], 1)[0]
    cols = [(r[0], "real"), (r[1], "real"), (rng.integers(-32768, 32768, n).astype(np.int16),
                                             "smallint"),
            (rng.integers(-128, 128, n).astype(np.int8), "tinyint"), (a, "bigint"),
            (rng.integers(-10 ** 9, 10 ** 9, n), "decimal(12,2)"),
            (rng.integers(0, 40, n), "bigint"),
            (rng.integers(-10 ** 15, 10 ** 15, n), "timestamp"),
            (rng.integers(-10 ** 12, 10 ** 12, n), "bigint")]
    blocks = [Block(torch.from_numpy(d).to(device),
                    torch.from_numpy(rng.random(n) >= 0.1).to(device), parse_type(t))
              for d, t in cols]
    return Page(tuple(blocks), torch.from_numpy(rng.random(n) >= 0.1).to(device))


_R, _S, _H, _T, _A = (_col(0, "real"), _col(1, "real"), _col(2, "smallint"),
                      _col(3, "tinyint"), _col(4, "bigint"))
_D11, _TS11, _IV = _col(5, "decimal(12,2)"), _col(7, "timestamp"), _col(8, "bigint")
SLICE11_EXPRS = [
    _call("cast_real", "real", _D11), _call("cast_real", "real", _A),
    _call("cast_real", "real", _H), _call("cast_smallint", "smallint", _A),
    _call("cast_smallint", "smallint", _D11), _call("cast_smallint", "smallint", _R),
    _call("cast_tinyint", "tinyint", _H), _call("cast_tinyint", "tinyint", _A),
    _call("add", "real", _R, _S), _call("sub", "real", _R, _S), _call("mul", "real", _R, _S),
    _call("div", "real", _R, _S), _call("mod", "real", _R, _S),
    _call("mul", "real", _D11, _R), _call("add", "real", _R, _lit(1, "bigint")),
    _call("neg", "real", _R), _call("lt", "boolean", _R, _S),
    _call("gt", "boolean", _R, _lit(15, "decimal(2,1)")),
    _call("in", "boolean", _R, _lit(0.5, "double"), _lit(0.0, "double")),
    _call("in", "boolean", _call("cast_double", "double", _D11), _lit(2.5, "double"),
          _lit(-3.5, "double")),
    _call("add", "smallint", _H, _H), _call("mul", "smallint", _H, _T),
    _call("div", "smallint", _H, _T), _call("mod", "smallint", _H, _T),
    _call("sub", "tinyint", _T, _T), _call("neg", "smallint", _H),
    ir.Call(type=INTERVAL_DAY_SECOND, fn="sub", args=(_TS11, _TS11)),
    _call("mul", "bigint", _IV, _call("cast_bigint", "bigint", _T)),
]


@pytest.mark.parametrize("i", range(len(SLICE11_EXPRS)))
def test_expr_eval_eleventh_slice_opcodes_match_plain(i):
    """K1's narrow kinds, F32R, CASTN, DIN and the width-wise IMOD against
    the twin on the card, REALs bit for bit."""
    dev = _cuda()
    page = _types_page(1 << 20, 500 + i, dev)
    prog, cols = ExprCompiler.for_page(page).lower(SLICE11_EXPRS[i])
    ins = [(page.blocks[c].data, page.blocks[c].valid) for c in cols]
    got = k1.expr_eval(prog, ins, page.capacity)
    want = k1.expr_eval_plain(prog, ins, page.capacity)
    torch.cuda.synchronize()
    assert _equal(_f32_bits(got), _f32_bits(want))


def _f32_bits(x):
    if isinstance(x, (tuple, list)):
        return [_f32_bits(t) for t in x]
    return x.view(torch.int32) if x.dtype == torch.float32 else x


@pytest.mark.parametrize("slots", [1, 41])
def test_packed_group_agg_narrow_states_match_plain(slots):
    """K2 over REAL, SMALLINT, TINYINT and int64 arguments (a REAL's
    extremes in float32, its double sum in the global slot), with
    SMALLINT and TINYINT key columns, bit for bit."""
    dev = _cuda()
    page = _types_page(1 << 20, 600 + slots, dev)
    b = page.blocks
    n = page.capacity
    keys = [] if slots == 1 else [(b[6].data, b[6].valid, 0, 41)]
    args = [(k2.MIN_DOUBLE, b[0].data, b[0].valid), (k2.MAX_DOUBLE, b[1].data, b[1].valid),
            (k2.MIN_SHORT, b[2].data, b[2].valid), (k2.MAX_SHORT, b[3].data, b[3].valid),
            (k2.SUM_SHORT, b[2].data, b[2].valid), (k2.SUM_SHORT, b[3].data, b[3].valid)]
    if slots == 1:
        args.append((k2.SUM_DOUBLE, b[0].data, b[0].valid))
    got = k2.packed_group_agg(n, page.row_mask, keys, args, slots)
    want = k2.packed_group_agg_plain(n, page.row_mask, keys, args, slots)
    torch.cuda.synchronize()
    assert _equal(_f32_bits(got), _f32_bits(want))
    if slots > 1:  # SMALLINT and TINYINT keys in the packed table
        nk = [(b[3].data, b[3].valid, -128, 258), (b[2].data, b[2].valid, -32768, 65537)]
        got = k2.packed_group_agg(n, page.row_mask, nk[:1], args[:4], 258)
        want = k2.packed_group_agg_plain(n, page.row_mask, nk[:1], args[:4], 258)
        assert _equal(_f32_bits(got), _f32_bits(want))


@pytest.mark.parametrize("presorted", [False, True])
def test_sorted_group_agg_narrow_states_match_plain(presorted):
    """K6 over REAL extremes and sums and SMALLINT extremes and sums, by
    hashed SMALLINT, TINYINT and REAL keys (K9), bit for bit."""
    dev = _cuda()
    page = _types_page(1 << 20, 700 + presorted, dev)
    b = page.blocks
    keys = [(b[3].data, b[3].valid, 0, 0)] if presorted else \
        [(b[2].data, b[2].valid, 0, 0), (b[3].data, b[3].valid, 0, 0),
         (b[1].data, b[1].valid, 0, 0)]
    states = [(k6.S_MIN_F64, b[0].data, b[0].valid), (k6.S_MAX_F64, b[0].data, b[0].valid),
              (k6.S_DSUM, b[0].data, b[0].valid), (k6.S_MIN, b[2].data, b[2].valid),
              (k6.S_MAX, b[3].data, b[3].valid), (k6.S_SUM, b[2].data, b[2].valid),
              (k6.S_VALID, None, b[0].valid)]
    got = k6.sorted_group_agg(keys, page.row_mask, states, presorted)
    want = k6.sorted_group_agg_plain(keys, page.row_mask, states, presorted)
    torch.cuda.synchronize()
    assert got[2] == want[2] > 100
    assert _equal(_f32_bits(got[:2]), _f32_bits(want[:2]))


def test_packed_fold_finalize_narrow_states_match_plain():
    """K3's fold of REAL (float32), SMALLINT and int64 extremes and its
    finalize (FIN_VALUE, an interval's HALF_UP avg), bit for bit."""
    dev = _cuda()
    tables = []
    for seed in (801, 802):
        page = _types_page(1 << 18, seed, dev)
        b = page.blocks
        args = [(k2.MIN_DOUBLE, b[0].data, b[0].valid), (k2.MIN_SHORT, b[2].data, b[2].valid),
                (k2.SUM_SHORT, b[8].data, b[8].valid)]
        tables.append(k2.packed_group_agg(page.capacity, page.row_mask,
                                          [(b[6].data, b[6].valid, 0, 41)], args, 41))
    kinds = [k3.COL_MIN_F64, k3.COL_I64, k3.COL_MAX_I64, k3.COL_I64, k3.COL_I64, k3.COL_I64]

    def cols(states, present):
        return [(k, t, present) for k, t in zip(kinds, [t for st in states for t in st])]

    got = k3.packed_fold(cols(*tables[0]), cols(*tables[1]), tables[0][1], tables[1][1])
    want = k3.packed_fold_plain(cols(*tables[0]), cols(*tables[1]), tables[0][1],
                                tables[1][1])
    assert _equal(_f32_bits(got), _f32_bits(want))
    f = [d for d, _ in got[0]]
    items = [(k3.FIN_VALUE, f[0], f[1]), (k3.FIN_VALUE, f[2], f[3]),
             (k3.FIN_AVG_SHORT, f[4], f[5])]
    got = k3.packed_finalize(items, got[1])
    want = k3.packed_finalize_plain(items, want[1])
    torch.cuda.synchronize()
    assert _equal(_f32_bits(got), _f32_bits(want))


@pytest.mark.parametrize("n", [10, 100])
def test_topn_real_and_narrow_keys_match_plain(n):
    """K7 with a REAL key (its exact double's order: -0.0 ties 0.0, NaN
    last), a SMALLINT and a TINYINT key."""
    dev = _cuda()
    page = _types_page(1 << 20, 900 + n, dev)
    b = page.blocks
    for keys in ([(b[0].data, b[0].valid, False, False), (b[4].data, b[4].valid, True, True)],
                 [(b[3].data, b[3].valid, True, False), (b[2].data, b[2].valid, False, True),
                  (b[1].data, b[1].valid, True, False)]):
        got, want = k7.topn(keys, page.row_mask, n), k7.topn_plain(keys, page.row_mask, n)
        torch.cuda.synchronize()
        assert _equal(list(got), list(want))


def test_window_eval_over_real_matches_plain():
    """K10's sum, avg, min, max and lag over a REAL argument, ordered by a
    REAL key, bit for bit."""
    dev = _cuda()
    page = _types_page(1 << 18, 950, dev)
    b = page.blocks
    n = page.capacity
    pkey = b[6].data.clone()
    perm = torch.argsort(pkey * (1 << 32) + torch.arange(n, device=dev), stable=True)
    funcs = [k10.Func(k10.SUM, k10.FRAME_PEERS), k10.Func(k10.AVG, k10.FRAME_ROWS, -2, 1),
             k10.Func(k10.MIN, k10.FRAME_PEERS), k10.Func(k10.MAX, k10.FRAME_WHOLE),
             k10.Func(k10.LAG, k10.FRAME_WHOLE), k10.Func(k10.MIN, k10.FRAME_PEERS)]
    args = [(b[0].data, b[0].valid)] * 5 + [(b[2].data, b[2].valid)]
    order = [(b[1].data, b[1].valid)]
    got = k10.window_eval(perm, page.row_mask, pkey, order, funcs, args)
    want = k10.window_eval_plain(perm, page.row_mask, pkey, order, funcs, args)
    torch.cuda.synchronize()
    assert _equal(_f32_bits(got), _f32_bits(want))


ELEVENTH_SLICE_SQL = [
    "select l_returnflag, sum(cast(l_quantity as real)), avg(cast(l_discount as real)), "
    "min(cast(l_tax as real)), max(cast(l_extendedprice as real)) from lineitem group by 1 "
    "order by 1",
    "select cast(l_linenumber as tinyint), cast(l_quantity as smallint), count(*), "
    "sum(cast(l_quantity as smallint)) from lineitem group by 1, 2 order by 1, 2",
    "select l_shipmode, sum(l_receiptdate - l_shipdate), avg(l_receiptdate - l_shipdate), "
    "min(cast(l_discount as real)), max(cast(l_quantity as smallint)) from lineitem group by 1 "
    "order by 1",
    "select count(*) from lineitem where cast(l_discount as double) in (0.02e0, 0.05e0)",
    "select l_orderkey, l_extendedprice from lineitem order by l_extendedprice desc, "
    "l_orderkey limit 500",
    "select o_orderkey, cast(o_totalprice as real) r from orders order by r desc, o_orderkey "
    "limit 50",
    "select count(*), max(rs) from (select sum(cast(o_totalprice as real)) over (partition by "
    "o_custkey order by o_orderdate, o_orderkey) rs from orders)",
]


def test_eleventh_slice_on_the_card_equals_the_cpu_run():
    """REAL, SMALLINT, TINYINT and INTERVAL values, IN over a double and
    ORDER BY ... LIMIT past 100 through SQL at sf 0.01 on the card, equal
    to the CPU run (doubles bit for bit: the port's fixed sum orders)."""
    _cuda()
    from presto_tpu_torch.ops import sort as port_sort
    from presto_tpu_torch.runner import QueryRunner
    from presto_tpu_torch.testing import tpch_catalog

    gpu = QueryRunner(tpch_catalog(sf=0.01), device="cuda")
    cpu = QueryRunner(tpch_catalog(sf=0.01), device="cpu")
    k1.op_launches.clear()
    before = (k7.real_launches, k10.narrow_launches, port_sort.sorted_topn_runs)
    for sql in ELEVENTH_SLICE_SQL:
        got, want = gpu.execute(sql).rows, cpu.execute(sql).rows
        assert got == want and got, sql
    assert {"f32r", "castn", "din", "narrow"} <= set(k1.op_launches)
    assert all(x > y for x, y in zip((k7.real_launches, k10.narrow_launches,
                                      port_sort.sorted_topn_runs), before))


def _bits_equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    if a.is_floating_point():
        a, b = a.view(torch.int64), b.view(torch.int64)
    return a.shape == b.shape and bool((a == b).all())


@pytest.mark.parametrize("storage", [torch.int64, torch.float64])
def test_group_topn_matches_plain(storage):
    """K15 over skewed groups (one of most entries, many of a few, empty
    ones): both lane orders, with and without the key half, bit for bit."""
    from presto_tpu_torch.kernels import group_topn as k15

    dev = _cuda()
    rng = np.random.default_rng(1200)
    m, groups = 1 << 20, 5000
    g = np.where(rng.random(m) < 0.5, 7, rng.integers(0, groups - 10, m))
    key = rng.integers(-50, 50, m)
    g_t = torch.from_numpy(g).to(dev)
    key_t = torch.from_numpy(key.astype(np.float64) / 4 if storage == torch.float64
                             else key).to(dev)
    sel = torch.from_numpy(rng.random(m) >= 0.1).to(dev)
    perm, starts = k15.sorted_entries(g_t, key_t, sel, groups)
    vals = torch.from_numpy(rng.integers(-9, 9, m)).to(dev).to(storage)
    for desc in (True, False):
        for keys in (None, key_t.to(storage)):
            got = k15.group_topn(perm, starts, vals, keys, 10, desc)
            want = k15.group_topn_plain(perm, starts, vals, keys, 10, desc)
            torch.cuda.synchronize()
            assert _bits_equal(got, want)


@pytest.mark.parametrize("counted", [True, False])
def test_kmv_lanes_matches_plain(counted):
    """K16 over entries with heavy duplication and one huge group, with
    counts (a merge's) and without (make_set_digest's: each entry 1)."""
    from presto_tpu_torch.kernels import group_topn as k15
    from presto_tpu_torch.kernels import kmv_lanes as k16

    dev = _cuda()
    rng = np.random.default_rng(1201)
    m, groups = 1 << 20, 300
    g = torch.from_numpy(np.where(rng.random(m) < 0.6, 3, rng.integers(0, groups - 5, m))).to(dev)
    pool = rng.integers(-(1 << 62), 1 << 62, 5000)
    h = torch.from_numpy(pool[rng.integers(0, 5000, m)]).to(dev)
    counts = torch.from_numpy(rng.integers(1, 5, m)).to(dev) if counted else None
    sel = torch.from_numpy(rng.random(m) >= 0.1).to(dev)
    perm, starts = k15.sorted_entries(g, h, sel, groups)
    got = k16.kmv_lanes(perm, g, h, counts, starts, 64)
    want = k16.kmv_lanes_plain(perm, g, h, counts, starts, 64)
    torch.cuda.synchronize()
    assert _bits_equal(got[0], want[0]) and _bits_equal(got[1], want[1])


def test_group_collect_wide_half_and_union_match_plain():
    """K14's value half of 1 + 8 slots per entry (multimap_agg) and its
    merge, and map_union's merge of 4-entry maps into 64 slots."""
    from presto_tpu_torch.kernels import group_collect as k14

    dev = _cuda()
    rng = np.random.default_rng(1202)
    n, groups = 200_000, 900
    order = torch.from_numpy(rng.permutation(n)).to(dev)
    sizes = np.bincount(rng.integers(0, groups, n), minlength=groups)
    starts = torch.from_numpy(np.concatenate([[0], np.cumsum(sizes)])).to(dev)
    sel = torch.from_numpy(rng.random(n) >= 0.2).to(dev)
    key = (torch.from_numpy(rng.integers(0, 9, n)).to(dev), sel)
    arr = np.full((n, 9), -(1 << 63), np.int64)
    arr[:, 0] = rng.integers(0, 9, n)
    arr[:, 1:] = rng.integers(-5, 5, (n, 8))
    arrs = (torch.from_numpy(arr).to(dev), torch.from_numpy(rng.random(n) >= 0.1).to(dev))
    for storage in (torch.int64, torch.float64):
        got = k14.group_collect(order, starts, sel, [key, arrs], 64, storage)
        want = k14.group_collect_plain(order, starts, sel, [key, arrs], 64, storage)
        torch.cuda.synchronize()
        assert _bits_equal(got, want)
        parts = torch.cat([got, got])
        live = torch.ones(2 * groups, dtype=torch.bool, device=dev)
        mst = torch.arange(0, 2 * groups + 1, 2, device=dev)
        morder = torch.arange(2 * groups, device=dev).view(2, groups).t().reshape(-1)
        m_got = k14.group_collect_merge(morder, mst, live, parts, 64, halves=2, vw=9)
        m_want = k14.group_collect_merge_plain(morder, mst, live, parts, 64, 2, 9)
        torch.cuda.synchronize()
        assert _bits_equal(m_got, m_want)
    maps = np.full((n, 9), -(1 << 63), np.int64)
    maps[:, 0] = rng.integers(0, 5, n)
    maps[:, 1:] = rng.integers(0, 40, (n, 8))
    maps_t = torch.from_numpy(maps).to(dev)
    got = k14.group_collect_merge(order, starts, sel, maps_t, 64, halves=2, in_cap=4)
    want = k14.group_collect_merge_plain(order, starts, sel, maps_t, 64, 2, 1, 4)
    torch.cuda.synchronize()
    assert _bits_equal(got, want)


def test_sketch_opcodes_match_plain():
    """K12's hll_card (a warp per row), kmv_card and sd_pair over seeded
    sketches: empty, sparse, full and past 64 hashes."""
    from presto_tpu_torch.kernels import container_eval as k12
    from presto_tpu_torch.kernels import group_topn as k15
    from presto_tpu_torch.kernels import kmv_lanes as k16

    dev = _cuda()
    rng = np.random.default_rng(1203)
    n, m = 3000, 512
    hll = np.full((n, 1 + 2 * m), -(1 << 63), np.int64)
    cnt = rng.integers(0, m + 1, n)
    cnt[:3] = [0, 1, m]
    hll[:, 0] = cnt
    j = np.arange(m)[None, :]
    hll[:, 1:1 + m] = np.where(j < cnt[:, None], j, -(1 << 63))
    hll[:, 1 + m:] = np.where(j < cnt[:, None], rng.integers(1, 30, (n, m)), -(1 << 63))
    hv = torch.from_numpy(rng.random(n) >= 0.1).to(dev)
    a = torch.from_numpy(hll).to(dev)
    got = k12.container_eval(k12.HLL_CARD, a, hv)
    want = k12.plain(k12.HLL_CARD, a, hv)
    torch.cuda.synchronize()
    assert all(_bits_equal(x, y) for x, y in zip(got, want))
    digests = []
    for seed in (1, 2):
        r = np.random.default_rng(seed)
        e = 200_000
        g = torch.from_numpy(r.integers(0, n, e)).to(dev)
        h = torch.from_numpy(r.integers(0, 90_000, e) * 1_000_003_001).to(dev)
        perm, starts = k15.sorted_entries(g, h, torch.ones(e, dtype=torch.bool, device=dev), n)
        digests.append(k16.kmv_lanes(perm, g, h, None, starts, 64)[0])
    da, db = digests
    got = k12.container_eval(k12.KMV_CARD, da, hv)
    want = k12.plain(k12.KMV_CARD, da, hv)
    torch.cuda.synchronize()
    assert all(_bits_equal(x, y) for x, y in zip(got, want))
    for mode in (k12.SD_JACCARD, k12.SD_INTERSECTION):
        got = k12.container_eval(k12.SD_PAIR, da, hv, b=db, bv=hv, p=[mode])
        want = k12.plain(k12.SD_PAIR, da, hv, b=db, bv=hv, p=[mode])
        torch.cuda.synchronize()
        assert all(_bits_equal(x, y) for x, y in zip(got, want))


TWELFTH_SLICE_SQL = [
    "select l_suppkey, max(l_extendedprice, 5), min(l_extendedprice, 5) from lineitem "
    "group by l_suppkey order by l_suppkey",
    "select l_returnflag, l_linestatus, max_by(l_orderkey, l_extendedprice, 10), "
    "min_by(l_orderkey, l_quantity, 3) from lineitem group by 1, 2 order by 1, 2",
    "select o_orderpriority, cardinality(approx_set(o_custkey)) from orders group by 1 "
    "order by 1",
    "select cardinality(merge(s)) from (select o_orderpriority, approx_set(o_custkey) s "
    "from orders group by 1)",
    "select l_shipmode, cardinality(make_set_digest(l_partkey)) from lineitem group by 1 "
    "order by 1",
    "select jaccard_index(a, b), intersection_cardinality(a, b) from (select "
    "make_set_digest(l_suppkey) a from lineitem where l_shipmode = 'AIR'), (select "
    "make_set_digest(l_suppkey) b from lineitem where l_shipmode = 'RAIL')",
    "select l_returnflag, multimap_agg(l_shipmode, l_linenumber) from lineitem group by 1 "
    "order by 1",
    "select l_returnflag, map_union(m) from (select l_returnflag, l_suppkey % 50 g, "
    "map_agg(l_linenumber, l_quantity) m from lineitem group by 1, 2) group by 1 order by 1",
    "select max(o_totalprice, 3), max_by(o_orderkey, o_totalprice, 2), "
    "cardinality(make_set_digest(o_custkey)) from orders",
]


def test_twelfth_slice_on_the_card_equals_the_cpu_run():
    """The sketch and heap aggregates through SQL at sf 0.01 on the card
    (K15, K16, K14's new modes, K12's sketch opcodes), equal to the CPU
    run."""
    _cuda()
    from presto_tpu_torch.kernels import container_eval as k12
    from presto_tpu_torch.kernels import group_collect as k14
    from presto_tpu_torch.kernels import group_topn as k15
    from presto_tpu_torch.kernels import kmv_lanes as k16
    from presto_tpu_torch.runner import QueryRunner
    from presto_tpu_torch.testing import tpch_catalog

    gpu = QueryRunner(tpch_catalog(sf=0.01), device="cuda")
    cpu = QueryRunner(tpch_catalog(sf=0.01), device="cpu")
    k12.op_launches.clear()
    before = (k15.launches, k15.merge_launches, k16.launches, k16.merge_launches,
              k14.wide_launches, k14.union_launches)
    for sql in TWELFTH_SLICE_SQL:
        got, want = gpu.execute(sql).rows, cpu.execute(sql).rows
        assert got == want and got, sql
    assert {"hll_card", "kmv_card", "sd_pair"} <= set(k12.op_launches)
    assert all(x > y for x, y in zip((k15.launches, k15.merge_launches, k16.launches,
                                      k16.merge_launches, k14.wide_launches,
                                      k14.union_launches), before))


# -- the thirteenth slice: DECIMAL(37..38) ----------------------------------------

def _d38_limbs(rng, n: int, digits: int = 38, signed: bool = True) -> np.ndarray:
    """(n, 5) canonical wide limbs of values of 1 to ``digits`` digits, a
    tenth of them +-(10^38 - 1) or a limb boundary 10^(9k) +- 1, signed
    or not (vectorised: a card test's pages hold 2^20 rows)."""
    from presto_tpu_torch.ops import decimal128 as d128

    limbs = rng.integers(0, 10 ** 9, (n, 5))
    d = rng.integers(1, digits + 1, n)
    for j in range(5):  # limb j holds the digits 9 (4 - j) and up
        limbs[:, j] %= 10 ** np.clip(d - 9 * (4 - j), 0, 9)
    edges = [e for e in [10 ** 38 - 1, 0, 1] + [10 ** (9 * k) + x for k in (1, 2, 3, 4)
                                                 for x in (-1, 1)] if e < 10 ** digits]
    table = d128.encode_py(edges, len(edges), 5)
    pick = rng.random(n) < 0.1
    limbs[pick] = table[rng.integers(0, len(edges), int(pick.sum()))]
    t = torch.from_numpy(limbs)
    if signed:
        t = torch.where(torch.from_numpy(rng.random(n) < 0.5)[:, None], d128.neg(t), t)
    return t.numpy()


def _d38_page(n: int, seed: int, device) -> Page:
    """Wide columns (signed, non-negative, small), a short and a long
    decimal, a bigint, a double and a small group key, with NULLs and
    dead rows."""
    from presto_tpu_torch.ops import decimal128 as d128

    rng = np.random.default_rng(seed)
    long = d128.narrow_long(torch.from_numpy(_d38_limbs(rng, n, digits=30))).numpy()
    data = [_d38_limbs(rng, n), _d38_limbs(rng, n, signed=False),
            _d38_limbs(rng, n, digits=20, signed=False),
            rng.integers(-10 ** 9, 10 ** 9, n), long,
            rng.integers(-10 ** 6, 10 ** 6, n), rng.normal(size=n) * 1e6,
            rng.integers(0, 12, n)]
    types = ["decimal(38,2)", "decimal(38,2)", "decimal(38,4)", "decimal(12,2)",
             "decimal(36,4)", "bigint", "double", "bigint"]
    blocks = [Block(torch.from_numpy(np.ascontiguousarray(d)).to(device),
                    torch.from_numpy(rng.random(n) >= 0.1).to(device), parse_type(t))
              for d, t in zip(data, types)]
    return Page(tuple(blocks), torch.from_numpy(rng.random(n) >= 0.1).to(device))


_WN, _WP, _WQ = _col(0, "decimal(38,2)"), _col(1, "decimal(38,2)"), _col(2, "decimal(38,4)")
_S13, _L13, _B13, _X13 = (_col(3, "decimal(12,2)"), _col(4, "decimal(36,4)"),
                          _col(5, "bigint"), _col(6, "double"))
SLICE13_EXPRS = [
    _call("add", "decimal(38,2)", _WN, _WP), _call("sub", "decimal(38,2)", _WN, _S13),
    _call("add", "decimal(38,4)", _WN, _L13), _call("neg", "decimal(38,2)", _WN),
    _call("abs", "decimal(38,2)", _WN), _call("sign", "bigint", _WN),
    _call("mul", "decimal(38,6)", _WQ, _S13), _call("mul", "decimal(38,2)", _B13, _WN),
    _call("lt", "boolean", _WN, _WP), _call("ge", "boolean", _WQ, _S13),
    _call("eq", "boolean", _WN, _L13), _call("cast_double", "double", _WN),
    _call("cast_bigint", "bigint", _WQ), _call("cast_decimal", "decimal(12,2)", _WQ),
    _call("cast_decimal", "decimal(38,0)", _WN),
    _call("cast_decimal", "decimal(38,30)", _WN),  # past 45 digits: wraps
    _call("cast_decimal", "decimal(36,4)", _WQ), _call("cast_decimal", "decimal(38,2)", _X13),
    _call("cast_decimal", "decimal(38,6)", _S13),
    _call("greatest", "decimal(38,2)", _WN, _WP), _call("least", "decimal(38,2)", _WN, _WP),
    _call("coalesce", "decimal(38,2)", _WN, _WP),
    _call("case", "decimal(38,2)", _call("gt", "boolean", _B13, _lit(0, "bigint")), _WN,
          _call("neg", "decimal(38,2)", _WP)),
    _call("add", "decimal(38,4)", _WP, _lit(1234567890123456780000, "decimal(22,4)")),
    _call("gt", "boolean", _WN, _lit(12345678901234567890123456789012345678,
                                     "decimal(38,2)")),
]


@pytest.mark.parametrize("i", range(len(SLICE13_EXPRS)))
def test_expr_eval_d38_opcodes_match_plain(i):
    """K1's five-limb instance (D38 opcodes, LIT_LONG) against the twin on
    the card, bit for bit, the wraps included."""
    dev = _cuda()
    page = _d38_page(1 << 18, 1300 + i, dev)
    prog, cols = ExprCompiler.for_page(page).lower(SLICE13_EXPRS[i])
    assert prog.limbs == 5
    ins = [(page.blocks[c].data, page.blocks[c].valid) for c in cols]
    got = k1.expr_eval(prog, ins, page.capacity)
    want = k1.expr_eval_plain(prog, ins, page.capacity)
    torch.cuda.synchronize()
    assert _equal(got, want)
    if SLICE13_EXPRS[i].type.name == "boolean":
        assert torch.equal(k1.expr_eval(prog, ins, page.capacity, row_mask=page.row_mask),
                           k1.expr_eval_plain(prog, ins, page.capacity, row_mask=page.row_mask))


def _d38_args(page):
    b = page.blocks
    return [(k2.SUM_D38, b[0].data, b[0].valid), (k2.MIN_D38, b[0].data, b[0].valid),
            (k2.MAX_D38, b[1].data, b[1].valid), (k2.SUM_D38, b[2].data, b[2].valid),
            (k2.COUNT, b[0].valid, b[0].valid)]


@pytest.mark.parametrize("slots", [1, 13, 16384])
def test_packed_group_agg_d38_states_match_plain(slots):
    """K2's wide sum, min and max (five phased launches for the
    extremes), global, in shared memory and in the device table."""
    dev = _cuda()
    page = _d38_page(1 << 20, 1400 + slots, dev)
    b = page.blocks
    keys = [] if slots == 1 else [(b[7].data, b[7].valid, 0, 13)] if slots == 13 else \
        [(torch.remainder(b[5].data, 16383), b[5].valid, 0, 16384)]
    args = _d38_args(page)
    got = k2.packed_group_agg(page.capacity, page.row_mask, keys, args, slots)
    want = k2.packed_group_agg_plain(page.capacity, page.row_mask, keys, args, slots)
    torch.cuda.synchronize()
    assert _equal(got, want)


@pytest.mark.parametrize("presorted", [False, True])
def test_sorted_group_agg_d38_states_match_plain(presorted):
    """K6's wide sum, min and max over sorted runs, and its merge of
    wide partial states."""
    dev = _cuda()
    page = _d38_page(1 << 20, 1500 + presorted, dev)
    b = page.blocks
    keys = [(b[7].data, b[7].valid, 0, 0)] if presorted else [(b[5].data, b[5].valid, 0, 0)]
    states = [(k6.S_LIMBS_D38, b[0].data, b[0].valid), (k6.S_MIN_D38, b[0].data, b[0].valid),
              (k6.S_MAX_D38, b[1].data, b[1].valid), (k6.S_VALID, None, b[0].valid)]
    got = k6.sorted_group_agg(keys, page.row_mask, states, presorted)
    want = k6.sorted_group_agg_plain(keys, page.row_mask, states, presorted)
    torch.cuda.synchronize()
    assert got[2] == want[2] > 10
    assert _equal(got[:2], want[:2])
    # the merge: the partials' wide sums and extremes, live where counted
    g = got[2]
    live = got[1][3] > 0
    mkeys = [(torch.remainder(got[0][0][0], 7), got[0][0][1], 0, 0)]
    mstates = [(k6.S_LIMBS_D38, got[1][0], live), (k6.S_MIN_D38, got[1][1], live),
               (k6.S_SUM, got[1][3], torch.ones(g, dtype=torch.bool, device=dev))]
    mask = torch.ones(g, dtype=torch.bool, device=dev)
    assert _equal(k6.sorted_group_agg(mkeys, mask, mstates)[:2],
                  k6.sorted_group_agg_plain(mkeys, mask, mstates)[:2])


def test_packed_fold_finalize_d38_match_plain():
    """K3's wide fold (limb sums, lexicographic min/max) and its wide sum
    and HALF_UP avg finalizes."""
    dev = _cuda()
    tables = []
    for seed in (1601, 1602):
        page = _d38_page(1 << 18, seed, dev)
        b = page.blocks
        args = [(k2.SUM_D38, b[0].data, b[0].valid), (k2.MIN_D38, b[0].data, b[0].valid),
                (k2.MAX_D38, b[1].data, b[1].valid)]
        tables.append(k2.packed_group_agg(page.capacity, page.row_mask,
                                          [(b[7].data, b[7].valid, 0, 13)], args, 13))
    kinds = [k3.COL_D38, k3.COL_I64, k3.COL_MIN_D38, k3.COL_I64, k3.COL_MAX_D38, k3.COL_I64]

    def cols(states, present):
        return [(k, t, present) for k, t in zip(kinds, [t for st in states for t in st])]

    got = k3.packed_fold(cols(*tables[0]), cols(*tables[1]), tables[0][1], tables[1][1])
    want = k3.packed_fold_plain(cols(*tables[0]), cols(*tables[1]), tables[0][1],
                                tables[1][1])
    assert _equal(got, want)
    f = [d for d, _ in got[0]]
    items = [(k3.FIN_SUM_D38, f[0], f[1]), (k3.FIN_AVG_D38, f[0], f[1]),
             (k3.FIN_SUM_D38, f[2], f[3])]
    got = k3.packed_finalize(items, got[1])
    want = k3.packed_finalize_plain(items, want[1])
    torch.cuda.synchronize()
    assert _equal(got, want)


@pytest.mark.parametrize("n", [10, 100])
def test_topn_d38_key_matches_plain(n):
    """K7 over a wide key, ascending and descending, NULLs first or last."""
    dev = _cuda()
    page = _d38_page(1 << 20, 1700 + n, dev)
    b = page.blocks
    for keys in ([(b[0].data, b[0].valid, False, False), (b[5].data, b[5].valid, True, True)],
                 [(b[1].data, b[1].valid, True, True)]):
        got, want = k7.topn(keys, page.row_mask, n), k7.topn_plain(keys, page.row_mask, n)
        torch.cuda.synchronize()
        assert _equal(list(got), list(want))


def test_thirteenth_slice_on_the_card_equals_the_cpu_run():
    """The smoke's D38 queries at sf 0.01 over lineitem_d38 on the card
    (K1's D38 instance, K2/K3/K6's wide states, K7's wide key), equal to
    the CPU run."""
    _cuda()
    import chip_smoke
    from presto_tpu_torch.catalog import Catalog
    from presto_tpu_torch.connectors.memory import MemoryConnector
    from presto_tpu_torch.connectors.tpch import Tpch
    from presto_tpu_torch.runner import QueryRunner

    runners = {}
    for device in ("cuda", "cpu"):
        mem = MemoryConnector(device=device)
        for t in ("lineitem", "orders"):
            mem.load_from(Tpch(sf=0.01, split_rows=1 << 14), t)
        chip_smoke.make_lineitem_d38(mem)
        catalog = Catalog()
        catalog.register("tpch", mem)
        runners[device] = QueryRunner(catalog, device=device)
    k1.op_launches.clear()
    k2.kind_launches.clear()
    k6.kind_launches.clear()
    before = k7.d38_launches
    for sql in chip_smoke.D38_QUERIES.values():
        got, want = runners["cuda"].execute(sql).rows, runners["cpu"].execute(sql).rows
        assert got == want and got, sql
    assert k1.op_launches.get("d38") and k2.kind_launches.get("d38")
    assert k6.kind_launches.get("d38") and k7.d38_launches > before


# -- the fourteenth slice: raw (non-dictionary) VARCHAR values ----------------

RAW_EDGES = ["", "a", "ab", "héllo wörld", "ÀÉÎÕÜ mixed", "日本語テスト", "naïve café",
             "ß÷×Þþ", "😀 emoji", "Customer#000000001", "Customer#000000002", "abc%_x",
             "zzzzzzzzzzzzzzzzzzzzzzzz"]


def _raw_rows(n: int, width: int, seed: int, device):
    """(n, width) byte rows: the edge strings (some cut at the width) and
    random ASCII words, and a validity mask."""
    from presto_tpu_torch.ops.rawstring import encode_strings

    rng = np.random.default_rng(seed)
    words = np.array(["alpha", "Bravo", "charlie", "é", "日本", "x", ""], dtype=object)
    vals = [RAW_EDGES[i % len(RAW_EDGES)] if i % 3 == 0 else
            " ".join(rng.choice(words, rng.integers(0, 5))) for i in range(n)]
    data = torch.from_numpy(encode_strings(vals, width)).to(device)
    return data, torch.from_numpy(rng.random(n) >= 0.1).to(device)


def _k17_cases(a, b, lits, mask):
    from presto_tpu_torch.kernels import raw_string_eval as k17
    from presto_tpu_torch.ops.rawstring import code_points, like_tokens

    out = [(k17.CMP, dict(b=b, op=op)) for op in k17.CMP_OPS]
    out += [(k17.CMP, dict(b=lits[:1], op="lt")), (k17.IN, dict(b=lits)),
            (k17.SUBSTR, dict(start=2, length=3, flag=True)),
            (k17.SUBSTR, dict(start=3, flag=True)),
            (k17.SUBSTR, dict(start=2, length=3)), (k17.CASE_MAP, dict(flag=True)),
            (k17.CASE_MAP, dict(flag=False)), (k17.CONCAT, dict(b=b)),
            (k17.CONCAT, dict(b=lits[:1])), (k17.LEN, dict(flag=True)), (k17.LEN, {}),
            (k17.CODEPOINT, {}), (k17.PACK, {}), (k17.HASH, {}),
            (k17.SELECT, dict(b=b, mask=mask, width=a.shape[1] + 3))]
    for needle in ("a", "日本", "é", "", "Customer#"):
        out += [(k17.STRPOS, dict(tokens=code_points(needle))),
                (k17.PREFIX, dict(tokens=code_points(needle))),
                (k17.SUFFIX, dict(tokens=code_points(needle)))]
    for pat in ("%", "a%", "%a%", "_", "%日_%", "C%#%1", "%special%requests%", "__%é"):
        out.append((k17.LIKE, dict(tokens=like_tokens(pat))))
    return out


@pytest.mark.parametrize("width", [8, 25, 79])
def test_raw_string_eval_modes_match_plain(width):
    """Every K17 mode against its twin on the card, bit for bit: two
    widths in one comparison, literal rows, multibyte characters cut at
    the width."""
    from presto_tpu_torch.kernels import raw_string_eval as k17
    from presto_tpu_torch.ops.rawstring import literal_rows

    dev = _cuda()
    a, _ = _raw_rows(1 << 16, width, 1800 + width, dev)
    b, mask = _raw_rows(1 << 16, 15, 1900 + width, dev)
    lits = literal_rows(RAW_EDGES[:6], width, dev)
    for mode, kw in _k17_cases(a, b, lits, mask):
        got = k17.raw_string_eval(mode, a, **kw)
        want = k17.raw_string_eval(mode, a.cpu(), **{
            k: v.cpu() if isinstance(v, torch.Tensor) else v for k, v in kw.items()})
        torch.cuda.synchronize()
        assert _equal(got.cpu(), want), (k17.MODE_NAMES[mode], kw.get("op"), kw.get("tokens"))
    lanes = k17.raw_string_eval(k17.PACK, a)
    assert torch.equal(k17.raw_string_eval(k17.UNPACK, lanes, width=width), a)


@pytest.mark.parametrize("slots", [1, 13, 16384])
def test_packed_group_agg_raw_extremes_match_plain(slots):
    """K2's raw extremes (k phased launches over the lanes) beside a
    count, global and grouped."""
    from presto_tpu_torch.ops.rawstring import pack_lanes

    dev = _cuda()
    page = _page(1 << 18, 2000 + slots, dev)
    a, v = _raw_rows(1 << 18, 25, 2010 + slots, dev)
    lanes = pack_lanes(a)
    b = page.blocks
    keys = [] if slots == 1 else [(torch.remainder(b[2].data, 13), b[2].valid, 0, 13)] \
        if slots == 13 else [(torch.remainder(b[2].data, 16383), b[2].valid, 0, 16384)]
    args = [(k2.MIN_LANES, lanes, v), (k2.COUNT, v, v), (k2.MAX_LANES, lanes, v)]
    got = k2.packed_group_agg(page.capacity, page.row_mask, keys, args, slots)
    want = k2.packed_group_agg_plain(page.capacity, page.row_mask, keys, args, slots)
    torch.cuda.synchronize()
    assert _equal(got, want)


@pytest.mark.parametrize("presorted", [False, True])
def test_sorted_group_agg_raw_extremes_match_plain(presorted):
    """K6's raw extremes, one warp a run, beside the other states, and a
    raw key through the hash lane (K17 HASH, then K9)."""
    from presto_tpu_torch.ops.rawstring import hash_bytes, pack_lanes

    dev = _cuda()
    page = _page(1 << 18, 2100 + presorted, dev)
    a, v = _raw_rows(1 << 18, 40, 2110 + presorted, dev)
    b = page.blocks
    keys = [(torch.remainder(b[2].data, 1000), b[2].valid, 0, 0)] if presorted else \
        [(hash_bytes(a), v, 0, 0)]
    lanes = pack_lanes(a)
    states = [(k6.S_MIN_LANES, lanes, v), (k6.S_VALID, None, v), (k6.S_MAX_LANES, lanes, v)]
    got = k6.sorted_group_agg(keys, page.row_mask, states, presorted, runs=True)
    want = k6.sorted_group_agg_plain(keys, page.row_mask,
                                     [states[1]], presorted, runs=True)
    torch.cuda.synchronize()
    assert got[2] == want[2] > 10
    order, starts = want[3]
    for i, s in ((0, states[0]), (2, states[2])):
        assert torch.equal(got[1][i], k6.lane_extremes_plain(order, starts, lanes, v,
                                                             s[0] == k6.S_MIN_LANES))
    assert torch.equal(got[1][1], want[1][0])


@pytest.mark.parametrize("n", [10, 100])
def test_topn_raw_key_matches_plain(n):
    """K7 over a raw key's lanes (k = 2, 4, 10), ascending and descending."""
    from presto_tpu_torch.ops.rawstring import pack_lanes

    dev = _cuda()
    page = _page(1 << 18, 2200 + n, dev)
    for width in (15, 25, 79):
        a, v = _raw_rows(1 << 18, width, 2210 + width, dev)
        lanes = pack_lanes(a)
        for keys in ([(lanes, v, True, False)],
                     [(lanes, v, False, True), (page.blocks[2].data, page.blocks[2].valid,
                                                True, False)]):
            got = k7.topn(keys, page.row_mask, n)
            want = k7.topn_plain(keys, page.row_mask, n)
            torch.cuda.synchronize()
            assert _equal(list(got), list(want))


def test_window_eval_raw_order_key_matches_plain():
    """K10's peer groups over a raw order key's lanes (rank, dense_rank)."""
    from presto_tpu_torch.ops.rawstring import pack_lanes

    dev = _cuda()
    n = 1 << 16
    a, v = _raw_rows(n, 25, 2300, dev)
    lanes = pack_lanes(a)
    row_mask = torch.ones(n, dtype=torch.bool, device=dev)
    perm = torch.arange(n, device=dev)
    for j in range(lanes.shape[1] - 1, -1, -1):
        perm = perm[torch.argsort(lanes[perm, j], stable=True)]
    pkey = torch.zeros(n, dtype=torch.int64, device=dev)
    funcs = [k10.Func(k10.RANK, k10.FRAME_PEERS, None, None, 0, False, None),
             k10.Func(k10.DENSE_RANK, k10.FRAME_PEERS, None, None, 0, False, None)]
    ins = (perm, row_mask, pkey, [(lanes, v)], funcs, [None, None])
    got = k10.window_eval(*ins)
    want = k10.window_eval_plain(*ins)
    torch.cuda.synchronize()
    assert _equal(got, want)


def test_window_eval_lanes_order_keys_and_arguments_match_plain():
    """K10 over (n, k) int64 lanes: a long decimal's two limbs and a raw
    key's four lanes as order keys, the limbs as the value functions'
    argument (copied lane by lane)."""
    from presto_tpu_torch.ops.rawstring import pack_lanes

    dev = _cuda()
    n = 1 << 16
    rng = np.random.default_rng(2310)
    limbs = torch.from_numpy(rng.integers(-3, 3, (n, 2))).to(dev).contiguous()
    lv = torch.from_numpy(rng.random(n) >= 0.1).to(dev)
    a, v = _raw_rows(n, 25, 2311, dev)
    lanes = pack_lanes(a)
    row_mask = torch.from_numpy(rng.random(n) >= 0.05).to(dev)
    pkey = torch.from_numpy(rng.integers(0, 7, n)).to(dev)
    perm = torch.arange(n, device=dev)
    for key in [lanes[:, j] for j in range(3, -1, -1)] + [limbs[:, 1], limbs[:, 0], pkey]:
        perm = perm[torch.argsort(key[perm], stable=True)]
    funcs = [k10.Func(k10.RANK, k10.FRAME_PEERS), k10.Func(k10.LEAD, offset=1),
             k10.Func(k10.LAG, offset=2, ignore_nulls=True),
             k10.Func(k10.FIRST_VALUE, k10.FRAME_ROWS, -3, 1),
             k10.Func(k10.NTH_VALUE, k10.FRAME_PEERS, offset=2)]
    args = [None] + [(limbs, lv)] * 4
    ins = (perm, row_mask, pkey, [(limbs, lv), (lanes, v)], funcs, args)
    got = k10.window_eval(*ins)
    want = k10.window_eval_plain(*ins)
    torch.cuda.synchronize()
    for (gd, gv), (wd, wv) in zip(got, want):
        assert torch.equal(gv, wv) and torch.equal(gd[wv], wd[wv])


def test_fourteenth_slice_on_the_card_equals_the_cpu_run():
    """The smoke's raw queries at sf 0.01 over the raw copies of TPC-H's
    text columns on the card (K17's modes, the raw K2/K6/K7/K10 modes,
    raw keys through the hash lane), equal to the CPU run."""
    _cuda()
    import chip_smoke
    from presto_tpu_torch.catalog import Catalog
    from presto_tpu_torch.connectors.memory import MemoryConnector
    from presto_tpu_torch.connectors.tpch import Tpch
    from presto_tpu_torch.kernels import raw_string_eval as k17
    from presto_tpu_torch.runner import QueryRunner

    runners = {}
    for device in ("cuda", "cpu"):
        mem = MemoryConnector(device=device)
        for t in ("lineitem", "orders", "customer", "part", "partsupp", "supplier", "nation"):
            mem.load_from(Tpch(sf=0.01, split_rows=1 << 14), t)
        chip_smoke.make_raw_tables(mem)
        catalog = Catalog()
        catalog.register("tpch", mem)
        runners[device] = QueryRunner(catalog, device=device)
    k17.mode_launches.clear()
    k2.kind_launches.clear()
    k6.kind_launches.clear()
    before = k7.lanes_launches
    for sql in chip_smoke.RAW_QUERIES.values():
        got, want = runners["cuda"].execute(sql).rows, runners["cpu"].execute(sql).rows
        assert got == want and got, sql
    assert {"like", "hash", "pack", "in", "substr"} <= set(k17.mode_launches)
    assert k2.kind_launches.get("lanes") and k6.kind_launches.get("lanes")
    assert k7.lanes_launches > before


# -- the fifteenth slice: K18 geo_contains, K19 ml_state, K20 ml_finalize,
# -- K12's REGRESS and CLASSIFY ------------------------------------------------

def _star_wkt(rng, cx, cy, r, nv, hole=False):
    ang = np.sort(rng.uniform(0, 2 * np.pi, nv))
    rad = r * rng.uniform(0.5, 1.0, nv)
    pts = [(cx + a * np.cos(t), cy + a * np.sin(t)) for a, t in zip(rad, ang)]
    ring = ", ".join(f"{float(x)!r} {float(y)!r}" for x, y in pts + pts[:1])
    if not hole:
        return f"POLYGON (({ring}))"
    h = [(cx + 0.2 * r * np.cos(t), cy + 0.2 * r * np.sin(t)) for t in np.linspace(0, 6, 7)]
    inner = ", ".join(f"{float(x)!r} {float(y)!r}" for x, y in h + h[:1])
    return f"POLYGON (({ring}), ({inner}))"


@pytest.mark.parametrize("literal", [True, False])
def test_geo_contains_matches_plain(literal):
    dev = _cuda()
    from presto_tpu_torch import geo
    from presto_tpu_torch.kernels import geo_contains as k18

    rng = np.random.default_rng(15)
    wkts = [_star_wkt(rng, rng.uniform(10, 90), rng.uniform(10, 90), 12, nv, nv % 3 == 0)
            for nv in (5, 64, 300, 3000)]
    wkts += ["POINT (50 50)", "MULTIPOLYGON (((0 0, 10 0, 10 10, 0 10, 0 0)), "
             "((20 20, 30 20, 30 30, 20 30, 20 20)))", "not wkt"]
    n = 200_000
    x = torch.from_numpy(rng.uniform(0, 100, n))
    y = torch.from_numpy(rng.uniform(0, 100, n))
    x[:7], y[:7] = 50.0, 50.0  # the POINT's own coordinates
    if literal:
        table, code = geo.GeometryTable([geo.parse_wkt(wkts[3])]), None
    else:
        table = geo.GeometryTable([geo.parse_or_none(w) for w in wkts])
        code = torch.from_numpy(rng.integers(-1, len(wkts) + 1, n).astype(np.int32))
    want = k18.geo_contains(table, x, y, code)
    got = k18.geo_contains(table, x.to(dev), y.to(dev), None if code is None else code.to(dev))
    torch.cuda.synchronize()
    assert torch.equal(got[1].cpu(), want[1]) and torch.equal(got[0].cpu(), want[0])
    assert bool(want[0].any())


def _ml_inputs(rng, n, k, dtype=torch.float64):
    feats = torch.from_numpy(rng.normal(0, 3, (n, 1 + k)))
    feats[:, 0] = k
    feats[rng.random((n, 1 + k)) < 0.05] = float("nan")
    feats[:, 0] = k
    if dtype != torch.float64:
        feats = torch.from_numpy(rng.integers(-50, 50, (n, 1 + k))).to(dtype)
        feats[:, 0] = k
    label = torch.from_numpy(rng.integers(-1, 10, n))
    y = torch.from_numpy(rng.normal(0, 10, n))
    sel = torch.from_numpy(rng.random(n) >= 0.1)
    return feats, label, y, sel


@pytest.mark.parametrize("mode", [0, 1, 2])
@pytest.mark.parametrize("runs", [False, True])
def test_ml_state_matches_plain(mode, runs):
    dev = _cuda()
    from presto_tpu_torch.kernels import ml_state as k19

    rng = np.random.default_rng(19 + mode)
    n, k, groups = 300_000, 3, 12
    feats, label, y, sel = _ml_inputs(rng, n, k)
    kw = dict(k=k, feats=feats, y=y) if mode == k19.REGRESSOR else \
        dict(k=k, feats=feats, label=label) if mode == k19.CLASSIFIER else \
        dict(label=torch.stack([label, torch.from_numpy(rng.integers(-1, 9, n))], 1))
    if runs:
        g = torch.from_numpy(rng.integers(0, 5000, n))
        order = torch.argsort(g, stable=True)
        counts = torch.bincount(g, minlength=5000)
        starts = torch.cat([torch.zeros(1, dtype=torch.int64), torch.cumsum(counts, 0)])
        addr, groups = dict(order=order, starts=starts), 5000
    else:
        slot = torch.from_numpy(rng.integers(0, groups + 2, n))
        addr = dict(slot=slot)
    want = k19.ml_state(mode, groups, sel, **kw, **addr)
    got = k19.ml_state(mode, groups, sel.to(dev), **{a: t.to(dev) if torch.is_tensor(t) else t
                                                    for a, t in {**kw, **addr}.items()})
    torch.cuda.synchronize()
    assert torch.equal(got[1].cpu(), want[1])
    assert torch.equal(got[0].cpu(), want[0]), (got[0].cpu() - want[0]).abs().max()
    # the merge of the partials, over runs of two
    both = torch.cat([want[0], want[0].flip(0)]).reshape(2, groups, -1).transpose(0, 1)
    parts = both.reshape(2 * groups, -1).contiguous()
    cnts = torch.stack([want[1], want[1].flip(0)], 1).reshape(-1)
    live = cnts > 0
    st = torch.arange(0, 2 * groups + 1, 2)
    mmode = k19.MERGE_I64 if mode == k19.EVALUATE else k19.MERGE
    mw = k19.ml_state(mmode, groups, live, parts=parts, counts=cnts, starts=st)
    mg = k19.ml_state(mmode, groups, live.to(dev), parts=parts.to(dev), counts=cnts.to(dev),
                      starts=st.to(dev))
    torch.cuda.synchronize()
    assert torch.equal(mg[0].cpu(), mw[0]) and torch.equal(mg[1].cpu(), mw[1])


@pytest.mark.parametrize("dtype", [torch.int32, torch.int64])
def test_ml_state_integer_features_match_plain(dtype):
    dev = _cuda()
    from presto_tpu_torch.kernels import ml_state as k19

    rng = np.random.default_rng(29)
    feats, label, y, sel = _ml_inputs(rng, 50_000, 2, dtype)
    want = k19.ml_state(k19.REGRESSOR, 1, sel, k=2, feats=feats, y=y)
    got = k19.ml_state(k19.REGRESSOR, 1, sel.to(dev), k=2, feats=feats.to(dev), y=y.to(dev))
    torch.cuda.synchronize()
    assert torch.equal(got[0].cpu(), want[0]) and torch.equal(got[1].cpu(), want[1])


@pytest.mark.parametrize("mode", [0, 1])
def test_ml_finalize_matches_plain(mode):
    dev = _cuda()
    from presto_tpu_torch.kernels import ml_finalize as k20
    from presto_tpu_torch.kernels import ml_state as k19

    rng = np.random.default_rng(20 + mode)
    k = 3
    feats, label, y, sel = _ml_inputs(rng, 100_000, k)
    g = torch.from_numpy(rng.integers(0, 2000, 100_000))
    order = torch.argsort(g, stable=True)
    starts = torch.cat([torch.zeros(1, dtype=torch.int64),
                        torch.cumsum(torch.bincount(g, minlength=2000), 0)])
    smode = k19.REGRESSOR if mode == k20.REGRESSOR else k19.CLASSIFIER
    state, _ = k19.ml_state(smode, 2000, sel, k=k, feats=feats, y=y, label=label, order=order,
                            starts=starts)
    want = k20.ml_finalize(mode, state, k)
    got = k20.ml_finalize(mode, state.to(dev), k)
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), want)


@pytest.mark.parametrize("fdtype", [torch.float64, torch.int64])
def test_regress_and_classify_opcodes_match_plain(fdtype):
    dev = _cuda()
    from presto_tpu_torch.kernels import container_eval as k12
    from presto_tpu_torch.kernels import ml_finalize as k20
    from presto_tpu_torch.kernels import ml_state as k19

    rng = np.random.default_rng(12)
    k, n = 3, 200_000
    feats, label, y, sel = _ml_inputs(rng, n, k, fdtype)
    g = torch.from_numpy(rng.integers(0, 50, n))
    order = torch.argsort(g, stable=True)
    starts = torch.cat([torch.zeros(1, dtype=torch.int64),
                        torch.cumsum(torch.bincount(g, minlength=50), 0)])
    models = {}
    for mode, smode in ((k20.REGRESSOR, k19.REGRESSOR), (k20.CLASSIFIER, k19.CLASSIFIER)):
        st, _ = k19.ml_state(smode, 50, sel, k=k, feats=feats, y=y, label=label, order=order,
                             starts=starts)
        models[mode] = k20.ml_finalize(mode, st, k)[g]
    mv = sel.clone()
    fv = torch.from_numpy(rng.random(n) >= 0.05)
    want = k12.container_eval(k12.REGRESS, models[0], mv, b=feats, bv=fv, p=[k, 8])
    got = k12.container_eval(k12.REGRESS, models[0].to(dev), mv.to(dev), b=feats.to(dev),
                             bv=fv.to(dev), p=[k, 8])
    torch.cuda.synchronize()
    assert torch.equal(got[1].cpu(), want[1]) and torch.equal(got[0].cpu(), want[0])
    want = k12.container_eval(k12.CLASSIFY, models[1], mv, b=feats, bv=fv, p=[k, 8, 1])
    got = k12.container_eval(k12.CLASSIFY, models[1].to(dev), mv.to(dev), b=feats.to(dev),
                             bv=fv.to(dev), p=[k, 8, 1])
    torch.cuda.synchronize()
    assert torch.equal(got[1].cpu(), want[1])
    ulp = (got[2].cpu() - want[2]).abs() / torch.abs(torch.nextafter(
        want[2], torch.full_like(want[2], float("inf"))) - want[2])
    assert float(ulp.max()) <= 2.0
    ll = k12.classify_ll_plain(models[1], feats, k, 8)
    top2 = torch.topk(ll, 2, 1).values
    ties = (top2[:, 0] - top2[:, 1]).abs() <= 4 * torch.abs(torch.nextafter(
        top2[:, 0], torch.full_like(top2[:, 0], float("inf"))) - top2[:, 0])
    assert torch.equal(got[0].cpu()[~ties], want[0][~ties])


def test_fifteenth_slice_on_the_card_equals_the_cpu_run():
    """The smoke's ML queries over TPC-H sf 0.01 and its geo queries over
    the zones and 1/256 of the trips on the card (K18, K19, K20, K12's
    REGRESS and CLASSIFY), equal to the CPU run (ml_evaluate's text
    exactly: sf 0.01 holds no near tie)."""
    _cuda()
    import chip_smoke
    from presto_tpu_torch.catalog import Catalog
    from presto_tpu_torch.connectors.memory import MemoryConnector
    from presto_tpu_torch.connectors.tpch import Tpch
    from presto_tpu_torch.kernels import container_eval as k12
    from presto_tpu_torch.kernels import geo_contains as k18
    from presto_tpu_torch.kernels import ml_finalize as k20
    from presto_tpu_torch.kernels import ml_state as k19
    from presto_tpu_torch.runner import QueryRunner

    runners = {}
    for device in ("cuda", "cpu"):
        mem = MemoryConnector(device=device)
        mem.load_from(Tpch(sf=0.01, split_rows=1 << 14), "lineitem")
        chip_smoke.make_geo_tables(mem, 256)
        catalog = Catalog()
        catalog.register("tpch", mem)
        runners[device] = QueryRunner(catalog, device=device)
    k19.mode_launches.clear()
    k20.mode_launches.clear()
    k12.op_launches.clear()
    before = k18.column_launches
    for sql in chip_smoke.ML_GEO_QUERIES.values():
        got, want = runners["cuda"].execute(sql).rows, runners["cpu"].execute(sql).rows
        assert got == want and got, sql
    assert {"regressor", "classifier", "evaluate", "merge", "merge_i64"} <= set(
        k19.mode_launches)
    assert {"regressor", "classifier"} <= set(k20.mode_launches)
    assert {"regress", "classify"} <= set(k12.op_launches)
    assert k18.column_launches > before


# -- the sixteenth slice: K21 exchange_partition, K22 merge_sorted ------------

def _mesh_cols(page):
    """The page's columns plus a two-limb decimal and a raw-lane matrix
    (the trailing widths K21 and K22 copy as rows)."""
    n = page.capacity
    g = torch.Generator(device="cpu").manual_seed(7)
    limbs = torch.randint(-10 ** 9, 10 ** 9, (n, 2), generator=g).to(page.device)
    raw = torch.randint(0, 256, (n, 24), dtype=torch.uint8, generator=g).to(page.device)
    cols = [(b.data, b.valid) for b in page.blocks]
    return cols + [(limbs, page.blocks[0].valid), (raw, page.blocks[1].valid)]


@pytest.mark.parametrize("n_parts", [1, 8, 13, 256])
@pytest.mark.parametrize("cap_share", [1.0, 0.5])
def test_exchange_partition_kernel_matches_plain(n_parts, cap_share):
    """K21's bucket layout, valid bits, mask and fill equal the twin's bit
    for bit, at a bucket_cap at the fill and at half of it (rows
    dropped), with dead rows and keys whose top bit is set."""
    from presto_tpu_torch.kernels import exchange_partition as k21

    dev = _cuda()
    page = _page((1 << 20) + 77, 181, dev)
    key = page.blocks[2].data.clone()
    key[::3] = key[::3] | (-(1 << 63))  # top bit set
    cols = _mesh_cols(page)
    fill = int(k21.targets_plain(key, page.row_mask, n_parts).to(torch.int64)
               .bincount(minlength=n_parts + 1)[:n_parts].max())
    cap = max(1, int(fill * cap_share))
    got = k21.exchange_partition(key, page.row_mask, n_parts, cap, cols)
    want = k21.partition_plain(key, None, page.row_mask, n_parts, cap, cols)
    torch.cuda.synchronize()
    assert int(got[2]) == int(want[2]) == fill
    assert torch.equal(got[1], want[1])
    for (gd, gv), (wd, wv) in zip(got[0], want[0]):
        assert torch.equal(gd, wd) and torch.equal(gv, wv)
    # given targets: partition_for_exchange's form
    t = k21.exchange_targets(key, page.row_mask, n_parts)
    assert torch.equal(t, k21.targets_plain(key, page.row_mask, n_parts))
    again = k21.exchange_partition(None, page.row_mask, n_parts, cap, cols, targets=t)
    torch.cuda.synchronize()
    assert torch.equal(again[1], want[1]) and int(again[2]) == fill
    for (gd, gv), (wd, wv) in zip(again[0], want[0]):
        assert torch.equal(gd, wd) and torch.equal(gv, wv)


@pytest.mark.parametrize("dups", [False, True])
def test_merge_sorted_kernel_matches_plain(dups):
    """K22's merged columns, mask and key equal the twin's bit for bit,
    with ties across the runs and dead rows at each run's tail."""
    from presto_tpu_torch.kernels import merge_sorted as k22

    dev = _cuda()
    runs = []
    for seed, n in ((191, (1 << 19) + 3), (192, (1 << 18) + 11)):
        page = _page(n, seed, dev)
        key = page.blocks[2].data.clone()
        if dups:
            key = key % 1000
        key = torch.where(page.row_mask, key, torch.full_like(key, I64_MAX))
        key, order = torch.sort(key, stable=True)
        cols = [(d[order], v[order]) for d, v in _mesh_cols(page)]
        runs.append((cols, page.row_mask[order], key))
    got = k22.merge_sorted(runs[0], runs[1])
    want = k22.merge_sorted_plain(runs[0], runs[1])
    torch.cuda.synchronize()
    assert torch.equal(got[1], want[1]) and torch.equal(got[2], want[2])
    for (gd, gv), (wd, wv) in zip(got[0], want[0]):
        assert torch.equal(gd, wd) and torch.equal(gv, wv)


# The seventeenth slice: K6 over its live rows only (compaction before the
# sort, the warp-tiled run reduction) and K7's radix select over an
# adaptive prefix, at scale against their twins (cases from
# test_torch_k6_k7_design.py, which imports no JAX).


def _equal_by_bits(got, want, what):
    if isinstance(got, torch.Tensor):
        assert got.dtype == want.dtype and got.shape == want.shape, what
        g = got.view(torch.int64) if got.dtype == torch.float64 else got
        w = want.view(torch.int64) if want.dtype == torch.float64 else want
        assert torch.equal(g, w), what
        return
    assert len(got) == len(want), what
    for i, (x, y) in enumerate(zip(got, want)):
        _equal_by_bits(x, y, f"{what}[{i}]")


@pytest.mark.parametrize("rows", [1 << 20, 1 << 21])
@pytest.mark.parametrize("presorted", [False, True])
@pytest.mark.parametrize("case", ["all_dead", "one_live", "long_run", "near_sentinel", "hashed",
                                  "mostly_dead", "all_live"])
def test_k6_live_rows_only_match_plain(case, presorted, rows):
    """Keys, states (doubles by their bits), ``order`` with its dead tail
    and ``starts`` equal the twin's over 2^20 rows (a page sorted whole)
    and 2^21 (compacted first, unless every row is live); the
    probe-shaped page, 1% live, at 2^22 and 2^23 rows."""
    from test_torch_k6_k7_design import _key_edge_cases, _states

    dev = _cuda()
    assert k6.SORT_WHOLE_ROWS == 1 << 20
    n = rows * (4 if case == "mostly_dead" else 1)
    rng = np.random.default_rng(170 + len(case) + presorted)
    keys, mask = _key_edge_cases()[case](rng, n)
    if presorted:
        perm = torch.argsort(keys[0][0], stable=True)
        keys = [(d[perm], v[perm], lo, card) for d, v, lo, card in keys]
        mask = mask[perm]
    keys = [(d.to(dev), v.to(dev), lo, card) for d, v, lo, card in keys]
    mask = mask.to(dev)
    states = [(kind, d.to(dev) if d is not None else None, v.to(dev) if v is not None else None)
              for kind, d, v in _states(rng, n)]
    got = k6.sorted_group_agg(keys, mask, states, presorted, runs=True)
    want = k6.sorted_group_agg_plain(keys, mask, states, presorted, runs=True)
    torch.cuda.synchronize()
    assert got[2] == want[2]
    _equal_by_bits(got[0], want[0], "keys")
    _equal_by_bits(got[1], want[1], "states")
    _equal_by_bits(got[3], want[3], "(order, starts)")


@pytest.mark.parametrize("n", [1, 10, 100])
@pytest.mark.parametrize("case", ["int_nulls_first_desc", "double_signed_zeros_nan", "real",
                                  "smallint_tinyint", "long_decimal", "wide_decimal",
                                  "raw_shared_prefix", "raw_many_lanes",
                                  "bool_first_heavy_ties", "full_range_ties", "cut_field",
                                  "flag_then_key"])
def test_k7_radix_select_matches_plain(case, n):
    from test_torch_k6_k7_design import _key_cases

    dev = _cuda()
    rows = 1 << 20
    rng = np.random.default_rng(171 + len(case))
    keys = [(d.to(dev), v.to(dev), a, nf) for d, v, a, nf in _key_cases()[case](rng, rows)]
    mask = torch.from_numpy(rng.random(rows) >= 0.1).to(dev)
    got = k7.topn(keys, mask, n)
    want = k7.topn_plain(keys, mask, n)
    torch.cuda.synchronize()
    assert torch.equal(got[1], want[1]) and torch.equal(got[0], want[0])


@pytest.mark.parametrize("live", [0, 1, 99, 2047, 2049])
def test_k7_few_live_rows_match_plain(live):
    """An all-dead page, n above the live count, and live counts on both
    sides of the final sort's budget."""
    from test_torch_k6_k7_design import _key_cases

    dev = _cuda()
    rows = 1 << 20
    rng = np.random.default_rng(172 + live)
    keys = [(d.to(dev), v.to(dev), a, nf)
            for d, v, a, nf in _key_cases()["double_signed_zeros_nan"](rng, rows)]
    mask = torch.zeros(rows, dtype=torch.bool)
    mask[rng.choice(rows, live, replace=False)] = True
    mask = mask.to(dev)
    got = k7.topn(keys, mask, 100)
    want = k7.topn_plain(keys, mask, 100)
    torch.cuda.synchronize()
    assert torch.equal(got[1], want[1]) and torch.equal(got[0], want[0])


@pytest.mark.parametrize("second", ["orderkey", "few_full_range"])
def test_k7_flag_first_key_at_lineitem_scale(second):
    """A lineitem-sized page (2^23 rows) whose first key is a three-valued
    flag, descending: millions of rows tie on it.  With an order key the
    prefix holds the row; with a full-range second key of few values it
    cannot, and the rows tied with the 100th on the whole prefix are
    refined on the fields past it."""
    dev = _cuda()
    rows = 1 << 23
    rng = np.random.default_rng(173)
    flag = torch.from_numpy(rng.integers(0, 3, rows).astype(np.int32))
    if second == "orderkey":
        key = torch.from_numpy(rng.integers(1, 6 * 10 ** 7, rows))
    else:
        key = torch.from_numpy(rng.choice(rng.integers(-(1 << 63), (1 << 63) - 1, 20,
                                                       dtype=np.int64), rows))
    ones = torch.ones(rows, dtype=torch.bool, device=dev)
    keys = [(flag.to(dev), ones, False, False), (key.to(dev), ones, True, False)]
    mask = torch.from_numpy(rng.random(rows) >= 0.05).to(dev)
    got = k7.topn(keys, mask, 100)
    want = k7.topn_plain(keys, mask, 100)
    torch.cuda.synchronize()
    assert torch.equal(got[1], want[1]) and torch.equal(got[0], want[0])


@pytest.mark.parametrize("only", ["double_sum", "hll", "min_by"])
def test_k6_keys_without_integer_slot_match_plain(only):
    """States whose first accumulate phase has no integer slot (a double
    sum, an HLL sum, a min_by alone): the group keys are still written,
    equal to the twin's."""
    dev = _cuda()
    n = 1 << 20
    rng = np.random.default_rng(174)
    code = torch.from_numpy(rng.integers(0, 5000, n)).to(dev)
    mask = torch.from_numpy(rng.random(n) >= 0.3).to(dev)
    ones = torch.ones(n, dtype=torch.bool, device=dev)
    keys = [(code, ones, 0, 5001)]
    if only == "double_sum":
        states = [(k6.S_DSUM, torch.from_numpy(rng.normal(0, 1e3, n)).to(dev), ones)]
    elif only == "hll":
        states = [(k6.S_HLL, torch.from_numpy(rng.integers(0, 30, n)).to(dev), ones)]
    else:
        states = [(k6.S_BY_X, torch.from_numpy(rng.integers(0, 10 ** 6, n)).to(dev), ones),
                  (k6.S_BY_XV, None, ones),
                  (k6.S_BY_Y_MIN, torch.from_numpy(rng.normal(0, 1, n)).to(dev), ones)]
    got = k6.sorted_group_agg(keys, mask, states)
    want = k6.sorted_group_agg_plain(keys, mask, states)
    torch.cuda.synchronize()
    assert got[2] == want[2]
    _equal_by_bits(got[0], want[0], "keys")
    _equal_by_bits(got[1], want[1], "states")
