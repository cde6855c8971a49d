"""The twelfth slice's kernels against the reference's functions, on the
CPU (the kernels' plain twins): K15 ``group_topn`` (with its host half,
``sorted_entries``) against ``presto_tpu.ops.aggregate._topn_halves``,
K16 ``kmv_lanes`` and ``digest_entries`` against ``_kmv_lanes`` and
``_digest_entries``, make_set_digest's hash (K1's ``HLL`` mode 1) against
``mix64``, K12's ``hll_card``, ``kmv_card`` and ``sd_pair`` against the
reference compiler's hll / setdigest ``cardinality``, ``jaccard_index``
and ``intersection_cardinality`` branches, and K14's wide value half
(multimap_agg), map_union and hll_sketch with K15's and K16's states
through the port's ``grouped_aggregate`` / ``merge_aggregate`` /
``combine_packed_states`` against the reference's.  Inputs are seeded
numpy: ties, NaN, -0.0/0.0 and infinities among double keys, NULL ``x``
in the ``*_by_n`` forms, groups past n rows and past 64 distinct
hashes, empty groups, a dictionary varchar, partial states merged
across splits.  Every comparison is exact (doubles by their bits);
the HLL estimate is an integer whose weights the port builds as exact
powers of two where XLA's ``exp2`` is a few ulp off, so it could move
only at a .5 boundary of the rounding, which none of these inputs
reaches."""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from presto_tpu.ops import aggregate as ref_agg
from presto_tpu.types import parse_type as ref_type
from presto_tpu_torch.kernels import container_eval as k12
from presto_tpu_torch.kernels import group_collect as k14
from presto_tpu_torch.kernels import group_topn as k15
from presto_tpu_torch.kernels import kmv_lanes as k16
from presto_tpu_torch.types import parse_type as port_type

I64_MIN = np.iinfo(np.int64).min
I64_MAX = np.iinfo(np.int64).max


def _bits(x: np.ndarray) -> np.ndarray:
    x = np.asarray(x)
    return x.view(np.int64) if x.dtype == np.float64 else x


def _same(port, ref, what):
    p = port.numpy() if isinstance(port, torch.Tensor) else np.asarray(port)
    r = np.asarray(ref)
    assert p.shape == r.shape, (what, p.shape, r.shape)
    np.testing.assert_array_equal(_bits(p.astype(r.dtype)), _bits(r), err_msg=what)


def _keys(rng, m, kind):
    """Seeded keys with many ties: small integers, or doubles with NaN,
    -0.0 beside 0.0 and infinities."""
    if kind == "bigint":
        k = rng.integers(-6, 7, m).astype(np.int64)
        k[rng.random(m) < 0.05] = I64_MAX
        k[rng.random(m) < 0.05] = I64_MIN + 1
        return k
    k = rng.integers(-6, 7, m).astype(np.float64) / 2
    pick = rng.random(m) < 0.25
    k[pick] = rng.choice([np.nan, -0.0, 0.0, np.inf, -np.inf], pick.sum())
    return k


def _topn_port(g, keys, vals, sel, n, cap, storage, desc, with_keys):
    t = torch.from_numpy
    perm, starts = k15.sorted_entries(t(g), t(keys), t(sel), n)
    vals_t = t(vals.astype(storage))
    keys_t = t(keys.astype(storage)) if with_keys else None
    return k15.group_topn(perm, starts, vals_t, keys_t, cap, desc), starts


@pytest.mark.parametrize("kind", ["bigint", "double"])
@pytest.mark.parametrize("desc", [True, False], ids=["max", "min"])
@pytest.mark.parametrize("with_keys", [False, True], ids=["n", "by_n"])
def test_group_topn_equals_topn_halves(kind, desc, with_keys):
    """K15 over sorted_entries against _topn_halves: lanes by key, the
    max forms reversed (the later of equal keys in the lower lane), the
    sentinel past the group's size, groups past cap, empty groups."""
    rng = np.random.default_rng(120 + desc + 2 * with_keys + 4 * (kind == "double"))
    m, n, cap = 700, 9, 5
    g = rng.integers(0, n - 2, m).astype(np.int64)  # the last two groups stay empty
    g[:40] = 3  # one group far past cap
    keys = _keys(rng, m, kind)
    sel = rng.random(m) >= 0.15
    storage = np.float64 if kind == "double" else np.int64
    # a *_by_n value: any x, NULL x as the sentinel; max_n's value is its key
    vals = rng.integers(-1000, 1000, m).astype(storage) if with_keys else keys.astype(storage)
    if with_keys:
        vals[rng.random(m) < 0.1] = np.nan if storage == np.float64 else I64_MIN
    halves, gcnt = ref_agg._topn_halves(None, jnp.asarray(g), jnp.asarray(keys),
                                        jnp.asarray(vals), jnp.asarray(sel), n, cap, storage,
                                        descending=desc, with_keys=with_keys)
    got, starts = _topn_port(g, keys, vals, sel, n, cap, storage, desc, with_keys)
    _same(starts[1:] - starts[:-1], gcnt, "sizes")
    _same(got[:, 0], np.minimum(np.asarray(gcnt), cap).astype(storage), "lengths")
    _same(got[:, 1:1 + cap], halves[0], "value lanes")
    if with_keys:
        _same(got[:, 1 + cap:], halves[1], "key lanes")
    else:
        assert got.shape == (n, 1 + cap)


def test_group_topn_ties_and_signed_zeros():
    """Equal keys: the max forms put the later entry in the lower lane,
    the min forms the earlier; -0.0 and 0.0 are equal keys, NaN sorts
    above +inf."""
    keys = np.array([0.0, -0.0, 1.0, np.nan, 0.0, np.inf])
    vals = np.arange(6, dtype=np.float64)
    g = np.zeros(6, np.int64)
    sel = np.ones(6, bool)
    top, _ = _topn_port(g, keys, vals, sel, 1, 6, np.float64, True, True)
    low, _ = _topn_port(g, keys, vals, sel, 1, 6, np.float64, False, True)
    assert top[0, 1:7].tolist() == [3, 5, 2, 4, 1, 0]
    assert low[0, 1:7].tolist() == [0, 1, 4, 2, 5, 3]


def _hashes(rng, m, distinct):
    pool = rng.integers(I64_MIN, I64_MAX, distinct, dtype=np.int64)
    return pool[rng.integers(0, distinct, m)]


@pytest.mark.parametrize("counted", [True, False])
@pytest.mark.parametrize("distinct", [30, 400])
def test_kmv_lanes_equals_reference(distinct, counted):
    """K16 over sorted_entries against _kmv_lanes: the 64 smallest
    distinct hashes per group ascending, their counts summed, the
    distinct totals; groups below and past 64 distinct, an empty group;
    with counts, and without (make_set_digest's: each entry 1, against
    the reference's ones)."""
    rng = np.random.default_rng(distinct)
    m, n, cap = 3000, 6, 64
    g = rng.integers(0, n - 1, m).astype(np.int64)
    h = _hashes(rng, m, distinct)
    counts = rng.integers(1, 4, m).astype(np.int64) if counted else np.ones(m, np.int64)
    sel = rng.random(m) >= 0.1
    state, dist = ref_agg._kmv_lanes(jnp.asarray(g), jnp.asarray(h), jnp.asarray(counts),
                                     jnp.asarray(sel), n, cap, np.int64)
    t = torch.from_numpy
    perm, starts = k15.sorted_entries(t(g), t(h), t(sel), n)
    got, got_dist = k16.kmv_lanes(perm, t(g), t(h), t(counts) if counted else None, starts,
                                  cap)
    _same(got, state, "digest state")
    _same(got_dist, dist, "distinct")


def test_digest_entries_and_merge_equal_reference():
    """The merge of digest partials: _digest_entries' flattening and
    _kmv_lanes over it, against digest_entries and K16 (counts summing
    on shared hashes)."""
    rng = np.random.default_rng(5)
    n, cap, rows = 4, 64, 12
    g = rng.integers(0, 3, 200).astype(np.int64)
    h = _hashes(rng, 200, 90)
    state, _ = ref_agg._kmv_lanes(jnp.asarray(g), jnp.asarray(h), jnp.ones(200, np.int64),
                                  jnp.ones(200, bool), 3, cap, np.int64)
    parts = np.concatenate([np.asarray(state)] * 4)[:rows]
    pg = rng.integers(0, n, rows).astype(np.int64)
    live = rng.random(rows) >= 0.2
    rgid = np.where(live, pg, n)
    egid, hs, cs, ok = ref_agg._digest_entries(jnp.asarray(parts), jnp.asarray(rgid), n, cap)
    t = torch.from_numpy
    ge, he, ce, oke = k16.digest_entries(t(parts), t(pg), t(live), cap)
    _same(oke, ok, "lanes taken")
    _same(he[oke], np.asarray(hs)[np.asarray(ok)], "hashes")
    _same(ce[oke], np.asarray(cs)[np.asarray(ok)], "counts")
    _same(ge[oke], np.asarray(egid)[np.asarray(ok)], "groups")
    want, wdist = ref_agg._kmv_lanes(egid, hs, cs, ok, n, cap, np.int64)
    perm, starts = k15.sorted_entries(ge, he, oke, n)
    got, gdist = k16.kmv_lanes(perm, ge, he, ce, starts, cap)
    _same(got, want, "merged digest")
    _same(gdist, wdist, "merged distinct")


# -- make_set_digest's hash -------------------------------------------------------

def test_digest_hash_equals_mix64():
    """make_set_digest's hash (K1's HLL with mode 1, the argument's 64
    bits: a double's and a REAL's bits as a double, an integer, a date,
    a boolean and a dictionary varchar's code as an int64) against the
    reference's mix64 of the same lanes."""
    from presto_tpu.page import Block as RefBlock, Dictionary as RefDict, Page as RefPage
    from presto_tpu_torch.expr.compile import ExprCompiler
    from presto_tpu_torch.expr.ir import ColumnRef
    from presto_tpu_torch.ops.aggregate import _digest_hash
    from torch_parity import to_port

    rng = np.random.default_rng(9)
    n = 64
    big = rng.integers(I64_MIN, I64_MAX, n, dtype=np.int64)
    big[:4] = [I64_MIN, I64_MAX, 0, -1]
    dbl = rng.normal(size=n) * 1e6
    dbl[:5] = [0.0, -0.0, np.inf, -np.inf, 1e-300]
    cols = {"bigint": big, "integer": rng.integers(-2**31, 2**31, n).astype(np.int32),
            "double": dbl, "real": (rng.normal(size=n) * 100).astype(np.float32),
            "date": rng.integers(0, 20000, n).astype(np.int32),
            "boolean": rng.random(n) < 0.5, "varchar": rng.integers(0, 5, n).astype(np.int32)}
    d = RefDict(["a", "b", "c", "a", "e"])
    ones = jnp.ones(n, bool)
    ref = RefPage(tuple(RefBlock(jnp.asarray(v), ones, ref_type(t), d if t == "varchar" else None)
                        for t, v in cols.items()), ones)
    port = to_port(ref)
    c = ExprCompiler.for_page(port)
    for i, (t, v) in enumerate(cols.items()):
        if t in ("double", "real"):
            lane = jnp.asarray(v.astype(np.float64)).view(jnp.int64)
        else:
            lane = jnp.asarray(v.astype(np.int64))
        got, _ = _digest_hash(c, ColumnRef(type=port_type(t), index=i))(port)
        _same(got, ref_agg.mix64(lane), f"hash of {t}")


# -- the sketches' scalar functions --------------------------------------------------

def _hll_rows(rng, n):
    """HLL rows [count, 512 buckets, 512 rho]: empty, sparse (the linear
    counting range), about 2.5 m and full."""
    m = 512
    counts = np.concatenate([[0, 1, 512, 511, 300], rng.integers(0, m + 1, n - 5)])
    out = np.full((n, 1 + 2 * m), I64_MIN, np.int64)
    out[:, 0] = counts
    for r, c in enumerate(counts):
        out[r, 1:1 + c] = np.sort(rng.choice(m, c, replace=False))
        out[r, 1 + m:1 + m + c] = rng.integers(1, 24, c)
    return out


def _digest_rows(rng, n):
    """Digest rows from the reference's own make_set_digest lanes:
    below and at 64 hashes, sharing some hashes row to row."""
    pool = rng.integers(I64_MIN, I64_MAX, 150, dtype=np.int64)
    g = rng.integers(0, n, 4000).astype(np.int64)
    size = rng.integers(1, 150, n)
    h = pool[rng.integers(0, 150, 4000) % size[g]]
    state, _ = ref_agg._kmv_lanes(jnp.asarray(g), jnp.asarray(h), jnp.ones(4000, np.int64),
                                  jnp.ones(4000, bool), n, 64, np.int64)
    out = np.asarray(state).copy()
    out[0, 0] = 0  # an empty digest
    out[0, 1:] = I64_MIN
    return out


def _ref_scalar(fn, cols, types):
    """The reference compiler's ``fn`` over matrix columns."""
    from presto_tpu.expr import ir as rir
    from presto_tpu.expr.compile import ExprCompiler as RefCompiler
    from presto_tpu.page import Block as RefBlock, Page as RefPage

    n = cols[0][0].shape[0]
    page = RefPage(tuple(RefBlock(jnp.asarray(d), jnp.asarray(v), ref_type(t))
                         for (d, v), t in zip(cols, types)), jnp.ones(n, bool))
    out_t = {"cardinality": "bigint", "jaccard_index": "double",
             "intersection_cardinality": "bigint"}[fn]
    e = rir.Call(type=ref_type(out_t), fn=fn,
                 args=tuple(rir.ColumnRef(type=ref_type(t), index=i)
                            for i, t in enumerate(types)))
    return RefCompiler.for_page(page).compile(e)(page)


def test_hll_card_equals_reference():
    rng = np.random.default_rng(31)
    rows = _hll_rows(rng, 40)
    valid = rng.random(40) >= 0.1
    want = _ref_scalar("cardinality", [(rows, valid)], ["hll"])
    got = k12.container_eval(k12.HLL_CARD, torch.from_numpy(rows), torch.from_numpy(valid))
    _same(got[1], want[1], "valid")
    _same(got[0], want[0], "estimate")


def test_kmv_card_and_pairs_equal_reference():
    rng = np.random.default_rng(32)
    a, b = _digest_rows(rng, 30), _digest_rows(rng, 30)
    b[3] = a[3]  # identical digests
    av, bv = rng.random(30) >= 0.1, rng.random(30) >= 0.1
    t = torch.from_numpy
    want = _ref_scalar("cardinality", [(a, av)], ["setdigest"])
    got = k12.container_eval(k12.KMV_CARD, t(a), t(av))
    _same(got[1], want[1], "valid")
    _same(got[0], want[0], "kmv estimate")
    assert (np.asarray(a[:, 0]) == 64).any() and (np.asarray(a[:, 0]) < 64).any()
    for fn, mode in (("jaccard_index", k12.SD_JACCARD),
                     ("intersection_cardinality", k12.SD_INTERSECTION)):
        want = _ref_scalar(fn, [(a, av), (b, bv)], ["setdigest", "setdigest"])
        got = k12.container_eval(k12.SD_PAIR, t(a), t(av), b=t(b), bv=t(bv), p=[mode])
        _same(got[1], want[1], f"{fn} valid")
        _same(got[0], want[0], fn)


# -- the aggregates through the port's aggregation layer -----------------------------

def _agg_pages(rng, n, groups, specs):
    """The same seeded page in both packages: g (bigint), then each
    (port type string, numpy data, valid) column of ``specs``."""
    from presto_tpu.page import Block as RefBlock, Page as RefPage
    from presto_tpu_torch.page import Block, Page

    g = rng.integers(0, groups, n).astype(np.int64)
    live = rng.random(n) >= 0.1
    cols = [("bigint", g, np.ones(n, bool))] + list(specs)
    ref = RefPage(tuple(RefBlock(jnp.asarray(d), jnp.asarray(v), ref_type(t))
                        for t, d, v in cols), jnp.asarray(live))
    port = Page(tuple(Block(torch.from_numpy(np.ascontiguousarray(d)), torch.from_numpy(v),
                            port_type(t)) for t, d, v in cols), torch.from_numpy(live))
    return ref, port


def _calls(ir, type_of, fns):
    """AggCalls over the columns of ``types``: (fn, types, arg index,
    arg2 index or None, literal n or None)."""
    from presto_tpu.ops.aggregate import output_type as ref_out
    from presto_tpu_torch.ops.aggregate import output_type as port_out

    out_type = ref_out if type_of is ref_type else port_out
    calls = []
    for fn, types, i, j, lit in fns:
        extra = [ir.ColumnRef(type=type_of(types[j]), index=j)] if j is not None else []
        if lit is not None:
            extra.append(ir.Literal(type=type_of("bigint"), value=lit))
        call = ir.AggCall(fn=fn, arg=ir.ColumnRef(type=type_of(types[i]), index=i),
                          type=type_of("bigint"), **dict(zip(("arg2", "arg3"), extra)))
        calls.append(dataclasses.replace(call, type=out_type(call)))
    return calls


def _rows(page):
    return sorted(page.to_pylist(), key=lambda r: (r[0] is None, repr(r)))


def _split_and_merge(rng, specs, fns, groups, n=200, splits=2):
    """Partials per split in both packages (equal), then one merge of all
    of them, finalized (equal)."""
    from presto_tpu.exec.local import concat_pages_device as ref_concat
    from presto_tpu.expr import ir as ref_ir
    from presto_tpu_torch.expr import ir as port_ir
    from presto_tpu_torch.ops import aggregate as port_agg
    from presto_tpu_torch.page import concat_pages_device

    types = ["bigint"] + [make(rng, 1)[0] for make in specs]
    raggs = _calls(ref_ir, ref_type, [(f, types, *rest) for f, *rest in fns])
    paggs = _calls(port_ir, port_type, [(f, types, *rest) for f, *rest in fns])
    rkey = [ref_ir.ColumnRef(type=ref_type("bigint"), index=0)]
    pkey = [port_ir.ColumnRef(type=port_type("bigint"), index=0)]
    rparts, pparts = [], []
    for _ in range(splits):
        ref, port = _agg_pages(rng, n, groups, [make(rng, n) for make in specs])
        rparts.append(ref_agg.grouped_aggregate(ref, rkey, raggs, 256, mode="partial"))
        pparts.append(port_agg.grouped_aggregate(port, pkey, paggs, 256, mode="partial"))
    want = ref_agg.merge_aggregate(ref_concat(rparts), 1, raggs, 256, mode="single")
    got = port_agg.merge_aggregate(concat_pages_device(pparts), 1, paggs, 256, mode="single")
    assert _rows(got) == _rows(want)
    return _rows(got)


def _scalar_col(t, lo=-50, hi=50, null_rate=0.1):
    def make(rng, n):
        d = rng.integers(lo, hi, n)
        d = d.astype(np.float64) / 4 if t == "double" else d.astype(np.int64)
        return t, d, rng.random(n) >= null_rate
    return make


def _array_col(cap):
    def make(rng, n):
        lens = rng.integers(0, cap + 1, n)
        d = np.full((n, 1 + cap), I64_MIN, np.int64)
        d[:, 0] = lens
        vals = rng.integers(-9, 9, (n, cap))
        vals[rng.random(vals.shape) < 0.1] = I64_MIN
        j = np.arange(cap)[None, :]
        d[:, 1:] = np.where(j < lens[:, None], vals, I64_MIN)
        return f"array(bigint, {cap})", d, rng.random(n) >= 0.1
    return make


def _map_col(cap, storage):
    def make(rng, n):
        lens = rng.integers(0, cap + 1, n)
        sent = np.nan if storage == np.float64 else I64_MIN
        d = np.full((n, 1 + 2 * cap), sent, storage)
        d[:, 0] = lens
        j = np.arange(cap)[None, :]
        keys = rng.integers(0, 6, (n, cap)).astype(storage)
        vals = rng.integers(-9, 9, (n, cap)).astype(storage)
        d[:, 1:1 + cap] = np.where(j < lens[:, None], keys, sent)
        d[:, 1 + cap:] = np.where(j < lens[:, None], vals, sent)
        vt = "double" if storage == np.float64 else "bigint"
        return f"map(bigint, {vt}, {cap})", d, rng.random(n) >= 0.15
    return make


@pytest.mark.parametrize("groups", [3, 90])
def test_topn_digest_states_split_and_merge(groups):
    """max_n / min_n over a double, max_by_n (a bigint x by a double y:
    one float64 storage, NULL x as NaN, turned back into an integer
    sentinel at finalize) and min_by_n, make_set_digest and hll_sketch:
    partials per split (K15, K16, K14 over K6's runs) and their merge."""
    specs = [_scalar_col("double", -20, 20), _scalar_col("bigint", -400, 400),
             _scalar_col("bigint", 0, 512, 0.0), _scalar_col("bigint", 1, 20, 0.0)]
    fns = [("max_n", 1, None, 3), ("min_n", 1, None, 2), ("max_by_n", 2, 1, 4),
           ("min_by_n", 1, 2, 3), ("make_set_digest", 2, None, None),
           ("hll_sketch", 3, 4, None)]
    rows = _split_and_merge(np.random.default_rng(groups), specs, fns, groups)
    assert rows and any(len(r[1]) == 3 for r in rows)


@pytest.mark.parametrize("storage", [np.int64, np.float64], ids=["bigint", "double"])
def test_multimap_and_map_union_states_split_and_merge(storage):
    """K14's wide value half (multimap_agg over an array column, NULL
    arrays stored as sentinel rows) and map_union (the input maps'
    entries at running offsets, a NULL map skipped, an empty one
    counted), per split and merged."""
    specs = [_scalar_col("bigint", 0, 5, 0.1), _array_col(4), _map_col(3, storage)]
    fns = [("multimap_agg", 1, 2, None), ("map_union", 3, None, None)]
    _split_and_merge(np.random.default_rng(7), specs, fns, 4, n=60)


@pytest.mark.parametrize("tied", [False, True])
def test_global_fold_of_digests_and_topn(tied):
    """The global aggregate (K2's counts, K15 and K16 over the page's one
    run) folded split by split as the executor folds a top-n state
    (``fold_topn_partials``' running fold: the first partial merged
    alone, then the accumulator with each, then the final merge) against
    the reference runner's running fold; tied keys keep the reference's
    lanes."""
    from presto_tpu.exec.local import concat_pages_device as ref_concat
    from presto_tpu.expr import ir as ref_ir
    from presto_tpu_torch.expr import ir as port_ir
    from presto_tpu_torch.ops import aggregate as port_agg

    rng = np.random.default_rng(44)
    types = ["bigint", "bigint", "double"]
    fns = [("max_by_n", 1, 2, 3), ("min_n", 2, None, 4), ("make_set_digest", 1, None, None)]
    raggs = _calls(ref_ir, ref_type, [(f, types, *r) for f, *r in fns])
    paggs = _calls(port_ir, port_type, [(f, types, *r) for f, *r in fns])
    acc_r, parts = None, []
    perm = rng.permutation(10_000)
    for s in range(3):
        n = 50
        y = (rng.integers(0, 6, n) if tied else perm[s * n:(s + 1) * n]).astype(np.float64) / 8
        ref, port = _agg_pages(rng, n, 1, [("bigint", rng.integers(0, 40, n),
                                            rng.random(n) >= 0.1),
                                           ("double", y, rng.random(n) >= 0.1)])
        pr = ref_agg.grouped_aggregate(ref, [], raggs, 1, mode="partial")
        parts.append(port_agg.grouped_aggregate(port, [], paggs, 1, mode="partial"))
        acc_r = ref_agg.merge_aggregate(pr if acc_r is None else ref_concat([acc_r, pr]), 0,
                                        raggs, 1, mode="partial")
    acc_p = port_agg.fold_topn_partials(parts, 0, paggs, 1)
    assert port_agg.merge_aggregate(acc_p, 0, paggs, 1, mode="single").to_pylist() == \
        ref_agg.merge_aggregate(acc_r, 0, raggs, 1, mode="single").to_pylist()


def test_group_collect_wide_half_and_union_plain():
    """K14's twin over explicit runs: a two-slot value half per entry (a
    NULL array as sentinel slots), and map_union's merge of 2-entry maps
    into 3 slots (a row's entries past the cap dropped, the length
    capped)."""
    order = torch.tensor([2, 0, 1])
    starts = torch.tensor([0, 3])
    keys = (torch.tensor([7, 8, 9]), torch.ones(3, dtype=torch.bool))
    arr = torch.tensor([[1, 10], [1, 20], [0, I64_MIN]])
    got = k14.group_collect(order, starts, torch.ones(3, dtype=torch.bool),
                            [keys, (arr, torch.tensor([True, False, True]))], 3, torch.int64)
    assert got.tolist() == [[3, 9, 7, 8, 0, I64_MIN, 1, 10, I64_MIN, I64_MIN]]
    maps = torch.tensor([[2, 1, 2, 10, 20], [2, 3, 4, 30, 40]])
    got = k14.group_collect_merge(None, torch.tensor([0, 2]), torch.ones(2, dtype=torch.bool),
                                  maps, 3, halves=2, in_cap=2)
    assert got.tolist() == [[3, 1, 2, 3, 10, 20, 30]]
