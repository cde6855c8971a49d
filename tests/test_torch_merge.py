"""The sorted-run merge (``presto_tpu_torch/ops/merge.py``, K22
``merge_sorted``'s plain twin on the CPU) against the reference's
``presto_tpu/ops/merge.py``, exactly: the merge keys, a merge of two
runs and the k-way merge, over one key and several, descending with
NULLs first and last, doubles with -0.0, NaN and infinities, a raw
varchar key (the reference's concatenate-and-sort fallback) and k = 1,
2, 3 and 8 runs; then ORDER BY under ``SET SESSION distributed_sort =
true`` against the reference's runner."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parity  # noqa: F401  (one torch thread per process)
from presto_tpu.expr.ir import ColumnRef as RefCol
from presto_tpu.ops import merge as ref_merge
from presto_tpu.ops.sort import gather_page as ref_gather
from presto_tpu.ops.sort import sort_page as ref_sort
from presto_tpu.page import Block as RefBlock
from presto_tpu.page import Dictionary as RefDictionary
from presto_tpu.page import Page as RefPage
from presto_tpu.types import parse_type as ref_type
from presto_tpu_torch.expr.ir import ColumnRef
from presto_tpu_torch.ops import merge
from presto_tpu_torch.page import Block, Dictionary, Page
from presto_tpu_torch.types import parse_type

# (name, type) of the runs' columns
COLUMNS = [("a", "bigint"), ("b", "integer"), ("x", "double"), ("s", "varchar"),
           ("d", "decimal(12,2)"), ("r", "raw_varchar(8)")]
WORDS = ["pear", "apple", "fig", "kiwi", "plum", "date", "lime"]
SPECIALS = np.array([-0.0, np.nan, np.inf, -np.inf, 1e300, -1e-300, 2.5])


def _columns(n: int, rng, specials: bool):
    a = rng.integers(-50, 50, n)
    b = rng.integers(-5, 5, n).astype(np.int32)
    x = np.round(rng.normal(0, 10, n), 1)
    if specials:
        pick = rng.random(n) < 0.4
        x[pick] = rng.choice(SPECIALS, pick.sum())
    s = rng.integers(0, len(WORDS), n).astype(np.int32)
    d = rng.integers(-10 ** 6, 10 ** 6, n)
    r = rng.integers(97, 100, (n, 8)).astype(np.uint8)
    r[:, 3:] = 0
    return [a, b, x, s, d, r]


def _pages(n: int, seed: int, specials: bool = False, zero: float = 0.0,
           positive: bool = False):
    """A reference page and its port twin with NULLs and dead rows.  The
    doubles' zeros are all ``zero`` on one page (-0.0 and 0.0 tie in the
    sorts that make the runs, and not in the merge's key); ``positive``
    keeps the doubles in [1, 41)."""
    rng = np.random.default_rng(seed)
    cols = _columns(n, rng, specials)
    cols[2][cols[2] == 0] = zero
    if positive:
        cols[2] = np.abs(cols[2]) % 40 + 1
    valids = [rng.random(n) >= 0.12 for _ in cols]
    mask = rng.random(n) >= 0.1
    rdic, pdic = RefDictionary(WORDS), Dictionary(WORDS)
    ref = RefPage(tuple(RefBlock(jnp.asarray(c), jnp.asarray(v), ref_type(t),
                                 rdic if t == "varchar" else None)
                        for c, v, (_, t) in zip(cols, valids, COLUMNS)), jnp.asarray(mask))
    port = Page(tuple(Block(torch.from_numpy(c.copy()), torch.from_numpy(v), parse_type(t),
                            pdic if t == "varchar" else None)
                      for c, v, (_, t) in zip(cols, valids, COLUMNS)), torch.from_numpy(mask))
    return ref, port


def _exprs(names, port: bool):
    mk, pt = (ColumnRef, parse_type) if port else (RefCol, ref_type)
    idx = [n for n, _ in COLUMNS]
    return [mk(type=pt(dict(COLUMNS)[c]), index=idx.index(c)) for c in names]


def _port_of(ref: RefPage, like: Page) -> Page:
    return Page(tuple(Block(torch.from_numpy(np.array(r.data)), torch.from_numpy(np.array(r.valid)),
                            b.type, b.dictionary) for r, b in zip(ref.blocks, like.blocks)),
                torch.from_numpy(np.array(ref.row_mask)))


def _same(ref: RefPage, port: Page, what: str):
    np.testing.assert_array_equal(port.row_mask.numpy(), np.asarray(ref.row_mask), what)
    for i, (rb, pb) in enumerate(zip(ref.blocks, port.blocks)):
        np.testing.assert_array_equal(pb.valid.numpy(), np.asarray(rb.valid), f"{what} {i}")
        np.testing.assert_array_equal(pb.data.numpy(), np.asarray(rb.data), f"{what} {i}")


SPECS = {
    "one_lane": (["a"], [True], [False]),
    "one_lane_desc_nulls_first": (["a"], [False], [True]),
    "two_lanes": (["b", "a"], [True, False], [False, True]),
    "dictionary_then_int": (["s", "b"], [True, True], [True, False]),
    "three_lanes_nulls_last": (["s", "b", "a"], [False, True, False], [False, False, False]),
    "decimal": (["d"], [False], [False]),
    "double": (["x"], [True], [False]),
    "double_desc_nulls_first": (["x"], [False], [True]),
    # a double lane packed with another: positive doubles, whose order
    # bits span ~2^50 (signed ones span past int64: see
    # test_multi_lane_double_overflow_known_fault)
    "double_and_int": (["b", "x"], [True, False], [False, False]),
}
SPECIAL_DOUBLES = ("double", "double_desc_nulls_first")


def _runs(k: int, spec, specials: bool, seed: int = 0):
    """k runs sorted by the reference's merge key (so each run is sorted
    under the key the merge compares, -0.0 below 0.0 included), as
    (reference page, port page) pairs."""
    names, asc, nf = spec
    pairs = [_pages(int(300 + 97 * i), seed + i, specials, -0.0 if i % 2 else 0.0,
                    positive="x" in names and len(names) > 1) for i in range(k)]
    refs = [r for r, _ in pairs]
    keys = ref_merge.merge_keys_for_pages(refs, _exprs(names, False), asc, nf)
    out = []
    for (r, p), key in zip(pairs, keys):
        order = jnp.asarray(np.argsort(np.asarray(key), kind="stable"))
        rs = ref_gather(r, order)
        out.append((rs, _port_of(rs, p)))
    return out


@pytest.mark.parametrize("name", sorted(SPECS))
def test_merge_keys_match_reference(name):
    names, asc, nf = SPECS[name]
    multi_double = "x" in names and len(names) > 1
    pairs = [_pages(400, 40 + i, specials=not multi_double, zero=-0.0 if i else 0.0,
                    positive=multi_double) for i in range(3)]
    refs, ports = [r for r, _ in pairs], [p for _, p in pairs]
    want = ref_merge.merge_keys_for_pages(refs, _exprs(names, False), asc, nf)
    got = merge.merge_keys_for_pages(ports, _exprs(names, True), asc, nf)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_multi_lane_double_overflow_known_fault():
    """A fault of the reference: a double lane whose order bits span
    past int64 (signed doubles) packed with another lane makes its
    NULL code overflow ``jnp.where``, so its merge raises; the port's
    lane falls back to concatenate and sort, as a lane past 62 bits
    does in both."""
    names, asc, nf = ["b", "x"], [True, False], [False, False]
    pairs = [_pages(300, 70 + i) for i in range(2)]
    with pytest.raises(OverflowError):
        ref_merge.merge_keys_for_pages([r for r, _ in pairs], _exprs(names, False), asc, nf)
    with pytest.raises(merge._NoScalarKey):
        merge.merge_keys_for_pages([p for _, p in pairs], _exprs(names, True), asc, nf)


def test_float_order_bits_match_reference():
    x = np.array([-0.0, 0.0, np.nan, np.inf, -np.inf, 5e-324, -5e-324, 1.5, -1.5])
    want = np.asarray(ref_merge._float_order_bits(jnp.asarray(x)))
    got = merge._float_order_bits(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, want)
    assert got[0] < got[1]  # -0.0 below 0.0, unlike double_sort_key
    x32 = np.array([-0.0, 0.0, np.nan, 1.25], np.float32)
    np.testing.assert_array_equal(merge._float_order_bits(torch.from_numpy(x32)).numpy(),
                                  np.asarray(ref_merge._float_order_bits(jnp.asarray(x32))))


@pytest.mark.parametrize("name", ["one_lane", "two_lanes", "double_desc_nulls_first"])
def test_merge_two_sorted_matches_reference(name):
    names, asc, nf = SPECS[name]
    (ra, pa), (rb, pb) = _runs(2, SPECS[name], specials=True)
    ka, kb = ref_merge.merge_keys_for_pages([ra, rb], _exprs(names, False), asc, nf)
    want, wkey = ref_merge.merge_two_sorted(ra, rb, ka, kb)
    got, key = merge.merge_two_sorted(pa, pb, torch.from_numpy(np.array(ka)),
                                      torch.from_numpy(np.array(kb)))
    np.testing.assert_array_equal(key.numpy(), np.asarray(wkey))
    _same(want, got, name)


@pytest.mark.parametrize("k", [1, 2, 3, 8])
@pytest.mark.parametrize("name", sorted(SPECS))
def test_merge_sorted_pages_match_reference(name, k):
    names, asc, nf = SPECS[name]
    runs = _runs(k, SPECS[name], specials=name in SPECIAL_DOUBLES, seed=7 * k)
    want = ref_merge.merge_sorted_pages([r for r, _ in runs], _exprs(names, False), asc, nf)
    got = merge.merge_sorted_pages([p for _, p in runs], _exprs(names, True), asc, nf)
    _same(want, got, f"{name} k={k}")


@pytest.mark.parametrize("k", [2, 3])
def test_raw_varchar_key_takes_the_concat_and_sort_fallback(k):
    """A raw varchar key has no scalar lane: both merge by concatenating
    the runs and sorting (the port's sort passes over the bytes' lanes)."""
    pairs = [_pages(200 + 31 * i, 90 + i) for i in range(k)]
    names, asc, nf = ["r", "a"], [True, False], [False, True]
    runs = [ref_sort(r, _exprs(names, False), asc, nf) for r, _ in pairs]
    with pytest.raises(ref_merge._NoScalarKey):
        ref_merge.merge_keys_for_pages(runs, _exprs(names, False), asc, nf)
    ports = [_port_of(r, p) for r, (_, p) in zip(runs, pairs)]
    with pytest.raises(merge._NoScalarKey):
        merge.merge_keys_for_pages(ports, _exprs(names, True), asc, nf)
    want = ref_merge.merge_sorted_pages(runs, _exprs(names, False), asc, nf)
    got = merge.merge_sorted_pages(ports, _exprs(names, True), asc, nf)
    # live rows in the same order, each value where valid
    live_w, live_g = np.asarray(want.row_mask), got.row_mask.numpy()
    assert live_w.sum() == live_g.sum()
    for rb, pb in zip(want.blocks, got.blocks):
        rv, pv = np.asarray(rb.valid)[live_w], pb.valid.numpy()[live_g]
        np.testing.assert_array_equal(pv, rv)
        np.testing.assert_array_equal(pb.data.numpy()[live_g][pv], np.asarray(rb.data)[live_w][rv])


ORDER_BY = [
    "select l_orderkey, l_extendedprice, l_shipdate from lineitem "
    "order by l_extendedprice desc, l_orderkey, l_linenumber",
    "select o_orderkey, o_orderpriority, o_totalprice from orders "
    "order by o_orderpriority, o_totalprice desc, o_orderkey",
    "select l_returnflag, l_discount, l_orderkey, l_linenumber from lineitem "
    "where l_quantity < 10 order by l_discount, l_returnflag desc, l_orderkey, l_linenumber",
]


@pytest.fixture(scope="module")
def merge_runners():
    from torch_fn_parity import TpchPair

    pair = TpchPair(sf=0.01, split_rows=4096)
    pair.ref.execute("SET SESSION distributed_sort = true")
    assert pair.port.execute("SET SESSION distributed_sort = true").rows == [("SET SESSION",)]
    assert pair.ref.executor.merge_sort and pair.port.executor.merge_sort
    return pair


@pytest.mark.parametrize("i", range(len(ORDER_BY)))
def test_order_by_under_distributed_sort_matches_reference(merge_runners, i):
    from presto_tpu_torch.kernels import merge_sorted as k22

    calls = []
    plain = k22.merge_sorted_plain

    def counted(a, b):
        calls.append(1)
        return plain(a, b)

    k22.merge_sorted_plain = counted
    try:
        rows = merge_runners.check(ORDER_BY[i], ordered=True)
    finally:
        k22.merge_sorted_plain = plain
    assert rows and calls  # the runs merged through K22's twin
