"""The coupled and statistical aggregates in the port: checksum,
skewness / kurtosis, the covariance family (covar_pop, covar_samp,
corr, regr_slope, regr_intercept) and min_by / max_by, through K2's
global and packed-direct slots, K6's sorted runs and merge and K3's
fold and finalize (their plain twins on the CPU), against the
reference's ``grouped_aggregate`` and ``merge_aggregate`` over seeded
pages with NULLs and dead rows; min_by / max_by's ties and NULLs and
checksum's NULLs and doubles on small pages; the reference suites' SQL
of these families; and the reference's packed fold, which raises on
every one of them, pinned (the port's fold is held against the
reference's single pass instead).

Tolerances: integers, counts, checksums and min_by / max_by values are
exact (a state's value where its count is positive: an empty state
holds each package's own identity).  The double states and results add
in the port's fixed order and in the reference's own, so they agree
within a relative 1e-9 (a partial state's column also within 1e-9 of
its largest magnitude, since a third moment's sum cancels), as the
variance states of the sixth slice do."""

import numpy as np
import pytest

from presto_tpu.expr import ir as ref_ir
from presto_tpu.ops import aggregate as ref_agg
from presto_tpu.types import parse_type as ref_type
from presto_tpu_torch.expr import ir as port_ir
from presto_tpu_torch.ops import aggregate as port_agg
from presto_tpu_torch.types import parse_type as port_type
from torch_fn_parity import COLUMNS, C, F, L, TpchPair, build, function_page
from torch_parity import to_port

POSITIVE = F("gt", "boolean", C("b"), L(10, "bigint"))
# (fn, argument, second argument, filter)
AGGS = [
    ("checksum", C("a"), None, None), ("checksum", C("x"), None, None),
    ("checksum", C("s"), None, POSITIVE), ("checksum", C("dt"), None, None),
    ("checksum", C("f"), None, None),
    ("skewness", C("y"), None, None), ("kurtosis", C("d"), None, None),
    ("skewness", C("i"), None, C("f")), ("kurtosis", C("y"), None, POSITIVE),
    ("covar_pop", C("y"), C("d"), None), ("covar_samp", C("y"), C("i"), None),
    ("corr", C("y"), C("b"), None), ("regr_slope", C("d"), C("i"), C("f")),
    ("regr_intercept", C("y"), C("b"), None),
    ("min_by", C("a"), C("y"), None), ("max_by", C("s"), C("y"), None),
    ("min_by", C("y"), C("s"), None), ("max_by", C("i"), C("b"), None),
    ("min_by", C("dt"), C("f"), None), ("max_by", C("x"), C("b"), POSITIVE),
    ("min_by", C("f"), C("i"), None), ("max_by", C("d"), C("dt"), None),
    ("count_star", None, None, None),
]
# the families in three runs, each within the kernels' state limits (K2:
# 32 aggregate entries, a covariance taking five; K6: 32 integer states,
# a min_by / max_by taking four)
PARTS = [AGGS[:14], AGGS[14:18] + AGGS[-1:], AGGS[18:]]
DOUBLE_FNS = ("skewness", "kurtosis", "covar_pop", "covar_samp", "corr", "regr_slope",
              "regr_intercept")
KEY = [C("k")]
KEY_DOMAIN = [(0, 39)]


def _aggs(ir, parse_type, agg_module, specs):
    out = []
    for fn, arg, arg2, filt in specs:
        a = build(arg, ir, parse_type, COLUMNS) if arg is not None else None
        a2 = build(arg2, ir, parse_type, COLUMNS) if arg2 is not None else None
        f = build(filt, ir, parse_type, COLUMNS) if filt is not None else None
        call = ir.AggCall(fn=fn, arg=a, type=parse_type("bigint"), filter=f, arg2=a2)
        out.append(ir.AggCall(fn=fn, arg=a, type=agg_module.output_type(call), filter=f,
                              arg2=a2))
    return out


def _both(seed, specs=AGGS):
    ref_page = function_page(seed, n=1024)
    return (ref_page, to_port(ref_page), _aggs(ref_ir, ref_type, ref_agg, specs),
            _aggs(port_ir, port_type, port_agg, specs))


def _close(p, r, what, partial):
    """Doubles of the double families: a relative 1e-9 (a partial
    column also 1e-9 of its largest magnitude); NaN where NaN."""
    nan = np.isnan(r)
    np.testing.assert_array_equal(np.isnan(p), nan, what)
    scale = np.abs(r[~nan & np.isfinite(r)]).max(initial=0.0) if partial else 0.0
    np.testing.assert_allclose(p[~nan], r[~nan], rtol=1e-9, atol=1e-9 * scale + 1e-12,
                               err_msg=what)


def _live_rows(page):
    import jax.numpy as jnp

    from presto_tpu.page import Block as RefBlock, Page as RefPage

    live = np.nonzero(np.asarray(page.row_mask))[0]
    blocks = tuple(RefBlock(jnp.asarray(np.asarray(b.data)[live]),
                            jnp.asarray(np.asarray(b.valid)[live]), b.type, b.dictionary)
                   for b in page.blocks)
    return RefPage(blocks, jnp.ones(live.shape[0], jnp.bool_))


def _pages_equal(port, ref, aggs, num_keys, mode):
    """Keys and masks exactly; each aggregate's partial state (where
    its count is positive; min_by / max_by's x where its flag is set)
    or final value (where valid) as the module docstring says."""
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
        cols = [(pb.data.numpy(), np.asarray(rb.data)) for pb, rb in
                zip(port.blocks[pos:pos + width], ref.blocks[pos:pos + width])]
        if mode == "single":
            pv, rv = port.blocks[pos].valid.numpy(), np.asarray(ref.blocks[pos].valid)
            np.testing.assert_array_equal(pv[mask], rv[mask], agg.fn)
            lives = [mask & rv]
        elif agg.fn in ("min_by", "max_by"):  # (x, x flag, y, count of y)
            has_y = mask & (cols[3][1] > 0)
            lives = [mask & (cols[1][1] > 0), mask, has_y, mask]
        else:
            lives = [mask & (cols[-1][1] > 0)] * (width - 1) + [mask]
        pos += width
        for (p, r), live in zip(cols, lives):
            p, r = p[live], r[live]
            if agg.fn in DOUBLE_FNS and p.dtype == np.float64:
                _close(p, r, agg.fn, mode == "partial")
            elif p.dtype == np.float64:
                np.testing.assert_array_equal(p.view(np.int64), r.view(np.int64), agg.fn)
            else:
                np.testing.assert_array_equal(p, r.astype(p.dtype), agg.fn)


def _grouped(module, ir, parse_type, page, aggs, path, mode):
    keys = [] if path == "global" else KEY
    kd = KEY_DOMAIN if path == "packed" else [None] if keys else None
    mg = 1 if path == "global" else 64 if path == "packed" else 1 << 16
    return module.grouped_aggregate(page, [build(k, ir, parse_type, COLUMNS) for k in keys],
                                    aggs, mg, key_domains=kd, mode=mode)


def _packed(part):
    """The packed-direct path's aggregates of a run: those without a
    double state (a keyed double state takes the sort path)."""
    return [a for a in PARTS[part] if a[0] not in DOUBLE_FNS] or PARTS[1]


@pytest.mark.parametrize("part", range(len(PARTS)))
@pytest.mark.parametrize("mode", ["partial", "single"])
@pytest.mark.parametrize("path", ["global", "packed", "sorted"])
def test_tail_aggregates_equal_reference(path, mode, part):
    """K2's global and packed-direct slots and K6's sort path (the key
    hashed, no domain), every new state."""
    specs = _packed(part) if path == "packed" else PARTS[part]
    ref_page, port_page, ref_aggs, port_aggs = _both({"global": 21, "packed": 22,
                                                      "sorted": 23}[path] + 10 * part, specs)
    ref = _grouped(ref_agg, ref_ir, ref_type, ref_page, ref_aggs, path, mode)
    got = _grouped(port_agg, port_ir, port_type, port_page, port_aggs, path, mode)
    if path == "sorted":  # both emit each group once, in key order
        ref = _live_rows(ref)
    _pages_equal(got, ref, port_aggs, 0 if path == "global" else 1, mode)


@pytest.mark.parametrize("part", range(len(PARTS)))
def test_merge_equals_reference(part):
    """merge_aggregate of two sort-path partials (K6's merge: Chan's form
    extended to M3 and M4, the covariance sums, checksum's wrapping sum,
    min_by / max_by's extreme and tie), finalized."""
    from presto_tpu.page import concat_pages_host as ref_concat
    from presto_tpu_torch.page import concat_pages_device

    ref_parts, port_parts = [], []
    for seed in (24, 25):
        ref_page, port_page, ref_aggs, port_aggs = _both(seed + 10 * part, PARTS[part])
        ref_parts.append(_grouped(ref_agg, ref_ir, ref_type, ref_page, ref_aggs, "sorted",
                                  "partial"))
        port_parts.append(_grouped(port_agg, port_ir, port_type, port_page, port_aggs,
                                   "sorted", "partial"))
    for mode in ("partial", "single"):
        ref = ref_agg.merge_aggregate(ref_concat(ref_parts), 1, ref_aggs, 1 << 16,
                                      key_domains=[None], mode=mode)
        got = port_agg.merge_aggregate(concat_pages_device(port_parts), 1, port_aggs, 1 << 16,
                                       key_domains=[None], mode=mode)
        _pages_equal(got, _live_rows(ref), port_aggs, 1, mode)


@pytest.mark.parametrize("part", range(len(PARTS)))
@pytest.mark.parametrize("num_keys", [0, 1])
def test_fold_equals_one_pass_and_the_reference_fold_raises(num_keys, part):
    """Two packed partial tables folded (K3's new fold kinds: the
    moments' Chan update, min_by / max_by, the sums) and finalized equal
    the reference's single pass over both pages at once; the
    reference's own combine_packed_states raises on each family (it has
    no branch for them: ROADMAP C)."""
    import jax.numpy as jnp

    from presto_tpu.page import Page as RefPage, concat_pages_host

    specs = PARTS[part] if num_keys == 0 else _packed(part)
    path = "global" if num_keys == 0 else "packed"
    pages = [_both(seed + 10 * part, specs) for seed in (26, 27)]
    port_aggs, ref_aggs = pages[0][3], pages[0][2]
    parts = [_grouped(port_agg, port_ir, port_type, p[1], port_aggs, path, "partial")
             for p in pages]
    got = port_agg.finalize_packed(port_agg.combine_packed_states(parts[0], parts[1], num_keys,
                                                                  port_aggs),
                                   num_keys, port_aggs)
    both = concat_pages_host([p[0] for p in pages])
    both = RefPage(both.blocks, jnp.asarray(both.row_mask))
    want = _grouped(ref_agg, ref_ir, ref_type, both, ref_aggs, path, "single")
    _pages_equal(got, want, port_aggs, num_keys, "single")
    ref_parts = [_grouped(ref_agg, ref_ir, ref_type, p[0], ref_aggs, path, "partial")
                 for p in pages]
    for i in range(len(ref_aggs) - 1):  # every family but count_star
        with pytest.raises(ValueError):
            _fold_one(ref_parts, num_keys, ref_aggs, i)


def _fold_one(parts, num_keys, aggs, i):
    """The reference's fold of aggregate ``i`` alone (its state columns
    cut out of both partial pages)."""
    from presto_tpu.page import Page as RefPage

    pos = num_keys + sum(len(ref_agg.state_types(a)) for a in aggs[:i])
    width = len(ref_agg.state_types(aggs[i]))
    cut = [RefPage(p.blocks[:num_keys] + p.blocks[pos:pos + width], p.row_mask) for p in parts]
    return ref_agg.combine_packed_states(cut[0], cut[1], num_keys, [aggs[i]])


def _small(values, types):
    """A reference page and its port copy from python rows (None: NULL)."""
    import jax.numpy as jnp

    from presto_tpu.page import Block, Page

    n = len(values[0])
    blocks = []
    for col, t in zip(values, types):
        valid = np.array([v is not None for v in col])
        data = np.array([0 if v is None else v for v in col],
                        dtype=np.float64 if t == "double" else np.int64)
        blocks.append(Block(jnp.asarray(data), jnp.asarray(valid), ref_type(t), None))
    page = Page(tuple(blocks), jnp.ones(n, jnp.bool_))
    return page, to_port(page)


def _run_small(page_pair, fn, types, x=0, y=1, keyed=True):
    cols = [(f"c{i}", t) for i, t in enumerate(types)]
    out = []
    for module, ir, parse_type, page in ((ref_agg, ref_ir, ref_type, page_pair[0]),
                                         (port_agg, port_ir, port_type, page_pair[1])):
        a = ir.ColumnRef(type=parse_type(cols[x][1]), index=x)
        a2 = ir.ColumnRef(type=parse_type(cols[y][1]), index=y) if y is not None else None
        agg = ir.AggCall(fn=fn, arg=a, type=parse_type("bigint"), arg2=a2)
        agg = ir.AggCall(fn=fn, arg=a, type=module.output_type(agg), arg2=a2)
        keys = [ir.ColumnRef(type=parse_type("bigint"), index=2)] if keyed else []
        res = module.grouped_aggregate(page, keys, [agg], 1 << 16,
                                       key_domains=[None] if keyed else None, mode="single")
        res = _live_rows(res) if module is ref_agg else res
        b = res.blocks[-1]
        rows = [None if not v else d for d, v in zip(np.asarray(b.data).tolist()
                                                     if module is ref_agg else b.data.tolist(),
                                                     np.asarray(b.valid).tolist()
                                                     if module is ref_agg else b.valid.tolist())]
        out.append(rows)
    return out


def test_min_by_ties_and_nulls():
    """Ties keep the greatest x; a group whose tied rows all have a NULL
    x gives NULL; a group with no valid y gives NULL; a NaN y wins the
    extreme and then ties no row (NULL), as the reference's == does."""
    x = [5, 9, 7, None, None, 3, 4, 8, 2]
    y = [1.0, 1.0, 2.0, 0.5, 0.5, None, None, float("nan"), 0.0]
    g = [1, 1, 1, 2, 2, 3, 3, 4, 4]
    pages = _small([x, y, g], ["bigint", "double", "bigint"])
    for fn, want in (("min_by", [9, None, None, None]), ("max_by", [7, None, None, 8])):
        ref, port = _run_small(pages, fn, ["bigint", "double", "bigint"])
        assert port == ref, fn
        if fn == "min_by":
            assert port == want


def test_checksum_of_nulls_and_doubles():
    """A NULL hashes to the reference's constant, a double by its bits
    (0.0 and -0.0 differ), and the sum wraps; never NULL."""
    v = [0.0, -0.0, None, 1.5, float("inf"), None, 2.0 ** 60]
    g = [1, 1, 1, 2, 2, 3, 3]
    pages = _small([v, v, g], ["double", "double", "bigint"])
    ref, port = _run_small(pages, "checksum", ["double", "double", "bigint"], y=None)
    assert port == ref and None not in port
    pages = _small([[None, None], [0, 0], [1, 1]], ["bigint", "bigint", "bigint"])
    ref, port = _run_small(pages, "checksum", ["bigint", "bigint", "bigint"], y=None)
    assert port == ref == [(2 * port_agg.CHECKSUM_NULL + (1 << 63)) % (1 << 64) - (1 << 63)]


# the reference suites' SQL of these families (tests/test_function_breadth.py)
TAIL_SQL = [
    "select s_nationkey, min_by(s_name, s_acctbal), max_by(s_name, s_acctbal) from supplier "
    "group by s_nationkey",
    "select max_by(c_name, c_acctbal) from customer",
    "select min_by(p_partkey, p_type), max_by(p_partkey, p_type) from part",
    "SELECT checksum(l_orderkey) FROM lineitem",
    "SELECT checksum(l_orderkey) FROM (SELECT l_orderkey FROM lineitem ORDER BY l_orderkey "
    "DESC)",
    "SELECT checksum(l_orderkey) FROM lineitem WHERE l_orderkey > 5",
    "select o_orderpriority, skewness(o_totalprice), kurtosis(o_totalprice) from orders "
    "group by o_orderpriority order by o_orderpriority",
    "SELECT covar_pop(l_extendedprice, l_quantity), covar_samp(l_extendedprice, l_quantity), "
    "corr(l_extendedprice, l_quantity), regr_slope(l_extendedprice, l_quantity), "
    "regr_intercept(l_extendedprice, l_quantity) FROM lineitem",
    "select skewness(o_totalprice), kurtosis(o_totalprice) from orders",
    "select skewness(x) from (values (1.0), (2.0)) t(x)",
    "select kurtosis(x) from (values (1.0), (2.0), (3.0)) t(x)",
    "select skewness(x) from (values (5.0), (5.0), (5.0)) t(x)",
    # the smoke's agg_tail queries, by a small and a large key
    "select l_shipmode, min_by(l_orderkey, l_extendedprice), max_by(l_partkey, l_discount), "
    "skewness(l_quantity), kurtosis(l_extendedprice), covar_samp(l_extendedprice, l_quantity), "
    "corr(l_extendedprice, l_discount), regr_slope(l_extendedprice, l_quantity), "
    "checksum(l_orderkey) from lineitem group by l_shipmode order by l_shipmode",
    "select l_suppkey, min_by(l_orderkey, l_extendedprice), max_by(l_partkey, l_discount), "
    "checksum(l_orderkey), regr_intercept(l_extendedprice, l_quantity) from lineitem "
    "group by l_suppkey order by l_suppkey",
    "select l_returnflag, max_by(l_shipdate, l_receiptdate), checksum(l_shipdate) "
    "from lineitem group by l_returnflag order by l_returnflag",
]

_PAIR = []


def _pair() -> TpchPair:
    if not _PAIR:
        _PAIR.append(TpchPair())
    return _PAIR[0]


@pytest.mark.parametrize("i", range(len(TAIL_SQL)))
def test_tail_sql_equals_reference(i):
    _pair().check(TAIL_SQL[i])
