"""The eighth slice's aggregates: min/max over doubles, booleans and
dictionary varchar (collation ranks), bool_and / bool_or / every,
bitwise_and_agg / bitwise_or_agg, hll_merge (approx_distinct's outer
level) and an aggregate's FILTER (count_if), through K2's packed
slots, K6's sorted runs, K6's merge and K3's fold and finalize (their
plain twins on the CPU), against the reference's ``grouped_aggregate``,
``merge_aggregate``, ``combine_packed_states`` and ``finalize_packed``
over seeded pages with NULLs and dead rows (the reference suites'
aggregate SQL is in ``test_torch_function_agg_sql.py``).

Tolerances: states and results are exact (a state's value where its
count is positive: an empty state holds each package's own identity),
but hll_merge's double sum of 2^-rho (relative 1e-12: the reference's
exp2 misses the last bit, the port's weights are exact; the estimate
rounds to the same integer)."""

import numpy as np
import pytest

from presto_tpu.expr import ir as ref_ir
from presto_tpu.ops import aggregate as ref_agg
from presto_tpu.types import parse_type as ref_type
from presto_tpu_torch.expr import ir as port_ir
from presto_tpu_torch.ops import aggregate as port_agg
from presto_tpu_torch.types import parse_type as port_type
from torch_fn_parity import COLUMNS, C, F, L, build, function_page
from torch_parity import to_port

# (fn, argument spec, filter spec or None)
AGGS = [
    ("min", C("x"), None), ("max", C("x"), None),
    ("min", C("f"), None), ("max", C("f"), None),
    ("min", C("s"), None), ("max", C("s"), None),
    ("bool_and", C("f"), None), ("bool_or", C("f"), None), ("every", C("f"), None),
    ("bitwise_and_agg", C("a"), None), ("bitwise_or_agg", C("a"), None),
    ("bitwise_or_agg", C("i"), None),
    ("count_star", None, F("gt", "boolean", C("a"), L(0, "bigint"))),
    ("count", C("d"), C("f")),
    ("sum", C("d"), F("lt", "boolean", C("x"), L(0.0, "double"))),
    ("max", C("x"), C("f")),
    ("count_star", None, None),
]
HLL = [("hll_merge", F("add", "bigint", C("k"), L(1, "bigint")), None), ("count_star", None, None)]
# the reference's combine_packed_states has no bool_and / bool_or /
# every (or hll_merge) branch: they fall into its variance branch and
# raise (a reference fault, ROADMAP C); the fold test leaves them out
# and test_fold_of_bool_states_equals_one_pass holds the port's fold
BOOL_FNS = ("bool_and", "bool_or", "every")
FOLD_AGGS = [a for a in AGGS if a[0] not in BOOL_FNS]


def _aggs(ir, parse_type, agg_module, specs):
    out = []
    for fn, arg, filt in specs:
        a = build(arg, ir, parse_type, COLUMNS) if arg is not None else None
        f = build(filt, ir, parse_type, COLUMNS) if filt is not None else None
        call = ir.AggCall(fn=fn, arg=a, type=parse_type("bigint"), filter=f)
        out.append(ir.AggCall(fn=fn, arg=a, type=agg_module.output_type(call), filter=f))
    return out


def _states_equal(port, ref, aggs, num_keys, mode):
    """Two aggregation pages agree: keys and row masks exactly; a
    partial state where its count is positive (doubles by their bits,
    hll_merge's sum within a relative 1e-12), counts exactly; a final
    value where valid."""
    assert [str(b.type) for b in port.blocks] == [str(b.type) for b in ref.blocks]
    mask = np.asarray(ref.row_mask)
    np.testing.assert_array_equal(port.row_mask.numpy(), mask)
    for pb, rb in zip(port.blocks[:num_keys], ref.blocks[:num_keys]):
        np.testing.assert_array_equal(pb.valid.numpy()[mask], np.asarray(rb.valid)[mask])
        ok = mask & np.asarray(rb.valid)
        np.testing.assert_array_equal(pb.data.numpy()[ok], np.asarray(rb.data)[ok])
    pos = num_keys
    for agg in aggs:
        width = len(port_agg.state_types(agg)) if mode == "partial" else 1
        cols = list(zip(port.blocks[pos:pos + width], ref.blocks[pos:pos + width]))
        pos += width
        if mode == "partial":
            live = mask & (np.asarray(cols[-1][1].data) > 0)
            np.testing.assert_array_equal(cols[-1][0].data.numpy()[mask],
                                          np.asarray(cols[-1][1].data)[mask])
        else:
            live = mask & np.asarray(cols[0][1].valid)
            np.testing.assert_array_equal(cols[0][0].valid.numpy()[mask],
                                          np.asarray(cols[0][1].valid)[mask], agg.fn)
        for pb, rb in cols:
            p, r = pb.data.numpy()[live], np.asarray(rb.data)[live]
            if agg.fn == "hll_merge" and p.dtype == np.float64:
                np.testing.assert_allclose(p, r, rtol=1e-12, atol=0)
            elif p.dtype == np.float64:
                np.testing.assert_array_equal(p.view(np.int64), r.view(np.int64), agg.fn)
            else:
                np.testing.assert_array_equal(p, r.astype(p.dtype), agg.fn)


def _both(seed, specs=AGGS, nan=False):
    ref_page = function_page(seed, nan=nan)
    return (ref_page, to_port(ref_page), _aggs(ref_ir, ref_type, ref_agg, specs),
            _aggs(port_ir, port_type, port_agg, specs))


KEY = [C("k")]
KEY_DOMAIN = [(0, 39)]


@pytest.mark.parametrize("mode", ["partial", "single"])
@pytest.mark.parametrize("path", ["global", "packed", "sorted"])
def test_function_aggregates_equal_reference(path, mode):
    """K2's global and packed-direct slots and K6's sort path (the key
    hashed, no domain), every new state and the filter lane."""
    ref_page, port_page, ref_aggs, port_aggs = _both({"global": 1, "packed": 2,
                                                      "sorted": 3}[path])
    keys = [] if path == "global" else KEY
    kd = KEY_DOMAIN if path == "packed" else [None] if keys else None
    mg = 1 if path == "global" else 64 if path == "packed" else 1 << 16
    ref = ref_agg.grouped_aggregate(ref_page, [build(k, ref_ir, ref_type, COLUMNS)
                                               for k in keys], ref_aggs, mg,
                                    key_domains=kd, mode=mode)
    got = port_agg.grouped_aggregate(port_page, [build(k, port_ir, port_type, COLUMNS)
                                                 for k in keys], port_aggs, mg,
                                     key_domains=kd, mode=mode)
    if path == "sorted":  # both emit each group once, in key order
        assert got.capacity == int(np.asarray(ref.row_mask).sum())
        ref = ref.compact() if hasattr(ref, "compact") else ref
    _states_equal(got, ref, port_aggs, len(keys), mode) if path != "sorted" else \
        _sorted_equal(got, ref, port_aggs, mode)


def _sorted_equal(got, ref, aggs, mode):
    """The sort path's page against the reference's, row for row over
    the reference's live rows (its page may be padded)."""
    import jax.numpy as jnp

    from presto_tpu.page import Block as RefBlock, Page as RefPage

    live = np.nonzero(np.asarray(ref.row_mask))[0]
    blocks = tuple(RefBlock(jnp.asarray(np.asarray(b.data)[live]),
                            jnp.asarray(np.asarray(b.valid)[live]), b.type, b.dictionary)
                   for b in ref.blocks)
    _states_equal(got, RefPage(blocks, jnp.ones(live.shape[0], jnp.bool_)), aggs, 1, mode)


@pytest.mark.parametrize("num_keys", [0, 1])
def test_fold_and_finalize_equal_reference(num_keys):
    """combine_packed_states of two splits' partials (K3's new fold
    kinds: double, boolean and bitwise), then finalize_packed (boolean
    results, varchar ranks back to codes)."""
    parts = []
    for seed in (4, 5):
        ref_page, port_page, ref_aggs, port_aggs = _both(seed, FOLD_AGGS)
        keys = KEY if num_keys else []
        mg = 64 if num_keys else 1
        kd = KEY_DOMAIN if num_keys else None
        parts.append((
            ref_agg.grouped_aggregate(ref_page, [build(k, ref_ir, ref_type, COLUMNS)
                                                 for k in keys], ref_aggs, mg,
                                      key_domains=kd, mode="partial"),
            port_agg.grouped_aggregate(port_page, [build(k, port_ir, port_type, COLUMNS)
                                                   for k in keys], port_aggs, mg,
                                       key_domains=kd, mode="partial")))
    ref_fold = ref_agg.combine_packed_states(parts[0][0], parts[1][0], num_keys, ref_aggs)
    port_fold = port_agg.combine_packed_states(parts[0][1], parts[1][1], num_keys, port_aggs)
    _states_equal(port_fold, ref_fold, port_aggs, num_keys, "partial")
    _states_equal(port_agg.finalize_packed(port_fold, num_keys, port_aggs),
                  ref_agg.finalize_packed(ref_fold, num_keys, ref_aggs), port_aggs, num_keys,
                  "single")


def test_merge_equals_reference():
    """merge_aggregate of two sort-path partials (K6's merge of the new
    states), finalized."""
    from presto_tpu.page import concat_pages_host as ref_concat
    from presto_tpu_torch.page import concat_pages_device

    ref_parts, port_parts = [], []
    for seed in (6, 7):
        ref_page, port_page, ref_aggs, port_aggs = _both(seed)
        ref_parts.append(ref_agg.grouped_aggregate(
            ref_page, [build(KEY[0], ref_ir, ref_type, COLUMNS)], ref_aggs, 1 << 16,
            key_domains=[None], mode="partial"))
        port_parts.append(port_agg.grouped_aggregate(
            port_page, [build(KEY[0], port_ir, port_type, COLUMNS)], port_aggs, 1 << 16,
            key_domains=[None], mode="partial"))
    ref = ref_agg.merge_aggregate(ref_concat(ref_parts), 1, ref_aggs, 1 << 16,
                                  key_domains=[None], mode="single")
    got = port_agg.merge_aggregate(concat_pages_device(port_parts), 1, port_aggs, 1 << 16,
                                   key_domains=[None], mode="single")
    _sorted_equal(got, ref, port_aggs, "single")


@pytest.mark.parametrize("num_keys", [0, 1])
def test_fold_of_bool_states_equals_one_pass(num_keys):
    """bool_and / bool_or / every folded across two partial tables (K3
    adds their counts) and finalized equal the reference's single pass
    over both pages at once; the reference's own fold raises on them."""
    import jax.numpy as jnp

    from presto_tpu.page import Page as RefPage, concat_pages_host

    specs = [a for a in AGGS if a[0] in BOOL_FNS]
    pages = [_both(seed, specs) for seed in (10, 11)]
    keys = KEY if num_keys else []
    mg = 64 if num_keys else 1
    kd = KEY_DOMAIN if num_keys else None
    port_aggs, ref_aggs = pages[0][3], pages[0][2]
    parts = [port_agg.grouped_aggregate(p[1], [build(k, port_ir, port_type, COLUMNS)
                                               for k in keys], port_aggs, mg,
                                        key_domains=kd, mode="partial") for p in pages]
    got = port_agg.finalize_packed(port_agg.combine_packed_states(parts[0], parts[1], num_keys,
                                                                  port_aggs),
                                   num_keys, port_aggs)
    both = concat_pages_host([p[0] for p in pages])
    both = RefPage(both.blocks, jnp.asarray(both.row_mask))
    want = ref_agg.grouped_aggregate(both, [build(k, ref_ir, ref_type, COLUMNS)
                                            for k in keys], ref_aggs, mg, key_domains=kd,
                                     mode="single")
    _states_equal(got, want, port_aggs, num_keys, "single")
    ref_parts = [ref_agg.grouped_aggregate(p[0], [build(k, ref_ir, ref_type, COLUMNS)
                                                  for k in keys], ref_aggs, mg,
                                           key_domains=kd, mode="partial") for p in pages]
    with pytest.raises(ValueError):
        ref_agg.combine_packed_states(ref_parts[0], ref_parts[1], num_keys, ref_aggs)


@pytest.mark.parametrize("path", ["global", "sorted"])
def test_hll_merge_equals_reference(path):
    """hll_merge's (sum of 2^-rho, present buckets) state and its
    estimate (linear counting below 2.5 m), K2's global slot and K6's
    sorted runs: equal estimates."""
    ref_page, port_page, ref_aggs, port_aggs = _both(8, HLL)
    keys = [] if path == "global" else [C("b")]
    kd = None if path == "global" else [None]
    mg = 1 if path == "global" else 1 << 16
    for mode in ("partial", "single"):
        ref = ref_agg.grouped_aggregate(ref_page, [build(k, ref_ir, ref_type, COLUMNS)
                                                   for k in keys], ref_aggs, mg,
                                        key_domains=kd, mode=mode)
        got = port_agg.grouped_aggregate(port_page, [build(k, port_ir, port_type, COLUMNS)
                                                     for k in keys], port_aggs, mg,
                                         key_domains=kd, mode=mode)
        if keys:
            _sorted_equal(got, ref, port_aggs, mode)
        else:
            _states_equal(got, ref, port_aggs, 0, mode)


def test_double_extremes_follow_the_reference():
    """min/max over doubles with NaN and signed zeros: NaN wins both
    (the reference's segment reductions propagate it) and -0.0 orders
    below 0.0, on K2's slots and K6's runs."""
    specs = [("min", C("x"), None), ("max", C("x"), None), ("count_star", None, None)]
    ref_page, port_page, ref_aggs, port_aggs = _both(9, specs, nan=True)
    for keys, kd, mg in (([], None, 1), (KEY, KEY_DOMAIN, 64), (KEY, [None], 1 << 16)):
        ref = ref_agg.grouped_aggregate(ref_page, [build(k, ref_ir, ref_type, COLUMNS)
                                                   for k in keys], ref_aggs, mg,
                                        key_domains=kd, mode="single")
        got = port_agg.grouped_aggregate(port_page, [build(k, port_ir, port_type, COLUMNS)
                                                     for k in keys], port_aggs, mg,
                                         key_domains=kd, mode="single")
        live = np.asarray(ref.row_mask)
        r = [np.asarray(b.data)[live] for b in ref.blocks[len(keys):len(keys) + 2]]
        g = [b.data.numpy()[got.row_mask.numpy()] for b in got.blocks[len(keys):len(keys) + 2]]
        for x, y in zip(g, r):
            assert np.array_equal(np.isnan(x), np.isnan(y)) and np.isnan(y).any()
            np.testing.assert_array_equal(np.signbit(x[~np.isnan(x)]),
                                          np.signbit(y[~np.isnan(y)]))
            np.testing.assert_array_equal(x[~np.isnan(x)], y[~np.isnan(y)])
