"""K2, K3 and K6 plain versions (presto_tpu_torch.ops.aggregate) against
the reference's grouped_aggregate, combine_packed_states,
finalize_packed and merge_aggregate: the same numpy pages give the same
partial states and final values, exactly (integer and decimal
arithmetic)."""

import numpy as np
import pytest
import jax.numpy as jnp

from presto_tpu.expr import ir as ref_ir
from presto_tpu.ops import aggregate as ref_agg
from presto_tpu.page import Block as RefBlock, Dictionary as RefDictionary, Page as RefPage
from presto_tpu.types import parse_type as ref_type
from presto_tpu_torch import NotPorted
from presto_tpu_torch.expr import ir as port_ir
from presto_tpu_torch.ops import aggregate as port_agg
from presto_tpu_torch.types import parse_type as port_type
from torch_parity import to_port, with_nulls_and_dead_rows

# columns of the input page: name, type, dictionary values
COLUMNS = [("flag", "varchar", ["R", "A", "N"]), ("status", "varchar", ["O", "F"]),
           ("qty", "decimal(12,2)", None), ("price", "decimal(12,2)", None),
           ("big", "decimal(18,4)", None), ("n", "bigint", None)]
DOMAINS = [(0, 2), (0, 1)]


def _page(seed: int, n: int = 3000, huge: bool = False) -> RefPage:
    rng = np.random.default_rng(seed)
    blocks = []
    for name, t, dv in COLUMNS:
        if dv is not None:
            data = rng.integers(0, len(dv), n).astype(np.int32)
        elif name == "big":
            # near the decimal(18) ceiling: the column's int64 sum wraps
            # many times over, only the limb fold stays exact
            lim = 10 ** 18 - 1 if huge else 10 ** 9
            data = rng.integers(-lim, lim, n)
        elif name == "n":
            data = rng.integers(-(1 << 62), 1 << 62, n) if huge else rng.integers(-99, 99, n)
        else:
            data = rng.integers(0, 10 ** 7, n)
        blocks.append(RefBlock(jnp.asarray(data), jnp.ones(n, jnp.bool_), ref_type(t),
                               RefDictionary(dv) if dv is not None else None))
    page = RefPage(tuple(blocks), jnp.ones(n, jnp.bool_))
    return with_nulls_and_dead_rows(page, rng, null_rate=0.1, dead_rate=0.2)


AGGS = [("count_star", None), ("count", "qty"), ("sum", "qty"), ("sum", "big"),
        ("avg", "price"), ("avg", "big"), ("sum", "n"), ("avg", "qty")]


def _aggs(ir, parse_type, agg_module, names=AGGS):
    out = []
    for fn, col in names:
        if col is None:
            arg = None
        else:
            idx = [c for c, _, _ in COLUMNS].index(col)
            arg = ir.ColumnRef(type=parse_type(COLUMNS[idx][1]), index=idx)
        call = ir.AggCall(fn=fn, arg=arg, type=parse_type("bigint"))
        out.append(ir.AggCall(fn=fn, arg=arg, type=agg_module.output_type(call)))
    return out


def _keys(ir, parse_type):
    return [ir.ColumnRef(type=parse_type("varchar"), index=0),
            ir.ColumnRef(type=parse_type("varchar"), index=1)]


def _both(seed, huge=False):
    ref_page = _page(seed, huge=huge)
    return (ref_page, to_port(ref_page), _aggs(ref_ir, ref_type, ref_agg),
            _aggs(port_ir, port_type, port_agg))


def _same_page(port, ref):
    assert [str(b.type) for b in port.blocks] == [str(b.type) for b in ref.blocks]
    np.testing.assert_array_equal(port.row_mask.numpy(), np.asarray(ref.row_mask))
    for pb, rb in zip(port.blocks, ref.blocks):
        np.testing.assert_array_equal(pb.valid.numpy(), np.asarray(rb.valid))
        np.testing.assert_array_equal(pb.data.numpy(), np.asarray(rb.data))
    assert port.to_pylist() == ref.to_pylist()


@pytest.mark.parametrize("mode", ["partial", "single"])
@pytest.mark.parametrize("huge", [False, True])
def test_global_aggregate(mode, huge):
    ref_page, port_page, ref_aggs, port_aggs = _both(3, huge)
    ref = ref_agg.grouped_aggregate(ref_page, [], ref_aggs, 1, mode=mode)
    got = port_agg.grouped_aggregate(port_page, [], port_aggs, 1, mode=mode)
    _same_page(got, ref)


@pytest.mark.parametrize("mode", ["partial", "single"])
@pytest.mark.parametrize("huge", [False, True])
def test_packed_direct_aggregate(mode, huge):
    """Q1's shape: two dictionary keys with NULLs, 4 x 3 = 12 slots
    inside a 16-slot table, dead rows, long-decimal sums."""
    ref_page, port_page, ref_aggs, port_aggs = _both(4, huge)
    ref = ref_agg.grouped_aggregate(ref_page, _keys(ref_ir, ref_type), ref_aggs, 16,
                                    key_domains=DOMAINS, mode=mode)
    got = port_agg.grouped_aggregate(port_page, _keys(port_ir, port_type), port_aggs, 16,
                                     key_domains=DOMAINS, mode=mode)
    _same_page(got, ref)


@pytest.mark.parametrize("num_keys", [0, 2])
@pytest.mark.parametrize("huge", [False, True])
def test_fold_and_finalize(num_keys, huge):
    """combine_packed_states of two splits' partials, then
    finalize_packed, on both packages."""
    parts = []
    for seed in (5, 6):
        ref_page, port_page, ref_aggs, port_aggs = _both(seed, huge)
        keys = (_keys(ref_ir, ref_type), _keys(port_ir, port_type)) if num_keys else ([], [])
        mg = 16 if num_keys else 1
        kd = DOMAINS if num_keys else None
        parts.append((
            ref_agg.grouped_aggregate(ref_page, keys[0], ref_aggs, mg, key_domains=kd,
                                      mode="partial"),
            port_agg.grouped_aggregate(port_page, keys[1], port_aggs, mg, key_domains=kd,
                                       mode="partial")))
    ref_fold = ref_agg.combine_packed_states(parts[0][0], parts[1][0], num_keys, ref_aggs)
    port_fold = port_agg.combine_packed_states(parts[0][1], parts[1][1], num_keys, port_aggs)
    _same_page(port_fold, ref_fold)
    _same_page(port_agg.finalize_packed(port_fold, num_keys, port_aggs),
               ref_agg.finalize_packed(ref_fold, num_keys, ref_aggs))


def test_type_helpers_match_reference():
    """The binder's and planner's type helpers are exact copies."""
    names = AGGS + [("min", "qty"), ("max", "flag"), ("stddev", "n")]
    for ra, pa in zip(_aggs(ref_ir, ref_type, ref_agg, names),
                      _aggs(port_ir, port_type, port_agg, names)):
        assert str(port_agg.output_type(pa)) == str(ref_agg.output_type(ra))
        assert [str(t) for t in port_agg.state_types(pa)] == \
            [str(t) for t in ref_agg.state_types(ra)]


@pytest.mark.parametrize("fn,col", [("min", "flag"), ("stddev", "flag")], ids=["min", "stddev"])
def test_unported_aggregates_raise(fn, col):
    """min/max over numbers is ported (test_torch_minmax.py), and the
    variance family over numbers (test_torch_tpcds_kernels.py); over
    varchar neither is."""
    _, port_page, _, _ = _both(7)
    aggs = _aggs(port_ir, port_type, port_agg, [(fn, col)])
    with pytest.raises(NotPorted):
        port_agg.grouped_aggregate(port_page, [], aggs, 1, mode="single")


def test_sort_path_grouping_raises():
    """Once NotPorted: a key without a known domain takes the
    reference's hash branch (K9) into the sort path; the groups come out
    in hash order, equal to the reference's."""
    ref_page, port_page, ref_aggs, port_aggs = _both(8)
    ref_key = [ref_ir.ColumnRef(type=ref_type("bigint"), index=5)]
    key = [port_ir.ColumnRef(type=port_type("bigint"), index=5)]
    ref = ref_agg.grouped_aggregate(ref_page, ref_key, ref_aggs, 1 << 16,
                                    key_domains=[None], mode="partial")
    got = port_agg.grouped_aggregate(port_page, key, port_aggs, 1 << 16,
                                     key_domains=[None], mode="partial")
    _live_rows_equal(got, ref)


def test_hashed_keys_equal_pack_or_hash_keys():
    """K9's plain version, position by position, against the
    reference's hash branch: int64, int32 dictionary codes, dates and
    booleans, with NULLs; and its masking (dead rows, NULL keys)."""
    import torch

    from presto_tpu_torch.kernels import keys as pk

    rng = np.random.default_rng(30)
    n = 4000
    cols = [rng.integers(-(1 << 63), (1 << 63) - 1, n, dtype=np.int64),
            rng.integers(0, 4096, n).astype(np.int32),
            rng.integers(8000, 11000, n).astype(np.int32), rng.random(n) < 0.5]
    valids = [rng.random(n) >= 0.1 for _ in cols]
    mask = rng.random(n) >= 0.2
    want, exact = ref_agg.pack_or_hash_keys([jnp.asarray(c) for c in cols],
                                            [jnp.asarray(v) for v in valids], [None] * 4)
    assert not exact
    keys = [(torch.from_numpy(c), torch.from_numpy(v), 0, 0) for c, v in zip(cols, valids)]
    got, ok = pk.pack_plain(keys, n, "cpu")
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert (got.numpy() >= 0).all()
    for sentinel in (False, True):
        masked = pk.hash_keys(keys, torch.from_numpy(mask), null_as_sentinel=sentinel).numpy()
        keep = mask & (ok.numpy() if sentinel else True)
        np.testing.assert_array_equal(masked[keep], np.asarray(want)[keep])
        assert (masked[~keep] == pk.I64_MAX).all()


DUP_WORDS = ["b", "a", "b", "c", "a"]  # a dictionary that repeats values


@pytest.mark.parametrize("mode", ["partial", "single"])
def test_hashed_grouping_over_repeated_dictionary_values(mode):
    """Two codes of one value group together (canonical codes, as the
    reference's canonicalize_codes), in hash order with a bigint key
    past the exact domain."""
    rng = np.random.default_rng(31)
    base = _page(31)
    n = base.capacity
    dup = RefBlock(jnp.asarray(rng.integers(0, len(DUP_WORDS), n).astype(np.int32)),
                   jnp.asarray(rng.random(n) >= 0.05), ref_type("varchar"),
                   RefDictionary(DUP_WORDS))
    ref_page = RefPage(base.blocks + (dup,), base.row_mask)
    ref_keys = [ref_ir.ColumnRef(type=ref_type("varchar"), index=6),
                ref_ir.ColumnRef(type=ref_type("bigint"), index=5)]
    keys = [port_ir.ColumnRef(type=port_type("varchar"), index=6),
            port_ir.ColumnRef(type=port_type("bigint"), index=5)]
    kd = [(0, 4), None]
    ref_aggs, port_aggs = _aggs(ref_ir, ref_type, ref_agg), _aggs(port_ir, port_type, port_agg)
    ref = ref_agg.grouped_aggregate(ref_page, ref_keys, ref_aggs, 4096, key_domains=kd,
                                    mode=mode)
    got = port_agg.grouped_aggregate(to_port(ref_page), keys, port_aggs, 4096,
                                     key_domains=kd, mode=mode)
    _live_rows_equal(got, ref)
    live = np.asarray(ref.row_mask)
    np.testing.assert_array_equal(got.blocks[0].data.numpy(),
                                  np.asarray(ref.blocks[0].data)[live])  # canonical codes


# -- the sort path (K6) ------------------------------------------------------

# Q3's shape: a wide bigint key, a date and a tiny bigint, with NULL
# keys; the domain product (2001 * 13 * 4) is far past DIRECT_GROUP_LIMIT
SORT_DOMAINS = [(0, 1999), (9000, 9010), (0, 2)]


def _sort_keys(ir, parse_type):
    return [ir.ColumnRef(type=parse_type("bigint"), index=6),
            ir.ColumnRef(type=parse_type("date"), index=7),
            ir.ColumnRef(type=parse_type("bigint"), index=8)]


def _sort_page(seed: int, huge: bool) -> RefPage:
    rng = np.random.default_rng(seed)
    base = _page(seed, huge=huge)
    n = base.capacity
    extra = [(rng.integers(0, 2000, n) // 3, "bigint"),
             (rng.integers(9000, 9011, n).astype(np.int32), "date"),
             (rng.integers(0, 3, n), "bigint")]
    blocks = list(base.blocks)
    for data, t in extra:
        valid = rng.random(n) >= 0.05
        blocks.append(RefBlock(jnp.asarray(data), jnp.asarray(valid), ref_type(t)))
    return RefPage(tuple(blocks), base.row_mask)


def _live_rows_equal(port, ref):
    """Pages agree under the Page contract: the same live rows in the
    same order (decimals as Decimal, NULLs as None)."""
    assert [str(b.type) for b in port.blocks] == [str(b.type) for b in ref.blocks]
    assert port.to_pylist() == ref.to_pylist()
    assert len(port.to_pylist()) > 100


@pytest.mark.parametrize("mode", ["partial", "single"])
@pytest.mark.parametrize("huge", [False, True])
def test_sort_path_aggregate(mode, huge):
    """Groups in packed-key order; ``huge`` makes the decimal(18,4)
    sums wrap int64 many times over, so only the limb sums are exact."""
    ref_page = _sort_page(9, huge)
    ref_aggs, port_aggs = _aggs(ref_ir, ref_type, ref_agg), _aggs(port_ir, port_type, port_agg)
    ref = ref_agg.grouped_aggregate(ref_page, _sort_keys(ref_ir, ref_type), ref_aggs, 4096,
                                    key_domains=SORT_DOMAINS, mode=mode)
    got = port_agg.grouped_aggregate(to_port(ref_page), _sort_keys(port_ir, port_type),
                                     port_aggs, 4096, key_domains=SORT_DOMAINS, mode=mode)
    _live_rows_equal(got, ref)


def test_sort_path_partial_emits_groups_past_max_groups():
    """The reference truncates a partial to ``max_groups`` and retries
    larger; the port sizes its output from the groups it finds, so a
    small ``max_groups`` still gives every group."""
    ref_page = _sort_page(10, False)
    ref_aggs, port_aggs = _aggs(ref_ir, ref_type, ref_agg), _aggs(port_ir, port_type, port_agg)
    ref = ref_agg.grouped_aggregate(ref_page, _sort_keys(ref_ir, ref_type), ref_aggs, 4096,
                                    key_domains=SORT_DOMAINS, mode="partial")
    got = port_agg.grouped_aggregate(to_port(ref_page), _sort_keys(port_ir, port_type),
                                     port_aggs, 64, key_domains=SORT_DOMAINS, mode="partial")
    assert got.capacity > 64
    _live_rows_equal(got, ref)


@pytest.mark.parametrize("mode", ["partial", "single"])
@pytest.mark.parametrize("huge", [False, True])
def test_merge_aggregate(mode, huge):
    """Two splits' sort-path partials concatenated and merged."""
    _merge(mode, huge, hashed=False)


@pytest.mark.parametrize("mode", ["partial", "single"])
@pytest.mark.parametrize("huge", [False, True])
def test_hashed_merge_aggregate(mode, huge):
    """As test_merge_aggregate with the first key without a domain: the
    partials and the merge hash (K9), the merge hashing the partials'
    key columns again, so equal groups from the two splits meet."""
    _merge(mode, huge, hashed=True)


def _merge(mode, huge, hashed):
    from presto_tpu.exec.local import concat_pages_device as ref_concat
    from presto_tpu_torch.page import concat_pages_device as port_concat

    ref_aggs, port_aggs = _aggs(ref_ir, ref_type, ref_agg), _aggs(port_ir, port_type, port_agg)
    kd = [None] + SORT_DOMAINS[1:] if hashed else SORT_DOMAINS
    ref_parts, port_parts = [], []
    for seed in (11, 12):
        ref_page = _sort_page(seed, huge)
        ref_parts.append(ref_agg.grouped_aggregate(
            ref_page, _sort_keys(ref_ir, ref_type), ref_aggs, 4096,
            key_domains=kd, mode="partial"))
        port_parts.append(port_agg.grouped_aggregate(
            to_port(ref_page), _sort_keys(port_ir, port_type), port_aggs, 4096,
            key_domains=kd, mode="partial"))
    ref = ref_agg.merge_aggregate(ref_concat(ref_parts), 3, ref_aggs, 8192,
                                  key_domains=kd, mode=mode)
    got = port_agg.merge_aggregate(port_concat(port_parts), 3, port_aggs, 8192,
                                   key_domains=kd, mode=mode)
    _live_rows_equal(got, ref)


@pytest.mark.parametrize("t, error", [("decimal(36,4)", ValueError)])
def test_hashed_key_types_outside_the_port(t, error):
    """A long-decimal key raises in both packages."""
    import torch

    from presto_tpu_torch.page import Block, Page

    n = 64
    data = torch.zeros((n, 2), dtype=torch.int64)
    page = Page((Block(data, torch.ones(n, dtype=torch.bool), port_type(t)),),
                torch.ones(n, dtype=torch.bool))
    aggs = _aggs(port_ir, port_type, port_agg, [("count_star", None)])
    with pytest.raises(error):
        port_agg.grouped_aggregate(page, [port_ir.ColumnRef(type=port_type(t), index=0)],
                                   aggs, 1 << 16, key_domains=[None], mode="partial")


def test_double_keys_truncate_as_the_reference_known_fault():
    """Pins a known fault of the reference (ROADMAP queue C), which the
    port keeps: a double key hashes its value truncated to int64, as the
    reference's pack_or_hash_keys does, so 0.25 and 0.75 share a group
    (its first row's key), which is not SQL's answer; 1.5 and -1.5 do
    not.  A fix in both packages (hashing the double's bits) flips this
    test on purpose."""
    import jax.numpy as jnp

    from presto_tpu.page import Block as RefBlock, Page as RefPage

    n = 64
    rng = np.random.default_rng(11)
    x = rng.choice([0.25, 0.75, 1.5, -1.5, 2.0, 7.125], n)
    v = rng.random(n) > 0.1
    ref_page = RefPage((RefBlock(jnp.asarray(x), jnp.asarray(v), ref_type("double")),),
                       jnp.ones(n, jnp.bool_))
    names = [("count_star", None)]
    want = ref_agg.grouped_aggregate(ref_page, [ref_ir.ColumnRef(type=ref_type("double"), index=0)],
                                     _aggs(ref_ir, ref_type, ref_agg, names), 1 << 16,
                                     key_domains=[None], mode="single")
    got = port_agg.grouped_aggregate(to_port(ref_page),
                                     [port_ir.ColumnRef(type=port_type("double"), index=0)],
                                     _aggs(port_ir, port_type, port_agg, names), 1 << 16,
                                     key_domains=[None], mode="single")
    assert sorted(got.to_pylist(), key=repr) == sorted(want.to_pylist(), key=repr)
    assert len(got.to_pylist()) == 6  # NULL, {0.25, 0.75}, 1.5, -1.5, 2.0, 7.125
