"""The designs of K6 ``sorted_group_agg`` and K7 ``topn`` in plain torch,
held against their twins on the CPU.

K7 compares rows by an adaptive 64-bit prefix of the ORDER BY tuple
(``topn.order_words_plain``, ``topn.prefix_plain``): live rows sorted by
the prefix, then by the fields past it, must be in ``topn_plain``'s
order, ties broken by row position.  K6 compacts the live rows before
the sort and sorts only their keys (``compact_plain``,
``sorted_group_agg_compact_plain``): keys, states (doubles by their
bits), ``order`` with its dead tail in input order, and ``starts`` must
equal the twin's, which sorts the whole page."""

import numpy as np
import pytest
import torch

from presto_tpu_torch.kernels import keys as pk
from presto_tpu_torch.kernels import sorted_group_agg as k6
from presto_tpu_torch.kernels import topn as k7

I64_MAX = (1 << 63) - 1
I64_MIN = -(1 << 63)


# ---------------------------------------------------------------------------
# K7: the prefix encoding
# ---------------------------------------------------------------------------

def _lexsort(cols):
    """Positions sorted by the columns in turn (the first most
    significant), stable."""
    perm = torch.arange(cols[0].shape[0])
    for c in cols[::-1]:
        perm = perm[torch.argsort(c[perm], stable=True)]
    return perm


def _encoded_order(keys, mask):
    """The live rows in the order of (prefix as unsigned, fields from q
    on)."""
    words = k7.order_words_plain(keys, mask.shape[0])
    prefix, q = k7.prefix_plain(words, mask)
    live = torch.nonzero(mask).flatten()
    cols = [prefix[live] ^ I64_MIN] + [words[live, f] for f in range(q, words.shape[1])]
    return live[_lexsort(cols)], q, words.shape[1]


def _valid(rng, n, rate=0.2):
    return torch.from_numpy(rng.random(n) >= rate)


def _doubles(rng, n, dtype=np.float64):
    x = rng.normal(0, 100, n).astype(dtype)
    pick = rng.random(n) < 0.3
    x[pick] = rng.choice(np.array([0.0, -0.0, np.nan, np.inf, -np.inf, 1.5, -1.5], dtype=dtype),
                         int(pick.sum()))
    return torch.from_numpy(x)


def _lanes(rng, n, k, shared):
    """(n, k) int64 lanes: the first ``shared`` lanes drawn from two
    values, so many rows share their prefix."""
    lanes = rng.integers(I64_MIN, I64_MAX, (n, k), dtype=np.int64)
    if shared:
        lanes[:, :shared] = rng.choice(lanes[:2, :shared], n)
    return torch.from_numpy(lanes)


def _d38(rng, n):
    """Canonical five-limb wide decimals: limb 0 signed, the others in
    [0, 10^9), few distinct high limbs."""
    limbs = np.stack([rng.integers(-2, 2, n)] + [rng.integers(0, 3, n) for _ in range(2)]
                     + [rng.integers(0, 10 ** 9, n) for _ in range(2)], 1)
    return torch.from_numpy(limbs.astype(np.int64))


def _long(rng, n):
    return torch.from_numpy(np.stack([rng.integers(-2, 2, n),
                                      rng.choice([0, 5, 10 ** 17], n)], 1).astype(np.int64))


def _key_cases():
    """name -> make(rng, n) -> keys, each key (data, valid, asc,
    nulls_first)."""
    return {
        "int_nulls_first_desc": lambda rng, n: [
            (torch.from_numpy(rng.integers(-5, 5, n)), _valid(rng, n), False, True)],
        "int_nulls_last_asc": lambda rng, n: [
            (torch.from_numpy(rng.integers(-5, 5, n).astype(np.int32)), _valid(rng, n), True,
             False)],
        "double_signed_zeros_nan": lambda rng, n: [
            (_doubles(rng, n), _valid(rng, n), True, False),
            (_doubles(rng, n), _valid(rng, n), False, True)],
        "real": lambda rng, n: [
            (_doubles(rng, n, np.float32), _valid(rng, n), False, False),
            (torch.from_numpy(rng.integers(0, 4, n)), _valid(rng, n, 0.0), True, False)],
        "smallint_tinyint": lambda rng, n: [
            (torch.from_numpy(rng.integers(-2 ** 15, 2 ** 15, n).astype(np.int16)),
             _valid(rng, n), False, False),
            (torch.from_numpy(rng.integers(-128, 128, n).astype(np.int8)), _valid(rng, n),
             True, True)],
        "long_decimal": lambda rng, n: [(_long(rng, n), _valid(rng, n), False, True),
                                        (torch.from_numpy(rng.integers(9000, 9004, n)
                                                          .astype(np.int32)),
                                         _valid(rng, n, 0.0), True, False)],
        "wide_decimal": lambda rng, n: [(_d38(rng, n), _valid(rng, n), True, False)],
        "raw_shared_prefix": lambda rng, n: [(_lanes(rng, n, 4, 2), _valid(rng, n), True,
                                              False)],
        # more fields than a prefix ranges over (FIELDS)
        "raw_many_lanes": lambda rng, n: [(_lanes(rng, n, 20, 17), _valid(rng, n), False,
                                           True)],
        "bool_first_heavy_ties": lambda rng, n: [
            (torch.from_numpy(rng.random(n) < 0.5), _valid(rng, n, 0.05), False, False),
            (torch.from_numpy(rng.integers(0, 3, n)), _valid(rng, n, 0.0), True, False)],
        # the prefix cannot hold the row: ties on it are refined past it
        "full_range_ties": lambda rng, n: [
            (torch.from_numpy(rng.choice(rng.integers(I64_MIN, I64_MAX, 7, dtype=np.int64),
                                         n)), _valid(rng, n, 0.0), True, False),
            (torch.from_numpy(rng.integers(0, 3, n).astype(np.int32)), _valid(rng, n, 0.0),
             False, False)],
        # a first key of three values 2^40 apart leaves 24 bits to the
        # second, which is cut: rows tie on its high bits, not its low ones
        "cut_field": lambda rng, n: [
            (torch.from_numpy(rng.choice(np.array([0, 1 << 39, (1 << 40) - 1]), n)),
             _valid(rng, n, 0.0), True, False),
            (torch.from_numpy(rng.choice(rng.integers(I64_MIN // 2, I64_MAX // 2, 5,
                                                      dtype=np.int64), n)
                              + rng.integers(0, 1 << 20, n)), _valid(rng, n, 0.0), False,
             False)],
        "flag_then_key": lambda rng, n: [
            (torch.from_numpy(rng.integers(0, 3, n).astype(np.int32)), _valid(rng, n, 0.0),
             False, False),
            (torch.from_numpy(rng.integers(1, 6 * 10 ** 7, n)), _valid(rng, n, 0.0), True,
             False)],
    }


@pytest.mark.parametrize("case", sorted(_key_cases()))
def test_k7_prefix_order_equals_twin(case):
    n = 3000
    rng = np.random.default_rng(len(case))
    keys = _key_cases()[case](rng, n)
    mask = torch.from_numpy(rng.random(n) >= 0.1)
    got, _, _ = _encoded_order(keys, mask)
    live = int(mask.sum())
    ids, count = k7.topn_plain(keys, mask, live)
    assert int(count) == live
    assert torch.equal(got, ids.to(torch.int64))


def test_k7_prefix_is_unique_when_the_row_fits():
    """A three-valued flag and an order key fit the prefix with the row
    position: no two live rows share a prefix, and no field is left."""
    rng = np.random.default_rng(7)
    n = 1 << 14
    keys = _key_cases()["flag_then_key"](rng, n)
    mask = torch.ones(n, dtype=torch.bool)
    words = k7.order_words_plain(keys, n)
    prefix, q = k7.prefix_plain(words, mask)
    assert q == words.shape[1]
    assert torch.unique(prefix).shape[0] == n


def test_k7_prefix_full_range_key_leaves_ties_to_the_next_fields():
    rng = np.random.default_rng(8)
    n = 4000
    keys = _key_cases()["full_range_ties"](rng, n)
    mask = torch.ones(n, dtype=torch.bool)
    got, q, fields = _encoded_order(keys, mask)
    assert q < fields  # ties on the prefix remain
    assert torch.equal(got, k7.topn_plain(keys, mask, n)[0].to(torch.int64))


@pytest.mark.parametrize("live", [0, 1, 5])
def test_k7_prefix_few_live_rows(live):
    rng = np.random.default_rng(live)
    n = 64
    keys = _key_cases()["double_signed_zeros_nan"](rng, n)
    mask = torch.zeros(n, dtype=torch.bool)
    mask[rng.choice(n, live, replace=False)] = True
    got, _, _ = _encoded_order(keys, mask)
    ids, count = k7.topn_plain(keys, mask, 10)
    assert int(count) == live
    assert torch.equal(got[:10], ids[:live].to(torch.int64))


# ---------------------------------------------------------------------------
# K6: compaction before the sort
# ---------------------------------------------------------------------------

def _states(rng, n):
    x = torch.from_numpy(rng.normal(0, 1e3, n))
    v = _valid(rng, n)
    ints = torch.from_numpy(rng.integers(-10 ** 6, 10 ** 6, n))
    long = _long(rng, n)
    wide = _d38(rng, n)
    return [(k6.S_ONE, None, None), (k6.S_SUM, ints, v), (k6.S_DSUM, x, v),
            (k6.S_VAR, x, v), (k6.S_MIN, ints, v), (k6.S_MAX_LONG, long, v),
            (k6.S_LIMBS_SHORT, ints, v), (k6.S_MIN_D38, wide, v), (k6.S_MAX_F64, x, v),
            (k6.S_BY_X, ints, v), (k6.S_BY_XV, None, v), (k6.S_BY_Y_MAX, x, v)]


def _exact_keys(data, valid, lo, card):
    return [(data, valid, lo, card)]


def _key_edge_cases():
    """name -> make(rng, n) -> (keys, row_mask)."""
    def groups(rng, n, domain):
        d = torch.from_numpy(rng.integers(0, domain, n))
        return _exact_keys(d, _valid(rng, n, 0.05), 0, domain + 1)

    def all_dead(rng, n):
        return groups(rng, n, 50), torch.zeros(n, dtype=torch.bool)

    def one_live(rng, n):
        mask = torch.zeros(n, dtype=torch.bool)
        mask[n // 3] = True
        return groups(rng, n, 50), mask

    def long_run(rng, n):  # one group far longer than a warp's tile of 128
        d = torch.from_numpy(np.where(rng.random(n) < 0.7, 3, rng.integers(0, 50, n)))
        return _exact_keys(d, torch.ones(n, dtype=torch.bool), 0, 51), \
            torch.from_numpy(rng.random(n) >= 0.2)

    def near_sentinel(rng, n):  # packed keys at I64_MAX - 1 and just below
        d = torch.from_numpy(rng.choice(np.array([I64_MAX - 2, I64_MAX - 3, 0, 1]), n))
        return _exact_keys(d, _valid(rng, n, 0.05), 0, I64_MAX), \
            torch.from_numpy(rng.random(n) >= 0.3)

    def hashed(rng, n):
        d = torch.from_numpy(rng.integers(-10 ** 9, 10 ** 9, n) // 1000)
        return [(d, _valid(rng, n), 0, 0)], torch.from_numpy(rng.random(n) >= 0.5)

    def mostly_dead(rng, n):  # the probe output's shape: a few live rows in a page
        return groups(rng, n, 10 ** 6), torch.from_numpy(rng.random(n) < 0.01)

    def all_live(rng, n):  # the page is its own compaction
        return groups(rng, n, 1000), torch.ones(n, dtype=torch.bool)

    return {"all_dead": all_dead, "one_live": one_live, "long_run": long_run,
            "near_sentinel": near_sentinel, "hashed": hashed, "mostly_dead": mostly_dead,
            "all_live": all_live}


def _bits(t):
    return t.view(torch.int64) if t.dtype == torch.float64 else t


def _same(a, b, what):
    if isinstance(a, torch.Tensor):
        assert a.dtype == b.dtype and a.shape == b.shape, what
        assert torch.equal(_bits(a), _bits(b)), what
        return
    assert len(a) == len(b), what
    for i, (x, y) in enumerate(zip(a, b)):
        _same(x, y, f"{what}[{i}]")


@pytest.mark.parametrize("presorted", [False, True])
@pytest.mark.parametrize("case", sorted(_key_edge_cases()))
def test_k6_compaction_equals_twin(case, presorted):
    n = 4000
    rng = np.random.default_rng(len(case) + presorted)
    keys, mask = _key_edge_cases()[case](rng, n)
    if presorted:  # streaming aggregation: equal keys arrive together
        perm = torch.argsort(keys[0][0], stable=True)
        keys = [(d[perm], v[perm], lo, card) for d, v, lo, card in keys]
        mask = mask[perm]
    states = _states(rng, n)
    got = k6.sorted_group_agg_compact_plain(keys, mask, states, presorted, runs=True)
    want = k6.sorted_group_agg_plain(keys, mask, states, presorted, runs=True)
    assert got[2] == want[2]
    _same(got[0], want[0], "keys")
    _same(got[1], want[1], "states")
    _same(got[3], want[3], "(order, starts)")


def test_k6_compact_plain_order_is_the_stable_sort_of_the_page():
    """The live rows sorted, then the dead rows' ids in input order: the
    positions the stable sort of the whole page gives them."""
    rng = np.random.default_rng(3)
    n = 5000
    masked = torch.from_numpy(rng.integers(0, 300, n))
    masked[torch.from_numpy(rng.random(n) < 0.4)] = pk.I64_MAX
    sk, order = k6.compact_plain(masked)
    full, perm = torch.sort(masked, stable=True)
    live = int((masked != pk.I64_MAX).sum())
    assert torch.equal(sk, full[:live])
    assert torch.equal(order, perm)
