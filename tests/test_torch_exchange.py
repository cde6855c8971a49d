"""The mesh tier's exchange (``presto_tpu_torch/parallel/exchange.py``,
K21 ``exchange_partition``'s plain twin on the CPU) against the
reference's ``presto_tpu/parallel/exchange.py``, bit for bit: targets,
bucket layout, valid bits, row mask and fill, with overflow, dead rows,
limb and raw-lane columns, and keys whose top bit is set; then the
all-to-all and the all-gather against the reference's under
``shard_map`` over the 8 virtual CPU devices."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parity  # noqa: F401  (one torch thread per process)
from presto_tpu.connectors.tpch import Tpch as RefTpch
from presto_tpu.expr.ir import ColumnRef as RefCol
from presto_tpu.page import Block as RefBlock
from presto_tpu.page import Page as RefPage
from presto_tpu.parallel import exchange as ref_ex
from presto_tpu.types import parse_type as ref_type
from presto_tpu_torch.expr.ir import ColumnRef
from presto_tpu_torch.kernels import exchange_partition as k21
from presto_tpu_torch.kernels import keys as pk
from presto_tpu_torch.page import Block, Page
from presto_tpu_torch.parallel import exchange as ex
from presto_tpu_torch.parallel.mesh import make_mesh
from presto_tpu_torch.types import parse_type
from torch_parity import to_port, with_nulls_and_dead_rows

SPLIT = 4096


@pytest.fixture(scope="module")
def lineitem():
    """Eight reference lineitem splits (one capacity), with NULLs
    and dead rows in the first."""
    conn = RefTpch(sf=0.01, split_rows=SPLIT)
    cap = conn.max_split_rows("lineitem")
    pages = [conn.page_for_split("lineitem", s, capacity=cap) for s in range(8)]
    pages[0] = with_nulls_and_dead_rows(pages[0], np.random.default_rng(5))
    return pages


# (column index, type) of lineitem's l_orderkey, l_partkey, l_returnflag,
# l_shipmode, l_shipdate
KEYS = {
    "orderkey_hashed": ([(0, "bigint")], None),
    "orderkey_exact": ([(0, "bigint")], [(1, 60000)]),
    "two_keys_hashed": ([(0, "bigint"), (1, "bigint")], None),
    "shipmode": ([(14, "varchar")], None),
    "flag_and_date": ([(8, "varchar"), (10, "date")], None),
}


def _keys(spec, port: bool):
    mk = ColumnRef if port else RefCol
    pt = parse_type if port else ref_type
    return [mk(type=pt(t), index=i) for i, t in spec]


def _same_page(ref: RefPage, port: Page, what: str):
    np.testing.assert_array_equal(port.row_mask.numpy(), np.asarray(ref.row_mask),
                                  err_msg=f"{what} mask")
    for i, (rb, pb) in enumerate(zip(ref.blocks, port.blocks)):
        np.testing.assert_array_equal(pb.valid.numpy(), np.asarray(rb.valid),
                                      err_msg=f"{what} valid {i}")
        np.testing.assert_array_equal(pb.data.numpy(), np.asarray(rb.data),
                                      err_msg=f"{what} data {i}")


@pytest.mark.parametrize("name", sorted(KEYS))
@pytest.mark.parametrize("n_parts", [1, 3, 8])
def test_partition_targets_match_reference(lineitem, name, n_parts):
    spec, domains = KEYS[name]
    ref = lineitem[0]
    want = np.asarray(ref_ex.partition_targets(ref, _keys(spec, False), n_parts, domains))
    got = ex.partition_targets(to_port(ref), _keys(spec, True), n_parts, domains)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("name", ["orderkey_hashed", "shipmode", "flag_and_date"])
@pytest.mark.parametrize("cap", [1024, 300, 1])
def test_partition_for_exchange_matches_reference(lineitem, name, cap):
    """The bucket layout bit for bit, at a bucket past the fill and below
    it (rows dropped: fill > bucket_cap), from the reference's targets
    and through the port's one-pass ``partition_page``."""
    spec, domains = KEYS[name]
    ref = lineitem[0]
    t = ref_ex.partition_targets(ref, _keys(spec, False), 8, domains)
    want, wfill = ref_ex.partition_for_exchange(ref, t, 8, cap)
    port = to_port(ref)
    got, fill = ex.partition_for_exchange(port, torch.from_numpy(np.array(t)), 8, cap)
    assert int(fill) == int(wfill)
    _same_page(want, got, "given targets")
    got2, fill2 = ex.partition_page(port, _keys(spec, True), 8, cap, domains)
    assert int(fill2) == int(wfill)
    _same_page(want, got2, "one pass")
    if cap < 300:
        assert int(fill) > cap


def _wide_pages(n: int, seed: int):
    """A reference page and its port twin with an int64 key, two-limb and
    five-limb decimals and a raw varchar's byte lanes, NULLs and dead
    rows."""
    rng = np.random.default_rng(seed)
    key = rng.integers(-(1 << 62), 1 << 62, n) * 2
    key[::5] |= np.int64(-(1 << 63))  # the top bit set
    cols = [(key, "bigint"),
            (rng.integers(-10 ** 9, 10 ** 9, (n, 2)), "decimal(30,2)"),
            (rng.integers(0, 10 ** 9, (n, 5)), "decimal(38,2)"),
            (rng.integers(0, 256, (n, 24)).astype(np.uint8), "varchar")]
    valids = [rng.random(n) >= 0.1 for _ in cols]
    mask = rng.random(n) >= 0.15
    ref = RefPage(tuple(RefBlock(jnp.asarray(d), jnp.asarray(v), ref_type(t))
                        for (d, t), v in zip(cols, valids)), jnp.asarray(mask))
    port = Page(tuple(Block(torch.from_numpy(d.copy()), torch.from_numpy(v), parse_type(t))
                      for (d, t), v in zip(cols, valids)), torch.from_numpy(mask))
    return ref, port


@pytest.mark.parametrize("cap", [700, 64])
def test_limb_and_raw_columns_and_top_bit_keys(cap):
    """Trailing widths ride along; a key whose top bit is set takes the
    unsigned remainder the reference's uint64 ``%`` takes."""
    ref, port = _wide_pages(5000, 11)
    key_ref = RefCol(type=ref_type("bigint"), index=0)
    t = ref_ex.partition_targets(ref, [key_ref], 7)
    want, wfill = ref_ex.partition_for_exchange(ref, t, 7, cap)
    got, fill = ex.partition_page(port, [ColumnRef(type=parse_type("bigint"), index=0)], 7, cap)
    assert int(fill) == int(wfill)
    _same_page(want, got, "wide")
    # the twin's unsigned remainder over raw keys with the top bit set
    raw = torch.from_numpy(np.array(ref.blocks[0].data))
    live = torch.ones(raw.shape[0], dtype=torch.bool)
    h = pk._mix64(raw).numpy().view(np.uint64)
    np.testing.assert_array_equal(k21.targets_plain(raw, live, 7).numpy(),
                                  (h % np.uint64(7)).astype(np.int32))
    assert (h >= np.uint64(1 << 63)).any()


def test_dead_page_and_zero_capacity():
    ref, port = _wide_pages(257, 12)
    dead = Page(port.blocks, torch.zeros_like(port.row_mask))
    got, fill = ex.partition_page(dead, [ColumnRef(type=parse_type("bigint"), index=0)], 8, 16)
    assert int(fill) == 0 and not bool(got.row_mask.any())
    assert all(not bool(b.valid.any()) and not bool(b.data.any()) for b in got.blocks)
    got0, fill0 = ex.partition_page(port, [ColumnRef(type=parse_type("bigint"), index=0)], 4, 0)
    assert got0.capacity == 0 and int(fill0) > 0


def test_exchange_and_gather_match_shard_map(lineitem):
    """Each shard's page after the all-to-all (and after the all-gather)
    equals the reference's shard under ``shard_map`` over 8 virtual
    devices."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    from presto_tpu.parallel.dist import (
        _squeeze, _stack_pages, _unsqueeze, make_mesh as ref_mesh, shard_map,
    )

    mesh = ref_mesh(8)
    spec, domains = KEYS["shipmode"]
    keys = _keys(spec, False)
    cap = 1024

    def body(page1):
        p = _squeeze(page1)
        t = ref_ex.partition_targets(p, keys, 8, domains)
        b, fill = ref_ex.partition_for_exchange(p, t, 8, cap)
        e = ref_ex.exchange_page(b, "d")
        return _unsqueeze(e), _unsqueeze(ref_ex.broadcast_gather_page(p, "d")), fill[None]

    fn = jax.jit(shard_map(body, mesh=mesh, in_specs=P("d"),
                           out_specs=(P("d"), P("d"), P("d"))))
    stacked = jax.device_put(_stack_pages(lineitem), NamedSharding(mesh, P("d")))
    r_ex, r_ag, r_fill = jax.device_get(fn(stacked))

    assert make_mesh(8, device="cpu").n == 8
    ports = [to_port(p) for p in lineitem]
    parts = [ex.partition_page(p, _keys(spec, True), 8, cap, domains) for p in ports]
    np.testing.assert_array_equal([int(f) for _, f in parts], np.asarray(r_fill))
    got_ex = ex.exchange_page([b for b, _ in parts])
    got_ag = ex.broadcast_gather_page(ports)
    for s in range(8):
        for stacked_ref, got, what in ((r_ex, got_ex, "all_to_all"), (r_ag, got_ag, "all_gather")):
            shard = RefPage(tuple(RefBlock(b.data[s], b.valid[s], b.type, b.dictionary)
                                  for b in stacked_ref.blocks), stacked_ref.row_mask[s])
            _same_page(shard, got[s], f"{what} shard {s}")


@pytest.mark.parametrize("given_cap", [None, 300])
def test_shard_buckets_match_reference(lineitem, given_cap):
    """Every shard bucketized for the all-to-all from one first pass a
    shard: without a capacity the buckets take the largest fill over the
    shards (no row dropped), with one they take it; either way each
    shard equals the reference's ``partition_for_exchange`` at that
    capacity, fill included."""
    spec, domains = KEYS["flag_and_date"]
    ports = [to_port(p) for p in lineitem]
    pages, fills, cap = ex.shard_buckets(ports, _keys(spec, True), 8, domains, given_cap)
    targets = [ref_ex.partition_targets(p, _keys(spec, False), 8, domains) for p in lineitem]
    counts = [np.bincount(np.asarray(t), minlength=9)[:8].max() for t in targets]
    assert cap == (max(counts) if given_cap is None else given_cap)
    for s, (ref, t) in enumerate(zip(lineitem, targets)):
        want, wfill = ref_ex.partition_for_exchange(ref, t, 8, cap)
        assert int(fills[s]) == int(wfill) == counts[s]
        _same_page(want, pages[s], f"shard {s}")
