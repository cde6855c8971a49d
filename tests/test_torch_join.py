"""K4 and K5 plain versions (presto_tpu_torch.ops.join) against the
reference's build_join and probe_join: the same numpy pages give the
same build tables and the same probe output pages, exactly.

The reference picks the sorted build's direct table by backend (off on
XLA:CPU); the tests pin it on, as the port always has it (and as the
reference has it on an accelerator), so both packages take the same
branch: the direct table within the budget, binary search past it."""

import numpy as np
import pytest
import jax.numpy as jnp

from presto_tpu.expr import ir as ref_ir
from presto_tpu.ops import join as ref_join
from presto_tpu.page import Block as RefBlock, Dictionary as RefDictionary, Page as RefPage
from presto_tpu.types import parse_type as ref_type
from presto_tpu_torch import NotPorted
from presto_tpu_torch.expr import ir as port_ir
from presto_tpu_torch.ops import join as port_join
from presto_tpu_torch.types import parse_type as port_type
from torch_parity import to_port, with_nulls_and_dead_rows

DOMAIN = 5000  # key values 1..DOMAIN
KD = [(1, DOMAIN)]
KD_PAST_BUDGET = [(1, 1 << 40)]  # the same keys in a domain too wide for a table
BUILD_COLUMNS = [("k", "bigint"), ("v", "decimal(12,2)"), ("s", "varchar"),
                 ("d", "date"), ("big", "decimal(36,4)")]
WORDS = ["BUILDING", "MACHINERY", "AUTOMOBILE"]


def _build_page(seed: int, n: int, dup: bool) -> RefPage:
    rng = np.random.default_rng(seed)
    keys = rng.permutation(DOMAIN)[:n] + 1
    if dup:
        keys[n // 3] = keys[0]
    cols = [keys, rng.integers(-10 ** 6, 10 ** 6, n),
            rng.integers(0, len(WORDS), n).astype(np.int32),
            rng.integers(8000, 11000, n).astype(np.int32),
            np.stack([rng.integers(-5, 5, n), rng.integers(0, 10 ** 18, n)], 1)]
    blocks = [RefBlock(jnp.asarray(c), jnp.ones(n, jnp.bool_), ref_type(t),
                       RefDictionary(WORDS) if t == "varchar" else None)
              for c, (_, t) in zip(cols, BUILD_COLUMNS)]
    page = RefPage(tuple(blocks), jnp.ones(n, jnp.bool_))
    return with_nulls_and_dead_rows(page, rng, null_rate=0.05, dead_rate=0.05)


def _probe_page(seed: int, n: int = 6000) -> RefPage:
    """Probe keys inside the domain, on its edges and past it."""
    rng = np.random.default_rng(seed)
    keys = rng.integers(-2, DOMAIN + 3, n)
    blocks = (RefBlock(jnp.asarray(keys), jnp.ones(n, jnp.bool_), ref_type("bigint")),
              RefBlock(jnp.asarray(rng.integers(0, 100, n)), jnp.ones(n, jnp.bool_),
                       ref_type("bigint")))
    page = RefPage(blocks, jnp.ones(n, jnp.bool_))
    return with_nulls_and_dead_rows(page, rng, null_rate=0.05, dead_rate=0.1)


def _key(ir, parse_type):
    return [ir.ColumnRef(type=parse_type("bigint"), index=0)]


@pytest.fixture
def direct_table():
    """Pin the reference's sorted-build direct table on."""
    ref_join.set_direct_join_override(True)
    yield
    ref_join.set_direct_join_override(None)


def _live_prefix(ref_build, port_build):
    """The sorted keys and rows both builds place (the live keys);
    past them the two sentinels differ in width only."""
    live = int(np.sum(np.asarray(ref_build.sorted_keys)
                      != np.iinfo(np.asarray(ref_build.sorted_keys).dtype).max))
    sk = port_build.sorted_keys.numpy()
    assert int(np.sum(sk != np.iinfo(np.int64).max)) == live
    np.testing.assert_array_equal(sk[:live], np.asarray(ref_build.sorted_keys)[:live])
    np.testing.assert_array_equal(port_build.perm.numpy()[:live],
                                  np.asarray(ref_build.perm)[:live])
    return live


def _same_output(port, ref):
    """Probe outputs agree under the Page contract: the same live rows,
    and on them the same valid bits and, where valid, the same values."""
    np.testing.assert_array_equal(port.row_mask.numpy(), np.asarray(ref.row_mask))
    assert [str(b.type) for b in port.blocks] == [str(b.type) for b in ref.blocks]
    assert port.to_pylist() == ref.to_pylist()
    assert len(port.to_pylist()) > 100


def test_unique_direct_build_and_probe():
    ref_page = _build_page(1, 3000, dup=False)
    port_page = to_port(ref_page)
    ref_b = ref_join.build_join(ref_page, _key(ref_ir, ref_type), KD, unique=True)
    port_b = port_join.build_join(port_page, _key(port_ir, port_type), KD, unique=True)
    assert bool(ref_b.unique_ok) and bool(port_b.unique_ok)
    np.testing.assert_array_equal(port_b.starts.numpy(), np.asarray(ref_b.starts))
    _live_prefix(ref_b, port_b)
    ref_probe = _probe_page(2)
    ref_out = ref_join.probe_join(ref_b, ref_probe, _key(ref_ir, ref_type), KD)
    port_out = port_join.probe_join(port_b, to_port(ref_probe), _key(port_ir, port_type), KD)
    _same_output(port_out, ref_out)


@pytest.mark.parametrize("with_starts", [True, False])
def test_sorted_build_and_probe(direct_table, with_starts):
    """The sorted branch, with the CSR starts table and, past the
    direct budget, without it (binary-search probes); a duplicated key
    probes to its first build row in row order, as the stable sorts
    place it."""
    kd = KD if with_starts else KD_PAST_BUDGET
    ref_page = _build_page(3, 3000, dup=True)
    port_page = to_port(ref_page)
    ref_b = ref_join.build_join(ref_page, _key(ref_ir, ref_type), kd)
    port_b = port_join.build_join(port_page, _key(port_ir, port_type), kd)
    assert (port_b.starts is None) == (ref_b.starts is None) == (not with_starts)
    if with_starts:
        np.testing.assert_array_equal(port_b.starts.numpy(), np.asarray(ref_b.starts))
    _live_prefix(ref_b, port_b)
    ref_probe = _probe_page(4)
    ref_out = ref_join.probe_join(ref_b, ref_probe, _key(ref_ir, ref_type), kd)
    port_out = port_join.probe_join(port_b, to_port(ref_probe), _key(port_ir, port_type), kd)
    _same_output(port_out, ref_out)


def test_duplicate_key_breaks_the_uniqueness_promise():
    ref_page = _build_page(5, 3000, dup=True)
    port_page = to_port(ref_page)
    # the duplicate must be live with a valid key on both sides
    assert bool(np.asarray(ref_page.row_mask)[[0, 1000]].all())
    assert bool(np.asarray(ref_page.blocks[0].valid)[[0, 1000]].all())
    ref_b = ref_join.build_join(ref_page, _key(ref_ir, ref_type), KD, unique=True)
    port_b = port_join.build_join(port_page, _key(port_ir, port_type), KD, unique=True)
    assert not bool(ref_b.unique_ok) and not bool(port_b.unique_ok)
    np.testing.assert_array_equal(port_b.starts.numpy(), np.asarray(ref_b.starts))


def test_null_keys_and_dead_rows_never_match():
    ref_page = _build_page(6, 3000, dup=False)
    port_b = port_join.build_join(to_port(ref_page), _key(port_ir, port_type), KD,
                                  unique=True)
    probe = to_port(_probe_page(7))
    out = port_join.probe_join(port_b, probe, _key(port_ir, port_type), KD)
    live = out.row_mask.numpy()
    assert not (live & ~probe.row_mask.numpy()).any()
    assert not (live & ~probe.blocks[0].valid.numpy()).any()
    built = set(np.asarray(ref_page.blocks[0].data)[
        np.asarray(ref_page.row_mask) & np.asarray(ref_page.blocks[0].valid)].tolist())
    assert set(probe.blocks[0].data.numpy()[live].tolist()) <= built


def _same_page(port, ref):
    """Pages agree under the Page contract, however few rows are live."""
    np.testing.assert_array_equal(port.row_mask.numpy(), np.asarray(ref.row_mask))
    assert [str(b.type) for b in port.blocks] == [str(b.type) for b in ref.blocks]
    assert port.to_pylist() == ref.to_pylist()


def _build_case(seed: int, case: str) -> RefPage:
    """A build with repeated keys: ``nulls`` keeps its NULL keys, ``no_nulls``
    has none, ``empty`` has no live row."""
    page = _build_page(seed, 3000, dup=True)
    k = page.blocks[0]
    if case == "no_nulls":
        page = RefPage((RefBlock(k.data, jnp.ones_like(k.valid), k.type),) + page.blocks[1:],
                       page.row_mask)
    elif case == "empty":
        page = RefPage(page.blocks, jnp.zeros_like(page.row_mask))
    else:
        assert not bool(np.asarray(k.valid)[np.asarray(page.row_mask)].all())
    return page


@pytest.mark.parametrize("kind", ["left", "semi", "anti"])
def test_other_join_kinds_raise(direct_table, kind):
    """Once NotPorted, now each kind equals the reference's probe_join
    on a sorted build with repeated keys (left takes the first match in
    row order, as the stable sorts place it)."""
    ref_page = _build_page(8, 3000, dup=True)
    ref_b = ref_join.build_join(ref_page, _key(ref_ir, ref_type), KD)
    port_b = port_join.build_join(to_port(ref_page), _key(port_ir, port_type), KD)
    ref_probe = _probe_page(9)
    ref_out = ref_join.probe_join(ref_b, ref_probe, _key(ref_ir, ref_type), KD, kind=kind)
    port_out = port_join.probe_join(port_b, to_port(ref_probe), _key(port_ir, port_type), KD,
                                    kind=kind)
    _same_output(port_out, ref_out)


@pytest.mark.parametrize("case", ["nulls", "no_nulls", "empty"])
@pytest.mark.parametrize("null_aware", [False, True])
@pytest.mark.parametrize("kind", ["left", "semi", "anti", "mark"])
def test_probe_kinds_three_valued(direct_table, kind, null_aware, case):
    """K5's filtering and outer kinds with NULL probe keys, against a
    build that holds a NULL key, one that holds none, and an empty one;
    null_aware gives IN / NOT IN their UNKNOWN.  A null-aware left join
    raises: the reference drops the flag there, the port refuses it."""
    ref_page = _build_case(20, case)
    ref_b = ref_join.build_join(ref_page, _key(ref_ir, ref_type), KD)
    port_b = port_join.build_join(to_port(ref_page), _key(port_ir, port_type), KD)
    assert port_b.flags.tolist() == [int(ref_b.has_null_key), int(ref_b.nonempty)] == \
        [int(case == "nulls"), int(case != "empty")]
    ref_probe = _probe_page(21)
    if kind == "left" and null_aware:
        with pytest.raises(ValueError, match="null_aware"):
            port_join.probe_join(port_b, to_port(ref_probe), _key(port_ir, port_type), KD,
                                 kind=kind, null_aware=True)
        return
    ref_out = ref_join.probe_join(ref_b, ref_probe, _key(ref_ir, ref_type), KD, kind=kind,
                                  null_aware=null_aware)
    port_out = port_join.probe_join(port_b, to_port(ref_probe), _key(port_ir, port_type), KD,
                                    kind=kind, null_aware=null_aware)
    _same_page(port_out, ref_out)
    if kind == "mark":  # the mark's NULLs (UNKNOWN) are compared bit for bit
        np.testing.assert_array_equal(port_out.blocks[-1].valid.numpy(),
                                      np.asarray(ref_out.blocks[-1].valid))


def test_null_aware_refused_on_inner_join(direct_table):
    """null_aware belongs to IN / NOT IN (semi, anti, mark); asked of a
    join that gathers build columns it raises rather than being dropped
    (the reference drops it)."""
    port_b = port_join.build_join(to_port(_build_page(24, 300, dup=False)),
                                  _key(port_ir, port_type), KD)
    with pytest.raises(ValueError, match="null_aware"):
        port_join.probe_join(port_b, to_port(_probe_page(25, 100)), _key(port_ir, port_type),
                             KD, kind="inner", null_aware=True)


@pytest.mark.parametrize("kind", ["inner", "semi", "anti"])
def test_null_safe_build_and_probe(direct_table, kind):
    """IS NOT DISTINCT FROM keys: NULL build keys stay live and match
    NULL probe keys."""
    ref_page = _build_page(22, 3000, dup=False)
    ref_b = ref_join.build_join(ref_page, _key(ref_ir, ref_type), KD, null_safe=True)
    port_b = port_join.build_join(to_port(ref_page), _key(port_ir, port_type), KD,
                                  null_safe=True)
    np.testing.assert_array_equal(port_b.starts.numpy(), np.asarray(ref_b.starts))
    _live_prefix(ref_b, port_b)
    ref_probe = _probe_page(23)
    ref_out = ref_join.probe_join(ref_b, ref_probe, _key(ref_ir, ref_type), KD, kind=kind,
                                  null_safe=True)
    port_out = port_join.probe_join(port_b, to_port(ref_probe), _key(port_ir, port_type), KD,
                                    kind=kind, null_safe=True)
    _same_output(port_out, ref_out)
    probe_nulls = ~to_port(ref_probe).blocks[0].valid.numpy()
    if kind == "inner":
        assert (port_out.row_mask.numpy() & probe_nulls).any()  # NULL met NULL


def test_hashed_keys_and_expanding_probe_raise():
    """Once NotPorted: keys without a domain now hash (K9) into a
    sorted build without a starts table, probed by binary search, and
    the expanding probe (K8) runs; both equal the reference.  Raw-string
    keys, once refused too, hash through their FNV-1a lane (K17) and
    equal the reference's build and probes."""
    ref_page = _build_page(10, 3000, dup=True)
    ref_b = ref_join.build_join(ref_page, _key(ref_ir, ref_type), [None])
    port_b = port_join.build_join(to_port(ref_page), _key(port_ir, port_type), [None])
    assert port_b.starts is None and ref_b.starts is None
    _live_prefix(ref_b, port_b)
    ref_probe = _probe_page(11)
    port_probe = to_port(ref_probe)
    _same_output(port_join.probe_join(port_b, port_probe, _key(port_ir, port_type), [None]),
                 ref_join.probe_join(ref_b, ref_probe, _key(ref_ir, ref_type), [None]))
    ref_out, ref_total = ref_join.probe_expand(ref_b, ref_probe, _key(ref_ir, ref_type),
                                               8192, [None])
    port_out, port_total = port_join.probe_expand(port_b, port_probe,
                                                  _key(port_ir, port_type), [None])
    assert port_total == int(ref_total) > 100
    assert port_out.to_pylist() == ref_out.to_pylist()
    from presto_tpu_torch.page import page_from_numpy

    def raw_pages(seed, n):
        rng = np.random.default_rng(seed)
        data = np.zeros((n, 8), dtype=np.uint8)  # a few distinct keys, some shorter
        data[:, :2] = rng.integers(97, 100, (n, 2))
        data[rng.random(n) < 0.3, 1] = 0
        valid = rng.random(n) >= 0.1
        ref = RefPage((RefBlock(jnp.asarray(data), jnp.asarray(valid),
                                ref_type("raw_varchar(8)")),
                       RefBlock(jnp.arange(n), jnp.ones(n, jnp.bool_), ref_type("bigint"))),
                      jnp.ones(n, jnp.bool_))
        return ref, page_from_numpy([data, np.arange(n)], [valid, np.ones(n, np.bool_)],
                                    np.ones(n, np.bool_), ["raw_varchar(8)", "bigint"],
                                    [None, None])

    ref_raw_b, raw_b = raw_pages(12, 64)
    ref_raw_p, raw_p = raw_pages(13, 200)
    raw_key_ref = [ref_ir.ColumnRef(type=ref_type("raw_varchar(8)"), index=0)]
    raw_key = [port_ir.ColumnRef(type=port_type("raw_varchar(8)"), index=0)]
    ref_b = ref_join.build_join(ref_raw_b, raw_key_ref, [None])
    port_b = port_join.build_join(raw_b, raw_key, [None])
    _live_prefix(ref_b, port_b)
    for kind in ("semi", "left"):
        _same_output(port_join.probe_join(port_b, raw_p, raw_key, [None], kind=kind),
                     ref_join.probe_join(ref_b, ref_raw_p, raw_key_ref, [None], kind=kind))
    ref_out, ref_total = ref_join.probe_expand(ref_b, ref_raw_p, raw_key_ref, 16384, [None])
    port_out, port_total = port_join.probe_expand(port_b, raw_p, raw_key, [None])
    assert port_total == int(ref_total) > 100
    assert port_out.to_pylist() == ref_out.to_pylist()


def test_direct_budget_and_domain_size_match_reference():
    ref_page = _build_page(11, 100, dup=False)
    for kd in ([(1, 10), (0, 3)], [(1, 1 << 40), (0, 1 << 30)], [None], KD):
        assert port_join.packed_domain_size(kd) == ref_join.packed_domain_size(kd)
    assert port_join._direct_budget(to_port(ref_page)) == ref_join._direct_budget(ref_page)
    assert (port_join.DIRECT_DOMAIN_MAX, port_join.DIRECT_DOMAIN_PER_ROW) == \
        (ref_join.DIRECT_DOMAIN_MAX, ref_join.DIRECT_DOMAIN_PER_ROW)
