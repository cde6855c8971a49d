"""K8 plain version (presto_tpu_torch.ops.join.probe_expand and
outer_build_tail) against the reference's probe_expand and
outer_build_tail: the same numpy pages give the same output rows in
the same order (probe row first, then the build's sorted position),
the same match total and the same FULL OUTER matched mask, exactly.

The build is skewed: one key repeats over thousands of build rows, so
probes of it expand past the probe page's capacity, where the
reference needs its capacity retry and the port sizes its output from
the count."""

import numpy as np
import pytest
import jax.numpy as jnp

from presto_tpu.expr import ir as ref_ir
from presto_tpu.ops import join as ref_join
from presto_tpu.page import Block as RefBlock, Page as RefPage
from presto_tpu.types import parse_type as ref_type
from presto_tpu_torch.expr import ir as port_ir
from presto_tpu_torch.kernels import join_expand as k8
from presto_tpu_torch.ops import join as port_join
from presto_tpu_torch.types import parse_type as port_type
from torch_parity import to_port, with_nulls_and_dead_rows

DOMAIN = 400
HOT = 7  # the skewed key
DOMAINS = {"direct": [(1, DOMAIN)], "binary_search": [(1, 1 << 40)], "hashed": [None]}


@pytest.fixture(autouse=True)
def direct_table():
    """Pin the reference's sorted-build direct table on, as the port
    always has it within the budget."""
    ref_join.set_direct_join_override(True)
    yield
    ref_join.set_direct_join_override(None)


def _page(seed: int, n: int, hot_rows: int, extra_type: str) -> RefPage:
    rng = np.random.default_rng(seed)
    keys = rng.integers(1, DOMAIN + 1, n)
    keys[rng.permutation(n)[:hot_rows]] = HOT
    cols = [(keys, "bigint"), (rng.integers(-10 ** 6, 10 ** 6, n), "decimal(12,2)"),
            (rng.integers(0, 10 ** 4, n).astype(np.int32), extra_type)]
    blocks = tuple(RefBlock(jnp.asarray(c), jnp.ones(n, jnp.bool_), ref_type(t))
                   for c, t in cols)
    page = RefPage(blocks, jnp.ones(n, jnp.bool_))
    return with_nulls_and_dead_rows(page, rng, null_rate=0.05, dead_rate=0.1)


def _key(ir, parse_type):
    return [ir.ColumnRef(type=parse_type("bigint"), index=0)]


def _pages():
    build = _page(1, 4000, hot_rows=2500, extra_type="date")
    probe = _page(2, 1500, hot_rows=20, extra_type="integer")
    return build, probe


def _builds(build, kd):
    return (ref_join.build_join(build, _key(ref_ir, ref_type), kd),
            port_join.build_join(to_port(build), _key(port_ir, port_type), kd))


@pytest.mark.parametrize("domains", list(DOMAINS))
@pytest.mark.parametrize("kind", ["inner", "left", "full"])
def test_expanding_probe_equals_reference(kind, domains):
    kd = DOMAINS[domains]
    build, probe = _pages()
    ref_b, port_b = _builds(build, kd)
    assert (port_b.starts is None) == (domains != "direct")
    ref_kind = "left" if kind == "full" else kind
    full = kind == "full"
    # the reference's first try at the probe's capacity falls short
    first = ref_join.probe_expand(ref_b, probe, _key(ref_ir, ref_type), probe.capacity, kd,
                                  kind=ref_kind, return_matched=full)
    total = int(first[1])
    assert total > 10 * probe.capacity
    ref = ref_join.probe_expand(ref_b, probe, _key(ref_ir, ref_type), total, kd,
                                kind=ref_kind, return_matched=full)
    got = port_join.probe_expand(port_b, to_port(probe), _key(port_ir, port_type), kd,
                                 kind=ref_kind, return_matched=full)
    assert got[1] == total == got[0].capacity
    assert [str(b.type) for b in got[0].blocks] == [str(b.type) for b in ref[0].blocks]
    assert got[0].to_pylist() == ref[0].to_pylist()
    if full:
        np.testing.assert_array_equal(got[2].numpy(), np.asarray(ref[2]))
        spec = [(ref_type(str(b.type)), None) for b in probe.blocks]
        port_spec = [(port_type(str(b.type)), None) for b in probe.blocks]
        ref_tail = ref_join.outer_build_tail(ref_b, ref[2], spec)
        port_tail = port_join.outer_build_tail(port_b, got[2], port_spec)
        np.testing.assert_array_equal(port_tail.row_mask.numpy(),
                                      np.asarray(ref_tail.row_mask))
        assert port_tail.to_pylist() == ref_tail.to_pylist()
        assert len(port_tail.to_pylist()) > 100


def test_no_match_gives_an_empty_page():
    build, probe = _pages()
    _, port_b = _builds(build, DOMAINS["direct"])
    none_live = to_port(RefPage(probe.blocks, jnp.zeros_like(probe.row_mask)))
    page, total = port_join.probe_expand(port_b, none_live, _key(port_ir, port_type),
                                         DOMAINS["direct"])
    assert total == 0 and page.capacity == 1 and not page.to_pylist()


def test_null_safe_expanding_probe_equals_reference():
    kd = DOMAINS["direct"]
    build, probe = _pages()
    ref_b = ref_join.build_join(build, _key(ref_ir, ref_type), kd, null_safe=True)
    port_b = port_join.build_join(to_port(build), _key(port_ir, port_type), kd,
                                  null_safe=True)
    total = int(ref_join.probe_expand(ref_b, probe, _key(ref_ir, ref_type), 1024, kd,
                                      null_safe=True)[1])
    ref, _ = ref_join.probe_expand(ref_b, probe, _key(ref_ir, ref_type), total, kd,
                                   null_safe=True)
    got, got_total = port_join.probe_expand(port_b, to_port(probe), _key(port_ir, port_type),
                                            kd, null_safe=True)
    assert got_total == total
    rows = got.to_pylist()
    assert rows == ref.to_pylist()
    assert any(r[0] is None for r in rows)  # NULL keys met


def test_kernel_plain_outputs():
    """The twin's raw outputs: one row per (probe row, build row) pair,
    a left join's unmatched rows NULL on the build side with data 0."""
    build, probe = _pages()
    _, port_b = _builds(build, DOMAINS["direct"])
    pp = to_port(probe)
    keys = port_join.key_columns(pp, _key(port_ir, port_type), DOMAINS["direct"])
    probe_cols = [(b.data, b.valid) for b in pp.blocks]
    build_cols = [(b.data, b.valid) for b in port_b.page.blocks]
    p_out, b_out, total = k8.join_expand(keys, pp.row_mask, port_b.sorted_keys, port_b.perm,
                                         port_b.starts, probe_cols, build_cols, left=True)
    unmatched = ~b_out[0][1]
    assert unmatched.any() and (b_out[0][0][unmatched] == 0).all()
    assert (p_out[0][0][~unmatched] == b_out[0][0][~unmatched]).all()  # keys agree
    assert total == p_out[0][0].shape[0]
