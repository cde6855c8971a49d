"""K7's plain version (presto_tpu_torch.ops.sort.topn_page) against the
reference's topn_page: the same numpy pages give the same first n rows
in the same order, exactly, with ties on every key broken by row
position as the reference's stable sorts break them."""

import numpy as np
import pytest
import jax.numpy as jnp

from presto_tpu.expr import ir as ref_ir
from presto_tpu.ops import sort as ref_sort
from presto_tpu.page import Block as RefBlock, Dictionary as RefDictionary, Page as RefPage
from presto_tpu.types import parse_type as ref_type
from presto_tpu_torch.expr import ir as port_ir
from presto_tpu_torch.kernels import topn as k7
from presto_tpu_torch.ops import sort as port_sort
from presto_tpu_torch.types import parse_type as port_type
from torch_parity import to_port, with_nulls_and_dead_rows

COLUMNS = [("rev", "decimal(36,4)"), ("dt", "date"), ("k", "bigint"), ("s", "varchar"),
           ("b", "boolean")]
WORDS = ["b", "a", "c", "a2"]  # codes out of collation order


def _page(seed: int, n: int = 2000) -> RefPage:
    """Few distinct values per key, so every key ties often; long
    decimals negative and positive with equal high limbs."""
    rng = np.random.default_rng(seed)
    cols = [np.stack([rng.integers(-2, 2, n), rng.choice([0, 5, 10 ** 17], n)], 1),
            rng.integers(9000, 9004, n).astype(np.int32), rng.integers(-3, 3, n),
            rng.integers(0, len(WORDS), n).astype(np.int32), rng.random(n) < 0.5]
    blocks = [RefBlock(jnp.asarray(c), jnp.ones(n, jnp.bool_), ref_type(t),
                       RefDictionary(WORDS) if t == "varchar" else None)
              for c, (_, t) in zip(cols, COLUMNS)]
    page = RefPage(tuple(blocks), jnp.ones(n, jnp.bool_))
    return with_nulls_and_dead_rows(page, rng, null_rate=0.2, dead_rate=0.2)


def _exprs(ir, parse_type, names):
    idx = [c for c, _ in COLUMNS]
    return [ir.ColumnRef(type=parse_type(COLUMNS[idx.index(c)][1]), index=idx.index(c))
            for c in names]


ORDERS = {
    # Q3's ORDER BY: revenue DESC (NULLs first), date ASC
    "q3": (["rev", "dt"], [False, True], [True, False]),
    "long_asc_nulls_last": (["rev", "k"], [True, False], [False, False]),
    "all_keys": (["s", "b", "dt", "rev", "k"], [True, False, True, False, True],
                 [False, True, True, False, True]),
    "default_nulls": (["k", "dt"], [False, True], None),
}


@pytest.mark.parametrize("order", sorted(ORDERS))
@pytest.mark.parametrize("n", [1, 10, 32])
def test_topn_matches_reference(order, n):
    names, asc, nf = ORDERS[order]
    ref_page = _page(len(order) + n)
    port_page = to_port(ref_page)
    ref = ref_sort.topn_page(ref_page, _exprs(ref_ir, ref_type, names), asc, n, nf)
    got = port_sort.topn_page(port_page, _exprs(port_ir, port_type, names), asc, n, nf)
    assert got.capacity == n
    assert got.to_pylist() == ref.to_pylist()
    assert len(got.to_pylist()) == n


def test_topn_with_fewer_live_rows_than_n():
    ref_page = _page(3, 40)
    mask = np.zeros(40, np.bool_)
    mask[[5, 17, 30]] = True
    ref_page = RefPage(ref_page.blocks, jnp.asarray(mask))
    names, asc, nf = ORDERS["q3"]
    ref = ref_sort.topn_page(ref_page, _exprs(ref_ir, ref_type, names), asc, 10, nf)
    got = port_sort.topn_page(to_port(ref_page), _exprs(port_ir, port_type, names), asc,
                              10, nf)
    assert got.to_pylist() == ref.to_pylist()
    assert int(got.row_mask.sum()) == 3


@pytest.mark.parametrize("n", [k7.MAX_N + 1, 150, 500])
def test_topn_past_the_kernel_bound_equals_reference(n):
    """Past K7's MAX_N the port sorts the page (``torch.sort``) and keeps
    its first n live rows, as the reference's topn_page always does:
    the same rows in the same order, ties broken by row position."""
    names, asc, nf = ORDERS["all_keys"]
    ref_page = _page(4 + n)
    want = ref_sort.topn_page(ref_page, _exprs(ref_ir, ref_type, names), asc, n, nf)
    got = port_sort.topn_page(to_port(ref_page), _exprs(port_ir, port_type, names), asc, n, nf)
    assert got.capacity == n
    assert got.to_pylist() == want.to_pylist()
    assert len(got.to_pylist()) == n
