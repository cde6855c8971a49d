"""Helpers shared by the presto_tpu_torch parity tests: hand the same
numpy state to the JAX reference and to the port."""

from __future__ import annotations

import numpy as np
import torch

from presto_tpu.page import Page as RefPage
from presto_tpu_torch.page import page_from_numpy

# One torch thread per test process: the suite runs as several
# pytest-xdist workers on one machine, and torch's default of a thread
# per core made them contend (the whole tier-1 run with six workers took
# 918 s with it and 393 s with one thread, on an 8-core machine).  Every worker
# collects every test module, so this holds for all of them.
torch.set_num_threads(1)


def numpy_state(ref_page: RefPage):
    """(columns, valids, row_mask, type strings, dictionary values) of a
    reference page."""
    cols = [np.asarray(b.data) for b in ref_page.blocks]
    valids = [np.asarray(b.valid) for b in ref_page.blocks]
    types = [str(b.type) for b in ref_page.blocks]
    dicts = [b.dictionary.values if b.dictionary is not None else None
             for b in ref_page.blocks]
    return cols, valids, np.asarray(ref_page.row_mask), types, dicts


def to_port(ref_page: RefPage, device="cpu"):
    """The port Page holding exactly ``ref_page``'s state."""
    return page_from_numpy(*numpy_state(ref_page), device=device)


def with_nulls_and_dead_rows(ref_page: RefPage, rng: np.random.Generator,
                             null_rate: float = 0.1, dead_rate: float = 0.1) -> RefPage:
    """``ref_page`` with random NULLs in every column and random dead rows."""
    import jax.numpy as jnp

    from presto_tpu.page import Block

    n = ref_page.capacity
    blocks = []
    for b in ref_page.blocks:
        v = np.asarray(b.valid) & (rng.random(n) >= null_rate)
        blocks.append(Block(b.data, jnp.asarray(v), b.type, b.dictionary))
    mask = np.asarray(ref_page.row_mask) & (rng.random(n) >= dead_rate)
    return RefPage(tuple(blocks), jnp.asarray(mask))


def assert_same_lanes(ref, port, what=""):
    """(data, valid) pairs agree: valid everywhere, data wherever valid."""
    rd, rv = np.asarray(ref[0]), np.asarray(ref[1])
    pd, pv = port[0].cpu().numpy(), port[1].cpu().numpy()
    np.testing.assert_array_equal(pv, rv, err_msg=f"{what} valid")
    np.testing.assert_array_equal(pd[rv], rd[rv], err_msg=f"{what} data")


def assert_models_close(got, want, weights_rtol: float = 1e-9, what=""):
    """One model column of a result (a list per row, None for a NULL
    model) against the reference's.  A learn_classifier model (``[C,
    prior * C, mean * C * k, var * C * k]``, at least 25 lanes, C = 8)
    is held lane by lane: its class count exactly, each other lane
    within a relative 1e-9 of that lane's largest magnitude over the
    rows.  A learn_regressor model (its weights, at most 17) is held
    within ``weights_rtol`` of each row's largest weight: the port
    eliminates the normal equations itself where the reference calls
    LAPACK, so the caller passes the bound of their conditioning."""
    assert len(got) == len(want), what
    assert [g is None for g in got] == [w is None for w in want], what
    pairs = [(g, w) for g, w in zip(got, want) if w is not None]
    if not pairs:
        return
    p = np.asarray([g for g, _ in pairs], np.float64)
    r = np.asarray([w for _, w in pairs], np.float64)
    assert p.shape == r.shape, (what, p.shape, r.shape)
    if r.shape[1] >= 25 and (r[:, 0] == 8).all():  # a classifier
        np.testing.assert_array_equal(p[:, 0], r[:, 0], err_msg=f"{what} class count")
        tol = 1e-9 * np.abs(r).max(axis=0)[None, :]
    else:
        tol = max(weights_rtol, 1e-9) * np.abs(r).max(axis=1)[:, None]
    bad = np.abs(p - r) > tol
    assert not bad.any(), (what, np.argwhere(bad)[:5], p[bad][:5], r[bad][:5])


# -- TPC-DS through the port and through the reference ----------------------

# the reference's TPC-DS test data (tests/test_tpcds_queries.py):
# customer_demographics and inventory cut, both independent of sf
TPCDS_ARGS = dict(sf=0.01, split_rows=16384, cd_rows=2 * 5 * 7 * 20, inv_rows=60000)


class TpcdsPair:
    """The reference's ``QueryRunner`` and the port's (on the CPU) over
    the same generated TPC-DS data.  Every ``CLEAR_EVERY`` reference
    queries the reference's compiled-program caches are dropped, as
    ``tests/test_tpcds_queries.py`` does, so that one process never
    holds the executables of a whole corpus."""

    CLEAR_EVERY = 10

    def __init__(self):
        from presto_tpu.catalog import Catalog
        from presto_tpu.connectors.tpcds import Tpcds
        from presto_tpu.runner import QueryRunner
        from presto_tpu_torch.runner import QueryRunner as PortRunner
        from presto_tpu_torch.testing import tpcds_catalog

        catalog = Catalog()
        catalog.register("tpcds", Tpcds(**TPCDS_ARGS))
        self.ref = QueryRunner(catalog)
        self.port = PortRunner(tpcds_catalog(**TPCDS_ARGS), device="cpu")
        self._since_clear = 0

    def reference(self, sql: str):
        self._since_clear += 1
        if self._since_clear >= self.CLEAR_EVERY:
            import jax

            self._since_clear = 0
            ex = self.ref.executor
            ex._chain_cache.clear()
            ex._fold_cache.clear()
            ex._builds.clear()
            self.ref._plans.clear()
            jax.clear_caches()
        return self.ref.execute(sql)

    def check(self, sql: str):
        """The port's rows equal the reference's (ordered when the query
        ends in ORDER BY); returns them."""
        from oracle import assert_rows_match

        want = self.reference(sql)
        got = self.port.execute(sql)
        assert got.names == want.names
        assert [str(t) for t in got.types] == [str(t) for t in want.types]
        tail = sql.lower().rsplit(")", 1)[-1]
        assert_rows_match(got.rows, want.rows, ordered="order by" in tail)
        return got.rows
