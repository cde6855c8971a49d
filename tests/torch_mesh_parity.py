"""Helpers shared by the mesh tier's parity tests: the reference's and
the port's local runner and mesh tier over the same TPC-H data, and the
row comparison."""

import math

from presto_tpu.catalog import Catalog as RefCatalog
from presto_tpu.connectors.tpch import Tpch as RefTpch
from presto_tpu.parallel.dist import DistributedRunner as RefDist
from presto_tpu.parallel.dist import make_mesh as ref_mesh
from presto_tpu.runner import QueryRunner as RefRunner
from presto_tpu_torch.parallel.dist import DistributedRunner
from presto_tpu_torch.parallel.mesh import make_mesh
from presto_tpu_torch.runner import QueryRunner
from presto_tpu_torch.testing import tpch_catalog


class Side:
    """One engine's local runner and mesh tier over the same data."""

    def __init__(self, local, dist):
        self.local, self.dist = local, dist

    def run(self, sql):
        return self.dist.run(self.local.plan(sql))

    def expected(self, sql):
        return self.local.execute(sql).rows


def make_sides(sf=0.01, split_rows=4096, aligned=False, **kw):
    cat = RefCatalog()
    cat.register("tpch", RefTpch(sf=sf, split_rows=split_rows, aligned_buckets=aligned))
    ref_local = RefRunner(cat)
    ref = Side(ref_local, RefDist(cat, ref_mesh(8), **kw))
    pcat = tpch_catalog(sf=sf, split_rows=split_rows, aligned_buckets=aligned)
    local = QueryRunner(pcat, device="cpu")
    port = Side(local, DistributedRunner(pcat, make_mesh(8, device="cpu"), **kw))
    return ref, port


def row_key(row):
    return tuple((0, "") if v is None else (1, round(v, 6)) if isinstance(v, float)
                 else (1, v) for v in row)


def match_rows(got, want, rel, ordered=False, what=""):
    assert len(got) == len(want), (what, len(got), len(want))
    pairs = zip(got, want) if ordered else zip(sorted(got, key=row_key), sorted(want, key=row_key))
    for a, e in pairs:
        for va, ve in zip(a, e):
            if isinstance(va, float) and isinstance(ve, float):
                assert math.isclose(va, ve, rel_tol=rel) or (math.isnan(va) and math.isnan(ve)), \
                    (what, a, e)
            else:
                assert va == ve, (what, a, e)


def check_mesh(env, sql, ordered=False, min_stages=1):
    """The port's mesh tier against the reference's mesh tier and the
    port's local runner; returns the port's result."""
    ref, port = env
    got = port.run(sql)
    assert got.dist_fallback is None, got.dist_fallback
    assert got.dist_stages >= min_stages
    want = ref.run(sql)
    assert want.dist_fallback is None
    assert got.dist_stages == want.dist_stages
    match_rows(got.rows, want.rows, 1e-9, ordered, "reference mesh")
    match_rows(got.rows, port.expected(sql), 1e-12, ordered, "port local")
    return got
