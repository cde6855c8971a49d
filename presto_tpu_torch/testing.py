"""Test harness: an in-process runner over the TPC-H generator, and a
TPC-DS catalog.

Counterpart of ``presto_tpu/testing.py`` (``tpch_catalog`` and
``LocalQueryRunner``).  Generated splits are host pages; the runner
moves each to its device as it scans.
"""

from __future__ import annotations

from typing import Optional

from presto_tpu_torch.catalog import Catalog
from presto_tpu_torch.runner import QueryRunner


def tpch_catalog(sf: float = 0.01, split_rows: int = 1 << 14,
                 aligned_buckets: bool = False) -> Catalog:
    from presto_tpu_torch.connectors.tpch import Tpch

    catalog = Catalog()
    catalog.register("tpch", Tpch(sf=sf, split_rows=split_rows,
                                  aligned_buckets=aligned_buckets))
    return catalog


def tpcds_catalog(sf: float = 0.01, split_rows: int = 1 << 14,
                  cd_rows: Optional[int] = None, inv_rows: Optional[int] = None) -> Catalog:
    """The TPC-DS generator as catalog ``tpcds``; ``cd_rows`` and
    ``inv_rows`` cut customer_demographics and inventory (both
    independent of the scale factor) as the reference's tests do."""
    from presto_tpu_torch.connectors.tpcds import Tpcds

    catalog = Catalog()
    catalog.register("tpcds", Tpcds(sf=sf, split_rows=split_rows, cd_rows=cd_rows,
                                    inv_rows=inv_rows))
    return catalog


class LocalQueryRunner(QueryRunner):
    """SQL in, rows out, fully in-process over the TPC-H generator, on
    ``device`` (default ``cuda``); ``memory_pool`` as
    :class:`QueryRunner` takes it."""

    def __init__(self, sf: float = 0.01, catalog: Optional[Catalog] = None,
                 device=None, **kw):
        super().__init__(catalog or tpch_catalog(sf=sf), device=device, **kw)
