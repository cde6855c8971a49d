"""The eighth slice's scans: a LIMIT pushed into a table scan (the
splits stop once enough live rows came, counted on the host after each
split, the reference's rows: the first splits in split order) and
TABLESAMPLE SYSTEM (whole splits by a split hash) and BERNOULLI (a
per-(split, row) hash mask on the device), through the port's
``QueryRunner`` on the CPU against the reference's, at TPC-H sf 0.001
(4096-row splits: lineitem has two).  Rows are exact (doubles within a
relative 1e-9, the parity tolerance)."""

import numpy as np
import pytest

from torch_fn_parity import TpchPair

_PAIR = []


def _pair() -> TpchPair:
    if not _PAIR:
        _PAIR.append(TpchPair())
    return _PAIR[0]


SCAN_SQL = [
    "select l_orderkey, l_partkey from lineitem limit 10",
    "select l_orderkey, l_linenumber, l_quantity from lineitem limit 5000",
    "select o_orderkey, o_totalprice from orders limit 3",
    "select count(*), sum(l_quantity) from lineitem tablesample bernoulli (10)",
    "select count(*) from lineitem tablesample bernoulli (50)",
    "select count(*), sum(l_extendedprice) from lineitem tablesample system (50)",
    "select count(*) from orders tablesample system (30)",
    "select count(*), sum(l_quantity) from orders tablesample system (60), "
    "lineitem tablesample bernoulli (20) where o_orderkey = l_orderkey",
    "select l_returnflag, count(*) from lineitem tablesample bernoulli (25) "
    "group by l_returnflag order by l_returnflag",
]


@pytest.mark.parametrize("i", range(len(SCAN_SQL)))
def test_scan_sql_equals_reference(i):
    """The count and the multiset of the rows equal the reference's."""
    rows = _pair().check(SCAN_SQL[i])
    assert rows


def test_limit_scan_stops_reading_splits():
    """A pushed-down LIMIT reads splits only until its live rows are
    there: LIMIT 10 over lineitem (fifteen 4096-row splits at sf 0.01)
    reads one."""
    from presto_tpu_torch.runner import QueryRunner
    from presto_tpu_torch.testing import tpch_catalog

    catalog = tpch_catalog(sf=0.01, split_rows=4096)
    conn = catalog.connector("tpch")
    read = []
    page_for_split = conn.page_for_split

    def counting(table, split, *a, **kw):
        read.append((table, split))
        return page_for_split(table, split, *a, **kw)

    conn.page_for_split = counting
    runner = QueryRunner(catalog, device="cpu")
    assert len(runner.execute("select l_orderkey from lineitem limit 10").rows) == 10
    assert read == [("lineitem", 0)]
    read.clear()
    assert len(runner.execute("select l_orderkey from lineitem limit 5000").rows) == 5000
    assert read == [("lineitem", 0), ("lineitem", 1)]


@pytest.mark.parametrize("split", [0, 1, 7, 1 << 20])
def test_bernoulli_mask_is_the_reference_hash(split):
    """The device mask equals the reference's uint32 hash, computed here
    in numpy's uint32, row for row."""
    from presto_tpu_torch.exec.local import bernoulli_keep

    n = 5000
    r = np.arange(n, dtype=np.uint32)
    with np.errstate(over="ignore"):
        h = r + np.uint32(split) * np.uint32(0x9E3779B1)
        h = (h ^ (h >> np.uint32(15))) * np.uint32(0x85EBCA6B)
        h = (h ^ (h >> np.uint32(13))) * np.uint32(0xC2B2AE35)
    want = (h % np.uint32(10_000)) < np.uint32(1250)
    got = bernoulli_keep(n, split, 12.5, "cpu").numpy()
    np.testing.assert_array_equal(got, want)
    assert 0.08 < got.mean() < 0.17
