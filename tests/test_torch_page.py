"""presto_tpu_torch.page against presto_tpu.page: the same numpy state
gives the same host rows, and the executor glue moves rows alike."""

import numpy as np
import pytest

from presto_tpu.connectors.tpch import SCHEMAS, Tpch
from presto_tpu.exec import local as ref_local
from presto_tpu.page import Page as RefPage
from presto_tpu_torch import page as port_page
from torch_parity import to_port, with_nulls_and_dead_rows


@pytest.mark.parametrize("table", sorted(SCHEMAS))
def test_tpch_page_roundtrip(table):
    """Every TPC-H table at sf 0.01, with NULLs and dead rows added:
    dictionary VARCHAR, decimal(12,2), DATE, BIGINT, INTEGER, DOUBLE."""
    rng = np.random.default_rng(sum(map(ord, table)))
    ref = with_nulls_and_dead_rows(Tpch(sf=0.01).page_for_split(table, 0), rng)
    port = to_port(ref)
    assert port.to_pylist() == ref.to_pylist()
    assert port.compact_host().to_pylist() == ref.compact_host().to_pylist()


def test_long_decimal_and_from_arrays_roundtrip():
    from presto_tpu.types import DecimalType as RefDecimal
    from presto_tpu_torch.types import DecimalType

    vals = [10 ** 30 + 7, -(10 ** 25) - 3, 0, None, 5]
    valid = np.array([v is not None for v in vals])
    raw = [0 if v is None else v for v in vals]
    ref = RefPage.from_arrays([raw], [RefDecimal(36, 4)], valids=[valid], capacity=8)
    port = port_page.Page.from_arrays([raw], [DecimalType(36, 4)], valids=[valid],
                                      capacity=8)
    assert port.to_pylist() == ref.to_pylist()
    assert to_port(ref).to_pylist() == ref.to_pylist()


def test_executor_glue_matches_reference():
    rng = np.random.default_rng(7)
    a = with_nulls_and_dead_rows(Tpch(sf=0.01).page_for_split("orders", 0), rng)
    b = with_nulls_and_dead_rows(Tpch(sf=0.01).page_for_split("orders", 1), rng)
    pa, pb = to_port(a), to_port(b)
    cat = port_page.concat_pages_device([pa, pb])
    assert cat.to_pylist() == ref_local.concat_pages_device([a, b]).to_pylist()
    padded = port_page.pad_page_to(pa, pa.capacity + 37)
    ref_padded = ref_local.pad_page_to(a, a.capacity + 37)
    assert padded.capacity == ref_padded.capacity
    assert padded.to_pylist() == ref_padded.to_pylist()
    n = a.capacity // 3
    assert port_page.slice_page(pa, n).to_pylist() == ref_local.slice_page(a, n).to_pylist()
    np.testing.assert_array_equal(port_page._extent_live(pa.row_mask).numpy(),
                                  np.asarray(ref_local._extent_live(a.row_mask)))


@pytest.mark.parametrize("key", ["c_phone", "s_phone", "c_address", "s_address", "p_name",
                                 "c_name", "s_name", "o_clerk"])
def test_lazy_dictionary_values_equal_reference(key):
    """The generator's per-row-unique dictionaries format runs of codes
    at once, whether walked whole, decoded or indexed; every value
    equals the reference's."""
    from presto_tpu.connectors.tpch import Tpch as RefTpch
    from presto_tpu_torch.connectors.tpch import Tpch

    port, ref = Tpch(sf=0.01)._dict(key), RefTpch(sf=0.01)._dict(key)
    assert len(port) == len(ref) >= 10
    assert list(port.values) == [ref.values[i] for i in range(len(ref))]
    codes = np.asarray([[3, -1], [len(ref) - 1, len(ref)]], dtype=np.int32)
    assert port.decode(codes).tolist() == ref.decode(codes).tolist()
    assert port.values[5] == ref.values[5]
