"""Helpers of the function-surface parity tests: the reference's and
the port's runners over the same TPC-H data (the reference's function
suites' catalog: sf 0.001, 4096-row splits), and seeded numpy pages
with NULLs and dead rows in both packages."""

from __future__ import annotations

import numpy as np


class TpchPair:
    """The reference's ``QueryRunner`` and the port's (on the CPU) over
    ``Tpch(sf=0.001, split_rows=4096)``, as the reference's suites
    build it."""

    def __init__(self, sf: float = 0.001, split_rows: int = 4096):
        from presto_tpu.catalog import Catalog
        from presto_tpu.connectors.tpch import Tpch
        from presto_tpu.runner import QueryRunner
        from presto_tpu_torch.runner import QueryRunner as PortRunner
        from presto_tpu_torch.testing import tpch_catalog

        catalog = Catalog()
        catalog.register("tpch", Tpch(sf=sf, split_rows=split_rows))
        self.ref = QueryRunner(catalog)
        self.port = PortRunner(tpch_catalog(sf=sf, split_rows=split_rows), device="cpu")

    def check(self, sql: str, ordered: bool = None):
        """The port's rows equal the reference's: integers, decimals and
        strings exactly, doubles within a relative 1e-9 (the parity
        tolerance: transcendentals come from XLA's CPU kernels in the
        reference and torch's in the port); ordered when the query ends
        in ORDER BY.  Returns them."""
        from oracle import assert_rows_match

        want = self.ref.execute(sql)
        got = self.port.execute(sql)
        assert got.names == want.names
        assert [str(t) for t in got.types] == [str(t) for t in want.types]
        if ordered is None:
            ordered = "order by" in sql.lower().rsplit(")", 1)[-1]
        assert_rows_match(got.rows, want.rows, ordered=ordered)
        return got.rows


def build(spec, ir, parse_type, columns):
    """An expression of ``ir`` from a spec: ("col", name), ("lit",
    value, type) or ("call", fn, type, *args)."""
    kind = spec[0]
    if kind == "col":
        idx = [c for c, _ in columns].index(spec[1])
        return ir.ColumnRef(type=parse_type(columns[idx][1]), index=idx)
    if kind == "lit":
        return ir.Literal(type=parse_type(spec[2]), value=spec[1])
    _, fn, t, *args = spec
    return ir.Call(type=parse_type(t), fn=fn,
                   args=tuple(build(a, ir, parse_type, columns) for a in args))


def C(name):
    return ("col", name)


def L(v, t):
    return ("lit", v, t)


def F(fn, t, *args):
    return ("call", fn, t) + args


I64_MAX = (1 << 63) - 1
INT_EDGES = np.array([I64_MAX, -I64_MAX - 1, I64_MAX - 1, 1 << 62, -(1 << 62), 0, 1, -1,
                      255, -256], dtype=np.int64)
# no subnormal: XLA's CPU backend flushes them to zero (inputs and
# results), where the port keeps them as IEEE and the card do
DOUBLE_EDGES = np.array([0.0, -0.0, np.inf, -np.inf, 2.5, -2.5, 0.5, -0.5, 1e300, -1e-300])
WORDS = [f"w{i % 37:02d}" for i in range(50)]  # a dictionary that repeats values
# the seeded page's columns: name -> type
COLUMNS = [("x", "double"), ("y", "double"), ("a", "bigint"), ("b", "bigint"),
           ("d", "decimal(12,2)"), ("dt", "date"), ("l", "decimal(36,4)"), ("s", "varchar"),
           ("f", "boolean"), ("k", "bigint"), ("i", "integer")]


def function_page(seed: int, n: int = 2048, nan: bool = False):
    """A reference page of ``COLUMNS`` with NULLs and dead rows
    (``with_nulls_and_dead_rows``): doubles with infinities, signed
    zeros and halves (NaN too with ``nan``), int64 edges, shift counts
    past 63 and below 0, decimals with .50 ties, dates before 1970,
    long decimals, a dictionary varchar, booleans, a small key."""
    import jax.numpy as jnp

    from presto_tpu.page import Block, Dictionary, Page
    from presto_tpu.types import parse_type
    from torch_parity import with_nulls_and_dead_rows

    rng = np.random.default_rng(seed)
    x = rng.normal(size=n) * 10.0 ** rng.uniform(-3, 6, n)
    pick = rng.random(n) < 0.1
    edges = np.concatenate([DOUBLE_EDGES, [np.nan]]) if nan else DOUBLE_EDGES
    x[pick] = rng.choice(edges, pick.sum())
    a = rng.integers(-10 ** 12, 10 ** 12, n)
    pick = rng.random(n) < 0.2
    a[pick] = rng.choice(INT_EDGES, pick.sum())
    d = rng.integers(-10 ** 6, 10 ** 6, n)
    d[rng.random(n) < 0.2] = rng.choice([250, -250, 350, -350, 0], 1)[0]
    data = {
        "x": x, "y": rng.uniform(1e-3, 1e6, n), "a": a, "b": rng.integers(-5, 80, n), "d": d,
        "dt": rng.integers(-800, 20000, n).astype(np.int32),
        "l": np.stack([rng.integers(-10 ** 3, 10 ** 3, n), rng.integers(0, 10 ** 18, n)], 1),
        "s": rng.integers(0, len(WORDS), n).astype(np.int32), "f": rng.random(n) < 0.5,
        "k": rng.integers(0, 40, n), "i": rng.integers(-1000, 1000, n).astype(np.int32),
    }
    blocks = [Block(jnp.asarray(data[c]), jnp.ones(n, jnp.bool_), parse_type(t),
                    Dictionary(WORDS) if t == "varchar" else None) for c, t in COLUMNS]
    return with_nulls_and_dead_rows(Page(tuple(blocks), jnp.ones(n, jnp.bool_)), rng)
