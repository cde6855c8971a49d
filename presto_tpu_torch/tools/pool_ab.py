"""A/B of TPC-H Q6, Q1, Q14 and Q3 walls at SF10 on the card, one
process per package copy: for a copy whose ``QueryRunner`` takes a
memory pool, each round runs the queries under the default pool and
with ``memory_pool=False``, alternating which goes first; for an older
copy, without.  Prints each mode's median and quartiles.

To compare a commit with its parent on one card, unpack the parent
into a git-ignored directory and run parent, change, change, parent:

    git archive HEAD~1 presto_tpu_torch tests/tpch_queries.py | tar -x -C build/parent
    python presto_tpu_torch/tools/pool_ab.py build/parent parent1
    python presto_tpu_torch/tools/pool_ab.py . change1   # ... change2, parent2
"""

from __future__ import annotations

import inspect
import statistics
import sys
import time

COLUMNS = {"lineitem": ["l_orderkey", "l_partkey", "l_quantity", "l_extendedprice",
                        "l_discount", "l_tax", "l_returnflag", "l_linestatus", "l_shipdate"],
           "orders": ["o_orderkey", "o_custkey", "o_orderdate", "o_shippriority"],
           "customer": ["c_custkey", "c_mktsegment"], "part": ["p_partkey", "p_type"]}
ROUNDS = 12


def main() -> int:
    root, label = sys.argv[1], sys.argv[2]
    sys.path.insert(0, root)
    sys.path.insert(0, root + "/tests")
    import torch
    from tpch_queries import QUERIES

    from presto_tpu_torch.catalog import Catalog
    from presto_tpu_torch.connectors.memory import MemoryConnector
    from presto_tpu_torch.connectors.tpch import Tpch
    from presto_tpu_torch.runner import QueryRunner

    gen = Tpch(sf=10.0, split_rows=1 << 23)
    host, mem = MemoryConnector(device="cpu"), MemoryConnector(device="cuda")
    for table, columns in COLUMNS.items():
        host.load_from(gen, table, columns=columns)
        mem.load_from(host, table)
    catalog = Catalog()
    catalog.register("tpch", mem)
    if "memory_pool" in inspect.signature(QueryRunner.__init__).parameters:
        runners = {"pool": QueryRunner(catalog, device="cuda"),
                   "nopool": QueryRunner(catalog, device="cuda", memory_pool=False)}
    else:
        runners = {"parent": QueryRunner(catalog, device="cuda")}
    qs = {q: QUERIES[q] for q in (6, 1, 14, 3)}
    for runner in runners.values():
        for sql in qs.values():
            runner.execute(sql)
            runner.execute(sql)
    modes = list(runners)
    walls = {(m, q): [] for m in modes for q in qs}
    for rnd in range(ROUNDS):
        for m in modes if rnd % 2 == 0 else modes[::-1]:
            for q, sql in qs.items():
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                runners[m].execute(sql)
                walls[(m, q)].append((time.perf_counter() - t0) * 1e3)
    for (m, q), w in walls.items():
        w = sorted(w)
        print(f"AB {label} {m} q{q}: median {statistics.median(w):.3f} ms, quartiles "
              f"{w[len(w) // 4 - 1]:.3f}-{w[-len(w) // 4]:.3f}, n={len(w)}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
