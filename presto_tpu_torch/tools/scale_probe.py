"""Run TPC-DS queries at several scales on the card (and, below a
limit, on the CPU), printing rows, wall, peak device memory and pool
peak, or the error, at each: how the scale cut of a query that does not
fit one card is found.

    python presto_tpu_torch/tools/scale_probe.py 72 --sf 0.5 0.3 0.2 0.1 0.03 0.01 --cpu-below 0.1

Run from the repository root, on a machine with a CUDA card.
"""

from __future__ import annotations

import argparse
import gc
import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[2]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("queries", type=int, nargs="+")
    ap.add_argument("--sf", type=float, nargs="+", required=True)
    ap.add_argument("--cpu-below", type=float, default=0.0,
                    help="also run on the CPU at scales at or below this one")
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT))
    import torch

    import chip_smoke as cs
    from presto_tpu_torch.connectors.memory import MemoryConnector
    from presto_tpu_torch.connectors.tpcds import Tpcds
    from presto_tpu_torch.runner import QueryRunner

    print(cs.card_line(), flush=True)
    qs = {f"ds_q{q}": cs.DS_SQL[q] for q in args.queries}
    cols = cs.ds_tables(qs)
    for sf in args.sf:
        host, mem = MemoryConnector(device="cpu"), MemoryConnector(device="cuda")
        gen = Tpcds(sf=sf, split_rows=cs.DS_SPLIT_ROWS)
        for table, columns in cols.items():
            host.load_from(gen, table, columns=columns)
            mem.load_from(host, table)
        for label, sql in qs.items():
            for dev, conn in (("cuda", mem), ("cpu", host)):
                if dev == "cpu" and sf > args.cpu_below:
                    continue
                runner = QueryRunner(cs.query_catalog(conn, sql, tables=cols, name="tpcds"),
                                     device=dev)
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                t0 = time.perf_counter()
                try:
                    rows = len(runner.execute(sql).rows)
                    torch.cuda.synchronize()
                    out = f"{rows} rows"
                except (RuntimeError, ValueError) as e:  # out of memory, past int32 offsets
                    out = f"{type(e).__name__}: {str(e)[:160]}"
                print(f"sf {sf} {label} {dev}: {out} in {time.perf_counter() - t0:.2f} s, "
                      f"peak {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, pool peak "
                      f"{runner.executor.last_peak_bytes / 2**30:.2f} GiB", flush=True)
                del runner
                gc.collect()
                torch.cuda.empty_cache()
        del host, mem, gen
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
