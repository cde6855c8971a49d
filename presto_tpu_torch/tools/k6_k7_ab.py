"""A/B of K6 ``sorted_group_agg`` and K7 ``topn`` on the card, one
process per package copy, over seeded inputs at the shapes of
``chip_smoke.py``'s K6 and K7 rows (the row counts, live counts, group
counts and key and state kinds those rows log; the values are drawn
from ``SEED``, not TPC-H's).  Each case is timed with CUDA events over
``ITERS`` calls, ``ROUNDS`` times; prints one JSON line: the median ms of
each case, the card and its power limit.

To compare a commit with its parent on one card, unpack the parent
into a git-ignored directory and run parent, change, change, parent:

    git archive HEAD~1 presto_tpu_torch | tar -x -C build/parent
    python presto_tpu_torch/tools/k6_k7_ab.py build/parent parent1
    python presto_tpu_torch/tools/k6_k7_ab.py . change1   # ... change2, parent2
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys

SEED = 17
ROUNDS = 5
ITERS = 10


def main() -> int:
    root, label = sys.argv[1], sys.argv[2]
    sys.path.insert(0, root)
    import numpy as np
    import torch

    from presto_tpu_torch.kernels import sorted_group_agg as k6
    from presto_tpu_torch.kernels import topn as k7

    dev = torch.device("cuda")
    rng = np.random.default_rng(SEED)

    def t(x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(dev)

    def mask(n, live):
        m = np.zeros(n, dtype=bool)
        m[rng.choice(n, live, replace=False)] = True
        return t(m)

    def exact(n, groups, presorted=False):
        codes = np.sort(rng.integers(0, groups, n)) if presorted else rng.integers(0, groups, n)
        return [(t(codes), t(np.ones(n, dtype=bool)), 0, groups + 1)]

    def ones(n):
        return t(np.ones(n, dtype=bool))

    def longs(n):
        return t(np.stack([rng.integers(0, 3, n), rng.integers(0, 10 ** 17, n)], 1))

    def wide(n):
        return t(np.stack([rng.integers(-2, 2, n)] + [rng.integers(0, 10 ** 9, n)
                                                     for _ in range(4)], 1))

    def doubles(n, k=1):
        cols = [t(rng.normal(0, 1e3, n)) for _ in range(k)]
        return cols[0] if k == 1 else cols

    n8, n15 = 8385372, 15000000
    k6_cases = {
        # Q3's partial over a probe output: 43,852 live rows of 2^23
        "sorted_group_agg": (exact(n8, 60000000), mask(n8, 43852), lambda n: [
            (k6.S_LIMBS_LONG, longs(n), ones(n)), (k6.S_VALID, None, ones(n))], False),
        # probe-shaped pages of 2^18 and 2^20 rows, 0.5% live
        "sorted_group_agg@dead_2e18": (exact(1 << 18, 60000000), mask(1 << 18, 1311),
                                       lambda n: [(k6.S_LIMBS_LONG, longs(n), ones(n)),
                                                  (k6.S_VALID, None, ones(n))], False),
        "sorted_group_agg@dead_2e20": (exact(1 << 20, 60000000), mask(1 << 20, 5243),
                                       lambda n: [(k6.S_LIMBS_LONG, longs(n), ones(n)),
                                                  (k6.S_VALID, None, ones(n))], False),
        "sorted_group_agg@merge": (exact(119102, 60000000), ones(119102), lambda n: [
            (k6.S_LIMBS_LONG, longs(n), ones(n)), (k6.S_SUM, t(rng.integers(0, 9, n)),
                                                   ones(n))], False),
        "sorted_group_agg@q21_minmax": (exact(n8, 2097152), ones(n8), lambda n: [
            (k6.S_MIN, t(rng.integers(0, 10 ** 5, n)), ones(n)),
            (k6.S_MAX, t(rng.integers(0, 10 ** 5, n)), ones(n)), (k6.S_ONE, None, None)],
            False),
        "sorted_group_agg@q21_minmax_merge": (exact(n15, n15), ones(n15), lambda n: [
            (k6.S_MIN, t(rng.integers(0, 10 ** 5, n)), ones(n)),
            (k6.S_MAX, t(rng.integers(0, 10 ** 5, n)), ones(n)),
            (k6.S_SUM, t(rng.integers(0, 9, n)), ones(n))], False),
        "sorted_group_agg@q18_presorted": (exact(n8, 2097152, True), ones(n8), lambda n: [
            (k6.S_LIMBS_SHORT, t(rng.integers(0, 10 ** 6, n)), ones(n))], True),
        # an all-live split: the page is its own compaction
        "sorted_group_agg@moments": (exact(n8, 100000), ones(n8), lambda n: [
            (k6.S_MOM, doubles(n), ones(n))], False),
        "sorted_group_agg@d38": (exact(n8, 100000), ones(n8), lambda n: [
            (k6.S_LIMBS_D38, wide(n), ones(n)), (k6.S_MIN_D38, wide(n), ones(n)),
            (k6.S_MAX_D38, wide(n), ones(n)), (k6.S_VALID, None, ones(n))], False),
        "sorted_group_agg@moments_merge": (exact(200000, 100000), ones(200000), lambda n: [
            (k6.S_MOM_MERGE, tuple(doubles(n, 4)) + (t(rng.integers(1, 9, n)),), ones(n))],
            False),
        "sorted_group_agg@min_by_merge": (exact(200000, 100000), ones(200000), lambda n: [
            (k6.S_BY_X, t(rng.integers(0, 10 ** 6, n)), ones(n)), (k6.S_BY_XV, None, ones(n)),
            (k6.S_BY_Y_MAX, doubles(n), ones(n))], False),
    }
    k7_cases = {
        "topn": (119102, lambda n: [(longs(n), ones(n), False, True),
                                    (t(rng.integers(8000, 11000, n).astype(np.int32)), ones(n),
                                     True, False)], 10),
        "topn@real": (n8, lambda n: [(t(rng.normal(0, 1e5, n).astype(np.float32)), ones(n),
                                      False, False),
                                     (t(rng.integers(1, 6 * 10 ** 7, n)), ones(n), True, False)],
                      100),
        "topn@flag_ties": (n8, lambda n: [(t(rng.integers(0, 3, n).astype(np.int32)), ones(n),
                                           False, False),
                                          (t(rng.integers(1, 6 * 10 ** 7, n)), ones(n), True,
                                           False)], 100),
        "topn@raw": (1500000, lambda n: [(t(rng.integers(0, 1 << 62, (n, 5))), ones(n), True,
                                          False)], 100),
        "topn@ds_q89_double": (162842, lambda n: [(doubles(n), ones(n), True, False),
                                                  (t(rng.integers(0, 10 ** 4, n)), ones(n),
                                                   True, False)], 100),
    }

    def cuda_ms(fn):
        for _ in range(2):
            fn()
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(ITERS):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / ITERS

    calls = {}
    for name, (keys, row_mask, make, presorted) in k6_cases.items():
        states = make(row_mask.shape[0])
        calls[name] = (lambda keys=keys, m=row_mask, s=states, p=presorted:
                       k6.sorted_group_agg(keys, m, s, p))
    for name, (n, make, count) in k7_cases.items():
        keys, live = make(n), mask(n, n - n // 20)
        calls[name] = lambda keys=keys, m=live, c=count: k7.topn(keys, m, c)
    times = {name: [] for name in calls}
    for _ in range(ROUNDS):
        for name, fn in calls.items():
            times[name].append(cuda_ms(fn))
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    print(json.dumps({"label": label, "card": card,
                      "ms": {k: statistics.median(v) for k, v in times.items()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
