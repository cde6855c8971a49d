"""Profiles one call of K6 ``sorted_group_agg`` on the card under
``torch.profiler``: the kernels and the CUDA runtime calls of the call
on one timeline (microseconds from its first event), and the device's
busy time beside the profiled span.  Three seeded cases: Q3's partial
over a probe output (43,852 live rows of 8,385,372), an all-live split
(S_MOM by 100,000 groups) and Q3's merge (119,102 rows).  The
profiler's own overhead stretches the host side; the device times hold.

    python presto_tpu_torch/tools/k6_profile.py <package root> <label>
"""

from __future__ import annotations

import sys


def main() -> int:
    root, label = sys.argv[1], sys.argv[2]
    sys.path.insert(0, root)
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from presto_tpu_torch.kernels import sorted_group_agg as k6

    dev = torch.device("cuda")
    rng = np.random.default_rng(17)

    def t(x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(dev)

    def ones(n):
        return t(np.ones(n, dtype=bool))

    def longs(n):
        return t(np.stack([rng.integers(0, 3, n), rng.integers(0, 10 ** 17, n)], 1))

    def case(n, live, domain, states):
        mask = np.zeros(n, dtype=bool)
        mask[rng.choice(n, live, replace=False)] = True
        keys = [(t(rng.integers(0, domain, n)), ones(n), 0, domain + 1)]
        return keys, t(mask), states(n)

    n8 = 8385372
    cases = {
        "q3_partial": case(n8, 43852, 60000000, lambda n: [
            (k6.S_LIMBS_LONG, longs(n), ones(n)), (k6.S_VALID, None, ones(n))]),
        "moments": case(n8, n8, 100000, lambda n: [
            (k6.S_MOM, t(rng.normal(0, 1e3, n)), ones(n))]),
        "merge": case(119102, 119102, 60000000, lambda n: [
            (k6.S_LIMBS_LONG, longs(n), ones(n)), (k6.S_SUM, t(rng.integers(0, 9, n)), ones(n))]),
    }
    shown = ("cuda", "aten::sort", "aten::item", "aten::empty", "aten::_local")
    for name, (keys, mask, states) in cases.items():
        def call(keys=keys, mask=mask, states=states):
            return k6.sorted_group_agg(keys, mask, states)
        for _ in range(5):
            call()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            call()
            torch.cuda.synchronize()
        events = [e for e in prof.events() if e.name != "cudaDeviceSynchronize"]
        t0 = min(e.time_range.start for e in events)
        rows = []
        for e in events:
            on_card = e.device_type == torch.autograd.DeviceType.CUDA
            if on_card or e.name.startswith(shown):
                rows.append((e.time_range.start - t0, e.time_range.end - e.time_range.start,
                             "GPU" if on_card else "cpu", e.name[:70]))
        print(f"== {label} {name}")
        for start, dur, where, what in sorted(rows):
            print(f"{start:9.1f} {dur:8.1f} {where} {what}")
        span = max(e.time_range.end for e in events) - t0
        busy = sum(dur for _, dur, where, _ in rows if where == "GPU")
        print(f"span {span:.1f} us, device busy {busy:.1f} us")
    return 0


if __name__ == "__main__":
    sys.exit(main())
