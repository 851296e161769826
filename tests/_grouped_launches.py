"""Each device kernel of one grouped-sum call and its device time, at
``chip_smoke.py``'s partitioned-route cases, from ``torch.profiler`` over
5 calls, on a machine with a CUDA card:

    python3 tests/_grouped_launches.py
    PYTHONPATH=<another checkout>/src python3 tests/_grouped_launches.py

The cases: 2^20 cells (4M rows over 2^20 ids, about 2% padding, with
counts; C 1 integer and C 2 fractional values), SF1 lineorder's shapes by
part key and by customer key (6M rows over 200,000 and 30,000 ids, C 1,
counts), the part-keyed combiner (200,000 rows over as many ids, no
counts) and the sort route's 4M ascending ids (no counts).  The second
form times another checkout's kernels (its ``repro_torch`` and its
sources, built there), so two versions of the route can be compared
launch by launch in one run.  Prints a line a case: the kernels by name
with their device ms a call, and their sum.
"""
import os
import re
import sys

import numpy as np
import torch

CALLS = 5


def by_kernel(fn) -> list:
    """(kernel name, device ms a call) in first-launch order."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(CALLS):
            fn()
        torch.cuda.synchronize()
    times: dict = {}
    for e in prof.events():
        if (e.device_type == DeviceType.CUDA
                and not e.name.startswith(("Memcpy", "Memset"))):
            t = e.time_range
            times[e.name] = times.get(e.name, 0.0) + (t.end - t.start) / 1e3
    return [(name, ms / CALLS) for name, ms in times.items()]


def short(name: str) -> str:
    """A kernel's name without its namespace, return type and arguments."""
    name = name.replace("(anonymous namespace)::", "")
    return re.sub(r"^void ", "", re.sub(r"\(.*", "", name))


def main() -> int:
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    if "PYTHONPATH" not in os.environ:
        sys.path.insert(0, os.path.join(os.path.dirname(
            os.path.dirname(os.path.abspath(__file__))), "src"))
    import repro_torch
    from repro_torch.kernels.radix_groupby import radix_groupby
    from repro_torch.kernels.segment_sum import segment_sum
    print(f"repro_torch from {os.path.dirname(repro_torch.__file__)}")
    rng = np.random.default_rng(0)
    n, cells = 4 << 20, 1 << 20
    big = rng.integers(0, cells, n).astype(np.int32)
    big[rng.random(n) < 0.02] = -1
    sf1 = 6_000_000
    cases = [("2^20cells_int", big, rng.integers(0, 8, (n, 1)), cells, True),
             ("2^20cells_float", big, rng.random((n, 2)), cells, True)]
    for label, groups in (("part_keyed", 200_000),
                          ("customer_keyed", 30_000)):
        cases.append((label, rng.integers(0, groups, sf1).astype(np.int32),
                      rng.random((sf1, 1)) * 1e6, groups, True))
    cases.append(("part_combiner", rng.permutation(200_000).astype(np.int32),
                  rng.random((200_000, 1)) * 1e6, 200_000, False))
    cases.append(("sort_4m", np.arange(4_000_000, dtype=np.int32),
                  rng.random((4_000_000, 1)) * 1e6, 4_000_000, False))
    for label, ids_np, vals, groups, counts in cases:
        ids = torch.from_numpy(ids_np).cuda()
        v = torch.from_numpy(vals.astype(np.float32)).cuda()
        fn = ((lambda: radix_groupby(ids, v, groups, impl="cuda")) if counts
              else (lambda: segment_sum(ids, v, groups, impl="cuda")))
        rows = by_kernel(fn)
        total = sum(ms for _, ms in rows)
        print(f"{label}: {len(rows)} kernels, device_ms={total:.4f}: "
              + "; ".join(f"{short(name)} {ms:.4f}" for name, ms in rows),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
