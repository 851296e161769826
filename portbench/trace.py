"""Read the exported Chrome traces of ``torch.profiler`` sessions over the
traced steps.

``device_activity`` reads a session of device activity alone (kernels,
copies, fills and the host's CUDA calls), whose host overhead is small:
the device's busy time, its largest items, its idle gaps by the CUDA
call the host was in when each began, and the three longest gaps.  ``op_calls`` reads a session that
also records the host's ops with their shapes: each registered op's calls
and their device time, which is that of every device item whose launch
the host made inside the call, nested ops included: whatever kernels
implement the op.
"""
from __future__ import annotations

import bisect
import heapq
import json
from collections import defaultdict
from typing import Dict, Iterable, List

_DEVICE = ("kernel", "gpu_memcpy", "gpu_memset")
_RUNTIME = ("cuda_runtime", "cuda_driver")


def _events(path: str) -> List[dict]:
    with open(path) as f:
        return [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"]


def _merge(spans: List[tuple]) -> List[list]:
    out: List[list] = []
    for s, e in sorted(spans):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def device_activity(path: str, window_s: float) -> Dict[str, object]:
    """``window_s``: the traced step's length on the host's clock, from a
    synchronised device to a synchronised device."""
    events = _events(path)
    device = [e for e in events if e.get("cat") in _DEVICE]
    calls = sorted((e["ts"], e["ts"] + e["dur"], e["name"]) for e in events
                   if e.get("cat") in _RUNTIME)
    merged = _merge([(e["ts"], e["ts"] + e["dur"]) for e in device])
    busy = sum(e - s for s, e in merged) / 1e6
    by_name = defaultdict(float)
    for e in device:
        by_name[e["name"][:160]] += e["dur"] / 1e6
    gaps = defaultdict(float)
    longest: List[tuple] = []         # (length s, start s, label)
    inner = 0.0
    active: List[tuple] = []          # (end, start, name) of open calls
    i = 0
    for (_, a), (b, _) in zip(merged, merged[1:]):
        while i < len(calls) and calls[i][0] <= a:
            heapq.heappush(active, (calls[i][1], calls[i][0], calls[i][2]))
            i += 1
        while active and active[0][0] <= a:
            heapq.heappop(active)
        # the latest-begun call still open: the innermost where calls nest
        name = max(active, key=lambda c: c[1])[2] if active else None
        label = f"host in {name}" if name else "host between CUDA calls"
        gaps[label] += (b - a) / 1e6
        inner += (b - a) / 1e6
        heapq.heappush(longest, ((b - a) / 1e6, (a - merged[0][0]) / 1e6,
                                 label))
        if len(longest) > 3:
            heapq.heappop(longest)
    edge = max(0.0, window_s - busy - inner)
    if edge > 0:
        gaps["host before the first launch and after the last"] += edge
    return {"busy_s": busy, "window_s": window_s,
            "device_ops": _top(by_name), "idle_gaps": _top(gaps),
            "longest_gaps": [[round(t, 6), round(d, 6), n]
                             for d, t, n in sorted(longest, reverse=True)]}


def _top(d: Dict[str, float]) -> List[list]:
    return [[n, s] for n, s in sorted(d.items(), key=lambda kv: -kv[1])[:10]]


def op_calls(path: str, ops: Iterable[str]) -> List[dict]:
    """Each call of an op in ``ops``: its input dims, types and scalars as
    the profiler recorded them, and its device seconds."""
    ops = set(ops)
    by_corr = defaultdict(float)
    launches = defaultdict(list)
    host = []
    for e in _events(path):
        cat, args = e.get("cat"), e.get("args", {})
        if cat in _DEVICE and "correlation" in args:
            by_corr[args["correlation"]] += e["dur"]
        elif cat in _RUNTIME and "correlation" in args:
            launches[e["tid"]].append((e["ts"], args["correlation"]))
        elif cat == "cpu_op" and e["name"] in ops:
            host.append(e)
    for lst in launches.values():
        lst.sort()
    times = {tid: [t for t, _ in lst] for tid, lst in launches.items()}
    calls = []
    for e in host:
        ts, lst = times.get(e["tid"], []), launches.get(e["tid"], [])
        lo = bisect.bisect_left(ts, e["ts"])
        hi = bisect.bisect_right(ts, e["ts"] + e["dur"])
        args = e.get("args", {})
        calls.append({"op": e["name"], "dims": args.get("Input Dims"),
                      "types": args.get("Input type"),
                      "scalars": args.get("Concrete Inputs"),
                      "device_s": sum(by_corr[c] for _, c in lst[lo:hi])
                      / 1e6})
    return calls
