"""The program's own spans (``repro_torch.obs.trace``) on the clock of a
device trace, and what they say about a training step.

``program_session`` runs a profiler session of device activity alone with
the program's tracer in scope: a warm step, then a traced step between
clock anchors (a ``clock.anchor`` span around a synchronise, three at
each end).  ``align`` matches each anchor to its ``cudaDeviceSynchronize``
in the profiler's trace: the offset of the two clocks is the difference
of their ends (the host's time before the sync varies by tens of µs, its
time after it by a few), and the anchors before the step and after it
must agree within ``ANCHOR_TOLERANCE_US``.  ``attribute`` then gives each
device item to the innermost program span open on the launching thread
when its launch began; a thread with none open (autograd's device thread
between its hooks) falls back to the innermost span on the thread that
ran ``train.step``.  Each idle gap between device items goes to the span
of the launch that ends it.

``input_interference_ms`` reads the host clock alone: how much longer the
steps that overlap a refill of the input pipeline run than the others.
"""
from __future__ import annotations

import gc
import json
import os
import statistics
import tempfile
import time
from collections import defaultdict
from typing import Callable, Dict, List, Optional

_DEVICE = ("kernel", "gpu_memcpy", "gpu_memset")
_RUNTIME = ("cuda_runtime", "cuda_driver")
ANCHOR = ("clock", "clock.anchor")
ANCHOR_TOLERANCE_US = 50.0
OUTSIDE = "outside spans"
EDGE = "before the first launch and after the last"


def anchor(sync: Callable[[], None], n: int = 3) -> None:
    """``n`` clock anchors: ``sync`` (a device synchronise) inside a span,
    ``n`` times (``align`` keeps the one whose span ends soonest after its
    sync)."""
    from repro_torch.obs import trace
    for _ in range(n):
        with trace.span(*ANCHOR):
            sync()


def program_session(step: Callable[[], object], sync: Callable[[], None],
                    tracer, cuda: bool) -> Dict[str, object]:
    """A profiler session of device activity alone with ``tracer`` in
    scope: a warm step, then a step between anchors.  Returns the traced
    step's length on the host's clock (``window_s``: from the first
    anchors to the last) and the session's ``attribution``.  A full
    garbage collection first: the traces read before leave a heap whose
    collection would otherwise stall the traced step by up to 0.7 s."""
    from torch.profiler import ProfilerActivity, profile, schedule

    from repro_torch.obs import trace
    fd, path = tempfile.mkstemp(suffix=".json", prefix="portbench-spans-")
    os.close(fd)
    gc.collect()
    try:
        with trace.trace_scope(tracer), profile(
                activities=[ProfilerActivity.CUDA if cuda
                            else ProfilerActivity.CPU],
                schedule=schedule(wait=0, warmup=1, active=1),
                on_trace_ready=lambda p: p.export_chrome_trace(path)) as prof:
            step()
            sync()
            prof.step()
            first = len(tracer.events)
            anchor(sync)
            t = time.perf_counter()
            step()
            anchor(sync)
            window_s = time.perf_counter() - t
            prof.step()
        with open(path) as f:
            profiler = [e for e in json.load(f)["traceEvents"]
                        if e.get("ph") == "X"]
        return {"window_s": window_s, "attribution": attribute(
            tracer.events[first:], profiler, window_s)}
    finally:
        os.remove(path)


def _spans(events: List[dict]) -> List[dict]:
    return [e for e in events if e.get("ph") == "X"]


def _end(e: dict) -> float:
    return e["ts"] + e["dur"]


def align(program: List[dict], profiler: List[dict]) -> Dict[str, object]:
    """``{"offsets": [first, last] µs, "offset": µs or None, "tids":
    {profiler tid: program tid}}``: a program time plus ``offset`` is a
    profiler time.  The anchors are paired in order with as many
    successive ``cudaDeviceSynchronize`` calls on their thread, those that
    agree best (the profiler adds syncs of its own when it stops).  The
    host reaches the sync after 5–150 µs of Python, but its span ends a
    few µs after the sync returns: each side (the first half of the
    anchors, the last half) takes the largest difference of the two ends,
    the anchor that returned soonest.  None where a side has no anchors
    or the two sides disagree by more than ``ANCHOR_TOLERANCE_US``.  The
    program writes OS thread ids, as the profiler does; a profiler writing
    other ids has the anchors' thread mapped alone."""
    anchors = sorted((e for e in _spans(program)
                      if (e.get("cat"), e["name"]) == ANCHOR),
                     key=lambda e: e["ts"])
    syncs = sorted((e for e in profiler if e.get("cat") in _RUNTIME
                    and e["name"] == "cudaDeviceSynchronize"),
                   key=lambda e: e["ts"])
    out: Dict[str, object] = {"offsets": [], "offset": None, "tids": {}}
    n, half = len(anchors), len(anchors) // 2
    if n < 2 or not syncs:
        return out
    tid = anchors[0]["tid"]
    mine = [s for s in syncs if s["tid"] == tid] or [
        s for s in syncs if s["tid"] == syncs[0]["tid"]]
    if len(mine) < n:
        return out

    def ends(j):
        return [_end(s) - _end(a) for a, s in zip(anchors, mine[j:j + n])]
    j = min(range(len(mine) - n + 1), key=lambda j: sum(
        max(d) - min(d) for d in (ends(j)[:half], ends(j)[half:])))
    d = ends(j)
    out["offsets"] = [max(d[:half]), max(d[half:])]
    out["tids"] = {mine[0]["tid"]: tid}
    first, last = out["offsets"]
    if abs(first - last) <= ANCHOR_TOLERANCE_US:
        out["offset"] = (first + last) / 2
    return out


def _innermost(spans: List[tuple], times: List[float]) -> List[Optional[str]]:
    """For sorted ``times``, the name of the innermost of ``spans``
    ((start, end, name), properly nested as one thread's spans are) open
    at each; None where none is."""
    spans = sorted(spans, key=lambda s: (s[0], -s[1]))
    out: List[Optional[str]] = []
    stack: List[tuple] = []
    i = 0
    for t in times:
        while i < len(spans) and spans[i][0] <= t:
            while stack and stack[-1][1] <= spans[i][0]:
                stack.pop()
            stack.append(spans[i])
            i += 1
        while stack and stack[-1][1] <= t:
            stack.pop()
        out.append(stack[-1][2] if stack else None)
    return out


def attribute(program: List[dict], profiler: List[dict], window_s: float
              ) -> Dict[str, object]:
    """Device seconds and idle seconds by program span over one profiler
    session (``window_s``: the traced step on the host's clock).  Keys:
    ``offsets`` (µs, the two anchors'), ``aligned``, and where aligned
    ``device_s`` and ``idle_s`` (by span name, ``OUTSIDE`` for items
    launched outside every span, ``EDGE`` for the idle before the first
    item and after the last), ``steps`` (the ``train.step`` spans),
    ``items_s`` (all device time) and ``wait_s`` (the host's wait in
    ``prefetch.get``: a gap it leaves goes to the launch after it)."""
    clock = align(program, profiler)
    out: Dict[str, object] = {"offsets": clock["offsets"],
                              "aligned": clock["offset"] is not None}
    if not out["aligned"]:
        return out
    off, tids = clock["offset"], clock["tids"]
    by_thread: Dict[int, List[tuple]] = defaultdict(list)
    step_tid, steps = None, 0
    for e in _spans(program):
        if (e.get("cat"), e["name"]) == ANCHOR:
            continue
        by_thread[e["tid"]].append((e["ts"] + off, e["ts"] + off + e["dur"],
                                    e["name"]))
        if e["name"] == "train.step":
            step_tid, steps = e["tid"], steps + 1
    launch = {}
    for e in profiler:
        if e.get("cat") in _RUNTIME and "correlation" in (e.get("args") or {}):
            launch[e["args"]["correlation"]] = (e["ts"],
                                                tids.get(e["tid"], e["tid"]))
    items = sorted((e["ts"], e["ts"] + e["dur"], launch.get(
        (e.get("args") or {}).get("correlation"))) for e in profiler
        if e.get("cat") in _DEVICE)
    # the launches, by the thread that made them, each answered in turn
    asked: Dict[object, List[tuple]] = defaultdict(list)
    for i, (_, _, ln) in enumerate(items):
        if ln is not None:
            asked[ln[1]].append((ln[0], i))
    owner: List[Optional[str]] = [None] * len(items)
    for tid, qs in asked.items():
        qs.sort()
        for (_, i), name in zip(qs, _innermost(by_thread.get(tid, []),
                                               [t for t, _ in qs])):
            owner[i] = name
    late = sorted((items[i][2][0], i) for i in range(len(items))
                  if owner[i] is None and items[i][2] is not None)
    for (_, i), name in zip(late, _innermost(by_thread.get(step_tid, []),
                                             [t for t, _ in late])):
        owner[i] = name
    device_s: Dict[str, float] = defaultdict(float)
    idle_s: Dict[str, float] = defaultdict(float)
    busy = inner = 0.0
    end = None
    for (s, e, _), name in zip(items, owner):
        name = name or OUTSIDE
        device_s[name] += (e - s) / 1e6
        if end is None:
            busy += (e - s) / 1e6
        elif s > end:
            idle_s[name] += (s - end) / 1e6
            inner += (s - end) / 1e6
            busy += (e - s) / 1e6
        elif e > end:
            busy += (e - end) / 1e6
        end = e if end is None else max(end, e)
    idle_s[EDGE] = max(0.0, window_s - busy - inner)
    out.update(device_s=dict(device_s), idle_s=dict(idle_s), steps=steps,
               items_s=sum(device_s.values()),
               wait_s=sum(e["dur"] for e in _spans(program)
                          if e["name"] == "prefetch.get") / 1e6)
    return out


def idle_by_span(attr: Dict[str, object]) -> List[list]:
    """The ten spans with the most idle time before their launches, then
    the idle outside every span and at the edges, ``[name, seconds]``."""
    idle = attr.get("idle_s") or {}
    named = sorted(((n, s) for n, s in idle.items()
                    if n not in (OUTSIDE, EDGE)), key=lambda kv: -kv[1])
    return [[n, s] for n, s in named[:10]] + [
        [n, idle.get(n, 0.0)] for n in (OUTSIDE, EDGE)]


def device_ms(run, name: str) -> Optional[float]:
    """Device milliseconds a step of the items attributed to span
    ``name`` in the program session; None without one, or unaligned."""
    prog = (run.trace or {}).get("program")
    attr = prog and prog.get("attribution")
    if not attr or not attr.get("aligned") or not attr.get("steps"):
        return None
    return 1e3 * attr["device_s"].get(name, 0.0) / attr["steps"]


def input_interference_ms(events: List[dict]) -> Optional[float]:
    """Over a window's program events: step k runs from the start of the
    k-th ``prefetch.get`` to the start of the next.  The steps whose
    interval overlaps a ``data.refill``, less the median of those that
    overlap none (never below 0), summed, over the number of steps, in
    ms; None with fewer than 3 steps that overlap none."""
    spans = _spans(events)
    gets = sorted(e["ts"] for e in spans if e["name"] == "prefetch.get")
    refills = [(e["ts"], e["ts"] + e["dur"]) for e in spans
               if e["name"] == "data.refill"]
    hit, clean = [], []
    for a, b in zip(gets, gets[1:]):
        (hit if any(s < b and e > a for s, e in refills)
         else clean).append(b - a)
    if len(clean) < 3:
        return None
    med = statistics.median(clean)
    return sum(max(0.0, d - med) for d in hit) / 1e3 / (len(hit) + len(clean))
