"""A Kettle-like (Pentaho PDI) baseline engine — the paper's §5.2 comparison.

Kettle's architecture: every step (component) runs in its own thread,
connected by bounded row-set buffers; rows are COPIED between steps (separate
output/input caches — no shared caching), and steps optionally run multiple
internal worker threads.  This engine mirrors that: one thread per component,
a bounded queue per component, a physical copy on every hop, and optional
inside-component multithreading — but NO execution-tree partitioning, NO
shared caching and NO Theorem-1 pipeline planning.
"""
from __future__ import annotations

import contextvars
import queue
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..core.component import ComponentType, SourceComponent
from ..core.engine import EngineRun, _finish_obs, _run_counters
from ..core.graph import Dataflow
from ..core.shared_cache import SharedCache, cache_stats_scope, record_copy
from ..obs import trace as obs_trace

_EOS = object()


class KettleEngine:
    def __init__(self, flow: Dataflow, chunk_rows: int = 65536,
                 queue_caches: int = 4,
                 mt_threads: Optional[Dict[str, int]] = None,
                 backend: Optional[str] = None):
        self.flow = flow
        self.chunk_rows = chunk_rows
        self.queue_caches = queue_caches
        self.mt_threads = mt_threads or {}
        self.backend = backend      # None => REPRO_BACKEND env / "torch"

    def run(self) -> EngineRun:
        from ..core.backend import resolve_backend
        flow = self.flow
        flow.validate()
        flow.reset_stats()
        bk = resolve_backend(self.backend)
        for comp in flow.vertices.values():
            comp.backend = bk
        inqs: Dict[str, "queue.Queue"] = {
            n: queue.Queue(maxsize=self.queue_caches) for n in flow.vertices}
        errors: List[BaseException] = []
        mt_max = max([1] + list(self.mt_threads.values()))
        pool = ThreadPoolExecutor(max_workers=mt_max) if mt_max > 1 else None

        def route(name: str, outs: List[SharedCache], split_index: int) -> None:
            succs = flow.succ(name)
            per_port = len(outs) == len(succs) and len(outs) > 1
            for i, u in enumerate(succs):
                out = outs[i] if per_port else outs[0]
                copied = out.copy()               # rowset hop = physical copy
                record_copy(out)
                copied.split_index = split_index
                inqs[u].put(copied)

        def route_eos(name: str) -> None:
            for u in flow.succ(name):
                inqs[u].put(_EOS)

        def process_one(comp, cache: SharedCache) -> List[SharedCache]:
            t = self.mt_threads.get(comp.name, 1)
            if (t > 1 and comp.supports_multithreading and pool is not None
                    and cache.n > t):
                t0 = time.perf_counter()
                ranges = cache.row_ranges(t)
                futs = [pool.submit(comp.process_range, cache, r)
                        for r in ranges]
                parts = [f.result() for f in futs]
                outs = comp.merge_ranges(cache, ranges, parts)
                t1 = time.perf_counter()
                comp.busy_time += t1 - t0
                comp.calls += 1
                if obs_trace.ACTIVE.get():
                    obs_trace.on_dispatch(comp.name, t0, t1,
                                          cache.split_index, cache.n,
                                          sum(c.n for c in outs),
                                          mt=len(ranges))
                return outs
            return comp.process(cache, shared=True)

        def step_thread(name: str) -> None:
            comp = flow.component(name)
            try:
                if isinstance(comp, SourceComponent):
                    for i, chunk in enumerate(comp.chunks(self.chunk_rows)):
                        route(name, [chunk], i)
                    route_eos(name)
                    return
                eos_needed = flow.in_degree(name)
                eos_seen = 0
                is_block = comp.ctype in (ComponentType.BLOCK,
                                          ComponentType.SEMI_BLOCK)
                state = comp.new_state() if is_block else None
                while eos_seen < eos_needed:
                    item = inqs[name].get()
                    if item is _EOS:
                        eos_seen += 1
                        continue
                    if is_block:
                        comp.accumulate(state, item)
                    else:
                        outs = process_one(comp, item)
                        route(name, outs, item.split_index)
                if is_block:
                    # deterministic accumulation order
                    state.sort(key=lambda c: c.split_index)
                    out = comp.finish(state)
                    route(name, [out], 0)
                route_eos(name)
            except BaseException as e:  # noqa: BLE001
                errors.append(e)
                route_eos(name)

        with obs_trace.run_scope(flow=flow.name, engine="kettle",
                                 backend=bk.name) as tracer:
            t_start = time.perf_counter()
            with cache_stats_scope() as stats, obs_trace.measured(tracer), \
                    obs_trace.span("phase", "execute"):
                # raw step threads do not inherit contextvars: run each under
                # a context captured INSIDE the scope so the per-run
                # collectors (cache stats AND tracer) see every hop copy
                ctx = contextvars.copy_context()
                threads = [threading.Thread(
                    target=lambda n=n: ctx.copy().run(step_thread, n),
                    daemon=True, name=f"kettle-{n}")
                    for n in flow.topo_order()]
                for th in threads:
                    th.start()
                for th in threads:
                    th.join()
                if pool is not None:
                    pool.shutdown()
            wall = time.perf_counter() - t_start
            if errors:
                raise errors[0]
            run = EngineRun(
                wall_time=wall, copies=0, bytes_copied=0,
                engine="kettle",
                backend=bk.name,
                dispatch_calls=sum(c.calls for c in flow.vertices.values()),
                activity_times={n: c.busy_time
                                for n, c in flow.vertices.items()})
            _run_counters(run, stats.snapshot())
            _finish_obs(tracer, run)
        return run
