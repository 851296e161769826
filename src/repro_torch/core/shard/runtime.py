"""ShardRunner: the multi-pass coordinator for one sharded run.

Execution model (all routes): N "shard passes" over the SAME flow object
— sources re-pointed at shard k's row partition, every cut component in
``partial`` mode — then ONE "merge" pass with empty sources and cuts in
``merge`` mode, which reassembles the exact serial result from the
stashed partials (see ``merge.py``).  Between passes only transient
pipeline state resets (``next_split``/``busy``), so compiled segment
kernels, device-resident DimTables and arena buffers stay warm exactly
like the serving loop.

Routes (``ShardPlan.impl``):

``inline``   shard passes run sequentially in-process — the always-
             available correctness route (and the fallback rung).
``process``  shard passes fan out to spawned worker processes, each
             shipped a pickled flow carrying ONLY its shard's source rows
             (scatter, not broadcast); workers return partial stashes +
             sink harvests + their exact CacheStats snapshot.  Falls back
             to ``inline`` (recorded degradation) for unpicklable flows,
             broken pools, or when a scoped fault plan / tracer is active
             (contextvar scopes cannot cross a process boundary).
``mesh``     inline passes, but Aggregate second-stage merges run on the
             backend's device (``mesh.py``: float sums through the
             segment-sum kernel); their copies are reported on the
             ``shard-merge`` span.

Fault tolerance: each shard pass is wrapped in ``faults.inject("shard")``
plus transient-retry with whole-shard replay — the pass's stashes and
sink writes roll back, the shard's source partition is re-installed, and
completed shards stay untouched.  The merge pass replays the same way
(stashes are read non-destructively).

Observability: each shard pass runs under its own nested
``cache_stats_scope`` (the run scope sums them automatically) and — when
the run is traced — a nested per-shard sub-``Tracer`` that exports as its
own shard-tagged Perfetto pid.
"""
from __future__ import annotations

import time
from contextlib import nullcontext
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from ...obs import trace as obs_trace
from .. import config, faults
from ..backend import resolve_backend
from ..executor import SharedWorkerPool, StreamingExecutor
from ..shared_cache import SharedCache, absorb_external, cache_stats_scope
from .merge import ShardContext
from .partitioner import shard_tables, table_bytes, table_rows
from .planner import ShardPlan


@dataclass
class ShardResult:
    """What the engine folds into the EngineRun after a sharded execute."""
    shards: int
    impl: str                                  # route actually used
    mode: str
    shard_rows: List[int] = field(default_factory=list)
    #: per-shard exact CacheStats snapshots (process route: the worker's)
    shard_stats: List[Dict[str, int]] = field(default_factory=list)
    merge_stats: Dict[str, int] = field(default_factory=dict)
    #: worker-process counters the parent scope never saw (added to the run)
    extra_stats: Dict[str, int] = field(default_factory=dict)
    scatter_bytes: int = 0                     # max bytes shipped to one shard
    scatter_seconds: float = 0.0               # host time partitioning rows
    source_bytes: int = 0                      # total source bytes
    shuffle_bytes: int = 0                     # stashed partial bytes
    replays: int = 0                           # whole-shard replays taken
    #: dispatch calls made on worker-process flow copies (process route);
    #: the parent flow's own counters never see them
    worker_dispatch: int = 0
    pool_stats: Dict[str, int] = field(default_factory=dict)
    streamed_edges: List = field(default_factory=list)
    channel_hwm: int = 0
    #: process route: kernel launches made in the workers, which the
    #: parent's launch counters never see; the time and bytes of pickling
    #: the shard payloads; the time from the first submit to the last
    #: result; each worker's seconds by step (unpickle, setup, execute)
    worker_launches: Dict[str, int] = field(default_factory=dict)
    payload_seconds: float = 0.0
    payload_bytes: int = 0
    fanout_seconds: float = 0.0
    worker_seconds: List[Dict[str, float]] = field(default_factory=list)
    #: the mesh combiner's own copies to and from the device
    combiner_copies: Dict[str, int] = field(default_factory=dict)


def _sum_stats(*snaps: Dict[str, int]) -> Dict[str, int]:
    out: Dict[str, int] = {}
    for snap in snaps:
        for k, v in snap.items():
            out[k] = out.get(k, 0) + v
    return out


class ShardRunner:
    def __init__(self, flow, g_tau, options, runtime_plan, plan: ShardPlan,
                 tracer=None):
        self.flow = flow
        self.g_tau = g_tau
        self.options = options
        self.runtime_plan = runtime_plan
        self.plan = plan
        self.tracer = tracer
        self.pool: Optional[SharedWorkerPool] = None

    # ------------------------------------------------------------- helpers
    def _reset_transient(self) -> None:
        for comp in self.flow.vertices.values():
            comp.next_split = 0
            comp.busy = False

    def _sinks(self):
        return [self.flow.component(s) for s in self.flow.sinks()]

    def _drop_sink_writes(self) -> None:
        for sink in self._sinks():
            for cache in sink.drain():
                cache.recycle()

    def _run_executor(self, res: ShardResult) -> None:
        executor = StreamingExecutor(self.flow, self.g_tau, self.options,
                                     self.runtime_plan, pool=self.pool)
        try:
            executor.execute()
        finally:
            res.channel_hwm = max(res.channel_hwm, executor.channel_hwm())
            res.streamed_edges = list(executor.streamed_edges)
            executor.shutdown()          # no-op: the pool is shared

    # ------------------------------------------------------------ execute
    def execute(self) -> ShardResult:
        flow, plan = self.flow, self.plan
        res = ShardResult(shards=plan.shards, impl=plan.impl, mode=plan.mode)
        sources = [(name, flow.component(name)) for name in plan.sources]
        orig = {name: comp.columns for name, comp in sources}
        res.source_bytes = sum(table_bytes(t) for t in orig.values())
        t0 = time.perf_counter()
        parts = shard_tables(orig, plan.shards, plan.mode, plan.key)
        res.scatter_seconds = time.perf_counter() - t0
        res.scatter_bytes = max(
            (sum(table_bytes(t) for t in p.values()) for p in parts),
            default=0)
        harvest: Dict[str, List[SharedCache]] = {
            s.name: [] for s in self._sinks()}

        impl = plan.impl
        if impl == "process":
            impl = self._process_preflight(impl)
        combiner = None
        if impl == "mesh":
            from .mesh import make_combiner
            combiner = make_combiner(resolve_backend(self.options.backend))
            if combiner is None:
                faults.record_degradation("shard_impl", "mesh", "inline",
                                          component=flow.name)
                impl = "inline"
        res.impl = impl
        ctx = ShardContext(combiner=combiner)
        cuts = [flow.component(name) for name in plan.cuts]
        try:
            for comp in cuts:
                comp.shard_role = "partial"
                comp._shard_ctx = ctx
            if impl == "process":
                self._run_process_passes(parts, ctx, harvest, res)
            else:
                self.pool = SharedWorkerPool(
                    self.runtime_plan.pool_width,
                    name=f"{flow.name}-shard")
                self._run_inline_passes(sources, parts, ctx, harvest, res)
            if self.pool is None:
                self.pool = SharedWorkerPool(
                    self.runtime_plan.pool_width,
                    name=f"{flow.name}-shard")
            # ---------------------------------------------- merge pass
            for comp in cuts:
                comp.shard_role = "merge"
            for name, comp in sources:
                comp.set_data({k: v[:0] for k, v in orig[name].items()})
            ctx.begin_merge()
            with cache_stats_scope() as mstats, \
                    obs_trace.span("phase", "shard-merge",
                                   shards=plan.shards, impl=impl,
                                   mode=plan.mode) as merge_span:
                self._with_replay(
                    "merge", lambda: self._merge_attempt(res), ctx, res,
                    rollback=self._drop_sink_writes)
                if combiner is not None:
                    res.combiner_copies = dict(combiner.copies)
                    if hasattr(merge_span, "args"):    # tracing is on
                        merge_span.args.update(
                            {f"combiner_{k}": v
                             for k, v in res.combiner_copies.items()})
            res.merge_stats = mstats.snapshot()
            # ------------------------------------------- sink reassembly
            for sink in self._sinks():
                buf = sink.drain()
                if buf:
                    # cut-fed sink: the merge pass wrote the serial result;
                    # shard-pass harvests were schema-empties
                    sink.reinject(buf)
                    for cache in harvest[sink.name]:
                        cache.recycle()
                else:
                    # row-synchronized-fed sink: the harvested shard-pass
                    # caches, renumbered shard-major, ARE the serial rows
                    for i, cache in enumerate(harvest[sink.name]):
                        cache.split_index = i
                    sink.reinject(harvest[sink.name])
                harvest[sink.name] = []
        finally:
            for comp in cuts:
                comp.shard_role = None
                if hasattr(comp, "_shard_ctx"):
                    del comp._shard_ctx
            for name, comp in sources:
                comp.set_data(orig[name])
            for caches in harvest.values():
                for cache in caches:
                    cache.recycle()
            if self.pool is not None:
                res.pool_stats = self.pool.stats()
                self.pool.shutdown()
        res.shuffle_bytes = ctx.shuffle_bytes
        return res

    def _merge_attempt(self, res: ShardResult) -> None:
        self._reset_transient()
        self._run_executor(res)

    # -------------------------------------------------------- shard replay
    def _with_replay(self, label: str, attempt_fn, ctx: ShardContext,
                     res: ShardResult, rollback=None,
                     inject_split: Optional[int] = None) -> None:
        """Run one pass with transient-failure replay: roll back the pass's
        stashes/sink writes, then rerun, up to ``REPRO_RETRY_MAX`` times."""
        attempt, delay = 0, config.retry_backoff()
        while True:
            try:
                # merge attempts inject with split=None — the coordinator
                # pass is a chaos target too, and its replay is covered
                faults.inject("shard", component=self.flow.name,
                              split=inject_split)
                attempt_fn()
                return
            except BaseException as e:
                if (faults.classify(e) != "transient"
                        or attempt >= config.retry_max()):
                    raise
                faults.record_retry(f"shard.{self.flow.name}.{label}",
                                    attempt, delay)
                res.replays += 1
                if inject_split is not None:
                    ctx.rollback_pass(inject_split)
                self._drop_sink_writes()
                if rollback is not None:
                    rollback()
                if delay > 0.0:
                    time.sleep(delay)
                delay = min(delay * 2.0 if delay else 0.0,
                            faults.RETRY_BACKOFF_CAP_S)
                attempt += 1

    # ------------------------------------------------------- inline / mesh
    def _run_inline_passes(self, sources, parts, ctx: ShardContext,
                           harvest, res: ShardResult) -> None:
        for k in range(self.plan.shards):
            sub = None
            if self.tracer is not None:
                sub = obs_trace.Tracer(
                    name=f"{self.flow.name}[shard{k}]", measuring=False)
                sub.meta = dict(self.tracer.meta, shard=k,
                                flow=f"{self.flow.name}[shard{k}]")
                self.tracer.shard_tracers.append(sub)

            def one_pass(k=k):
                for name, comp in sources:
                    comp.set_data(parts[k][name])
                self._reset_transient()
                ctx.begin_pass(k)
                with obs_trace.span("phase", f"shard-{k}", shard=k):
                    self._run_executor(res)

            with cache_stats_scope() as sstats, \
                    (obs_trace.trace_scope(sub) if sub is not None
                     else nullcontext()):
                self._with_replay(str(k), one_pass, ctx, res,
                                  inject_split=k)
                for sink in self._sinks():
                    # drain() yields arrival order; streamed splits can
                    # finish out of order, and the shard-major renumber at
                    # reassembly erases split_index — restore split order
                    # here so serial ordering survives
                    harvest[sink.name].extend(
                        sorted(sink.drain(), key=lambda c: c.split_index))
            res.shard_stats.append(sstats.snapshot())
            res.shard_rows.append(
                sum(table_rows(t) for t in parts[k].values()))

    # ------------------------------------------------------------- process
    def _process_preflight(self, impl: str) -> str:
        """Scoped fault plans / tracers live in contextvars and cannot
        follow work into a spawned process; degrade to inline so their
        semantics (deterministic injection, exact event capture) hold."""
        if faults._SCOPES.get() or obs_trace.ACTIVE.get():
            faults.record_degradation("shard_impl", "process", "inline",
                                      component=self.flow.name)
            return "inline"
        return impl

    def _run_process_passes(self, parts, ctx: ShardContext, harvest,
                            res: ShardResult) -> None:
        from . import proc
        t0 = time.perf_counter()
        payloads = proc.build_payloads(self.flow, self.options,
                                       self.plan, parts)
        res.payload_seconds = time.perf_counter() - t0
        if payloads is None:            # unpicklable flow
            faults.record_degradation("shard_impl", "process", "inline",
                                      component=self.flow.name)
            res.impl = "inline"
            sources = [(n, self.flow.component(n)) for n in self.plan.sources]
            self.pool = SharedWorkerPool(self.runtime_plan.pool_width,
                                         name=f"{self.flow.name}-shard")
            self._run_inline_passes(sources, parts, ctx, harvest, res)
            return
        res.payload_bytes = sum(len(p) for p in payloads)
        t0 = time.perf_counter()
        try:
            shard_payloads = proc.run_passes(
                self.flow, payloads, ctx, res,
                backend=resolve_backend(self.options.backend))
        except proc.ProcessRouteUnavailable as e:
            faults.record_degradation("shard_impl", "process", "inline",
                                      component=self.flow.name, error=str(e))
            res.impl = "inline"
            sources = [(n, self.flow.component(n)) for n in self.plan.sources]
            self.pool = SharedWorkerPool(self.runtime_plan.pool_width,
                                         name=f"{self.flow.name}-shard")
            self._run_inline_passes(sources, parts, ctx, harvest, res)
            return
        res.fanout_seconds = time.perf_counter() - t0
        for k, payload in enumerate(shard_payloads):
            ctx.absorb(payload["agg"], payload["generic"])
            for name, entries in payload["sinks"].items():
                # workers ship sink caches in arrival order; sort by the
                # original split index so the shard-major renumber at
                # reassembly preserves serial ordering
                for (split_index, cols, n) in sorted(
                        entries, key=lambda e: e[0]):
                    harvest[name].append(SharedCache(cols, n, split_index))
            res.shard_stats.append(payload["stats"])
            res.shard_rows.append(payload["rows"])
            res.worker_dispatch += payload.get("dispatch", 0)
            res.worker_seconds.append(payload.get("seconds", {}))
            for name, n in payload.get("launches", {}).items():
                res.worker_launches[name] = (
                    res.worker_launches.get(name, 0) + n)
        res.extra_stats = _sum_stats(*res.shard_stats)
        # the workers' counters never hit this process's collectors; fold
        # them into the global stats and every active scope (the engine's
        # run scope included) so sharded runs attribute identically to
        # in-process ones
        absorb_external(res.extra_stats)
