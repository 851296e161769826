"""Execution engines.

`OrdinaryEngine` — the paper's baseline (Figure 3): every component owns a
separate output cache; on EVERY edge the rows are physically copied into the
downstream component's input cache; execution is sequential.

`OptimizedEngine` — the paper's framework: Algorithm-1 partitioning into
execution trees, shared caching inside each tree (zero copies), Algorithm-2
pipeline parallelization per tree, §4.3 inside-component multithreading, and
concurrent execution of independent trees (the dataflow task planner).  All
work — tree coordination, pipeline split consumers and §4.3 row ranges —
runs on ONE shared, size-bounded worker pool (executor.py) sized by the
runtime planner.

`StreamingEngine` — `OptimizedEngine` with inter-tree split streaming turned
on: bounded channels replace accumulate-then-start on every tree->tree edge,
so a downstream tree whose root is row-synchronized (an explicit
StageBoundary) consumes splits as they arrive and overlaps with its
upstream; block / semi-block roots keep accumulate-then-finish semantics.

`ServingEngine` — the resident loop behind ``Session.serve``: plans once,
keeps one worker pool across micro-batches and runs one streaming executor
per tick over the same components.
"""
from __future__ import annotations

import time
from contextlib import nullcontext
from dataclasses import dataclass, field, replace
from typing import TYPE_CHECKING, Dict, List, Optional, Tuple

from ..obs import trace as obs_trace
from . import config, faults
from .backend import Backend, resolve_backend
from .component import ComponentType, SourceComponent
from .executor import SharedWorkerPool, StreamingExecutor
from .graph import Dataflow
from .metadata import MetadataStore
from .partitioner import ExecutionTreeGraph, partition
from .planner import PipelinePlan, RuntimePlan, build_plan, plan_runtime
from .shared_cache import (GLOBAL_ARENA, SharedCache, cache_stats_scope,
                           record_copy)

if TYPE_CHECKING:
    from .shard import ShardResult

#: environment switch for segment fusion when OptimizeOptions.fuse_segments
#: is left unset (the CI fusion leg runs the whole suite under REPRO_FUSION=1;
#: typed accessor: ``core.config.fusion_default``)
FUSION_ENV_VAR = config.ENV_FUSION


@dataclass
class EngineRun:
    wall_time: float
    copies: int
    bytes_copied: int
    engine: str
    backend: str = "numpy"
    h2d_bytes: int = 0              # host->device bytes moved by the backend
    d2h_bytes: int = 0              # device->host bytes (sinks / host merges)
    h2d_transfers: int = 0          # discrete host->device crossings
    d2h_transfers: int = 0          # discrete device->host crossings
    #: total backend dispatches (Component.calls summed over the flow) — the
    #: per-chunk activity-call count segment fusion collapses
    dispatch_calls: int = 0
    # CacheArena traffic attributed to this run
    arena_hits: int = 0
    arena_misses: int = 0
    arena_bytes_reused: int = 0
    activity_times: Dict[str, float] = field(default_factory=dict)
    trees: Optional[List[List[str]]] = None
    plans: Dict[int, PipelinePlan] = field(default_factory=dict)
    runtime_plan: Optional[RuntimePlan] = None
    streamed_edges: List[Tuple[int, int]] = field(default_factory=list)
    pool_stats: Dict[str, int] = field(default_factory=dict)
    # fault tolerance: transient retries taken, degradation-ladder fallbacks
    # and injected faults attributed to this run (all zero on a no-fault run)
    retries: int = 0
    degradations: int = 0
    faults_injected: int = 0
    #: per-fallback detail (core.faults.Degradation.spec() dicts)
    degradation_events: List[Dict[str, object]] = field(default_factory=list)
    #: sharded execution (core/shard): shard count the run actually used
    #: (1 = serial) and the source rows each shard processed
    shards: int = 1
    shard_rows: List[int] = field(default_factory=list)
    #: a sharded run's ``core.shard.ShardResult`` (the route it took, its
    #: partitioning mode, shuffle bytes, process-route costs); None when
    #: the run was serial
    shard: Optional["ShardResult"] = None
    # adaptive path (optimize_level=2): graph rewrites applied before the run
    rewrites: List[Dict[str, str]] = field(default_factory=list)
    # rewrites the optimizer REFUSED for safety (with reasons) — refusals
    # mentioning an "undeclared" read/write set mark optimizations a lambda
    # predicate silently disabled (the DSL derives provenance instead)
    refusals: List[Dict[str, str]] = field(default_factory=list)
    # run identity (joins this run to its metadata / bench-JSON / trace
    # artifacts) + per-run observability (repro.obs)
    run_id: str = field(default_factory=obs_trace.new_run_id)
    created: str = field(default_factory=obs_trace.iso_now)
    git_sha: Optional[str] = field(default_factory=obs_trace.git_sha)
    #: MetricsRegistry.snapshot() of the run's tracer ({} when tracing off);
    #: its counters reconcile exactly with the CacheStats fields above
    metrics: Dict[str, object] = field(default_factory=dict)
    #: exported Chrome-trace/Perfetto file (REPRO_TRACE=1), else None
    trace_file: Optional[str] = None

    def summary(self) -> str:
        s = (f"[{self.engine}/{self.backend}] wall={self.wall_time:.3f}s "
             f"copies={self.copies} "
             f"bytes_copied={self.bytes_copied/1e6:.1f}MB")
        if self.h2d_bytes or self.d2h_bytes:
            s += (f" h2d={self.h2d_bytes/1e6:.1f}MB/{self.h2d_transfers}x"
                  f" d2h={self.d2h_bytes/1e6:.1f}MB/{self.d2h_transfers}x")
        if self.arena_hits or self.arena_misses:
            s += (f" arena={self.arena_hits}h/{self.arena_misses}m/"
                  f"{self.arena_bytes_reused/1e6:.1f}MB")
        if self.rewrites:
            s += f" rewrites={len(self.rewrites)}"
        if self.refusals:
            s += f" refusals={len(self.refusals)}"
        if self.retries or self.degradations or self.faults_injected:
            s += (f" faults={self.faults_injected} retries={self.retries} "
                  f"degradations={self.degradations}")
        if self.shards > 1:
            s += f" shards={self.shards}"
        return s

    def spec(self) -> dict:
        """Metadata-store / benchmark-JSON representation: the scalar
        instrumentation of one run (no plan/tree objects)."""
        return {"engine": self.engine, "backend": self.backend,
                "wall_time": self.wall_time,
                "copies": self.copies, "bytes_copied": self.bytes_copied,
                "h2d_transfers": self.h2d_transfers,
                "h2d_bytes": self.h2d_bytes,
                "d2h_transfers": self.d2h_transfers,
                "d2h_bytes": self.d2h_bytes,
                "dispatch_calls": self.dispatch_calls,
                "arena_hits": self.arena_hits,
                "arena_misses": self.arena_misses,
                "arena_bytes_reused": self.arena_bytes_reused,
                "retries": self.retries,
                "degradations": self.degradations,
                "faults_injected": self.faults_injected,
                "shards": self.shards,
                "shard_rows": list(self.shard_rows),
                "degradation_events": list(self.degradation_events),
                "rewrites": list(self.rewrites),
                "refusals": list(self.refusals),
                "run_id": self.run_id, "created": self.created,
                "git_sha": self.git_sha,
                "metrics": dict(self.metrics),
                "trace_file": self.trace_file}


def _assign_backend(flow: Dataflow, backend: Backend) -> None:
    """Point every component of the flow at the run's operator backend."""
    for comp in flow.vertices.values():
        comp.backend = backend


def _dispatch_calls(flow: Dataflow) -> int:
    return sum(c.calls for c in flow.vertices.values())


def _run_counters(run: EngineRun, snap: Dict[str, int]) -> None:
    """Fill an EngineRun's cache/arena counters from a per-run scope
    snapshot (exact attribution — no global-diff races)."""
    run.copies = snap["copies"]
    run.bytes_copied = snap["bytes_copied"]
    run.h2d_bytes = snap["h2d_bytes"]
    run.d2h_bytes = snap["d2h_bytes"]
    run.h2d_transfers = snap["h2d_transfers"]
    run.d2h_transfers = snap["d2h_transfers"]
    run.arena_hits = snap["arena_hits"]
    run.arena_misses = snap["arena_misses"]
    run.arena_bytes_reused = snap["arena_bytes_reused"]
    run.retries = snap["retries"]
    run.degradations = snap["degradations"]
    run.faults_injected = snap["faults_injected"]


def _finish_obs(tracer, run: EngineRun,
                pool_stats: Optional[Dict[str, int]] = None,
                channel_hwm: Optional[int] = None) -> None:
    """End-of-run observability: derive the gauges (arena hit rate, pool
    utilization, channel high-water), attach the metric snapshot to the run
    and export the trace (no-op when tracing is off)."""
    if tracer is None:
        return
    m = tracer.metrics
    attempts = run.arena_hits + run.arena_misses
    if attempts:
        m.gauge_set("arena_hit_rate", run.arena_hits / attempts)
    m.gauge_set("arena_pooled_bytes", GLOBAL_ARENA.pooled_bytes)
    if pool_stats:
        m.gauge_set("pool_width", pool_stats.get("width", 0))
        m.gauge_set("pool_threads_hwm", pool_stats.get("threads_hwm", 0))
        m.gauge_set("pool_tasks_run", pool_stats.get("tasks_run", 0))
        width = pool_stats.get("width") or 0
        if width:
            m.gauge_set("pool_utilization",
                        pool_stats.get("runnable_hwm", 0) / width)
    if channel_hwm is not None:
        m.gauge_set("channel_occupancy_hwm", channel_hwm)
    run.metrics = m.snapshot()
    run.trace_file = obs_trace.export_run(
        tracer, meta={"run_id": run.run_id, "created": run.created,
                      "git_sha": run.git_sha, "engine": run.engine,
                      "backend": run.backend, "wall_s": run.wall_time})


# --------------------------------------------------------------------------
#  Ordinary engine (baseline)
# --------------------------------------------------------------------------
class OrdinaryEngine:
    """Separate input/output caches, copy on every edge, sequential."""

    def __init__(self, flow: Dataflow, chunk_rows: int = 65536,
                 backend: Optional[str] = None):
        self.flow = flow
        self.chunk_rows = chunk_rows
        self.backend = backend        # None => REPRO_BACKEND env / "torch"

    def _push(self, name: str, cache: SharedCache,
              states: Dict[str, list]) -> None:
        comp = self.flow.component(name)
        if comp.ctype in (ComponentType.BLOCK, ComponentType.SEMI_BLOCK):
            comp.accumulate(states[name], cache)
            return
        outs = comp.process(cache, shared=False)
        self._route(name, outs, states)
        cache.recycle()      # downstream got copies; this cache is consumed

    def _route(self, name: str, outs: List[SharedCache],
               states: Dict[str, list]) -> None:
        succs = self.flow.succ(name)
        per_port = len(outs) == len(succs) and len(outs) > 1
        for i, u in enumerate(succs):
            out = outs[i] if per_port else outs[0]
            # separate-cache scheme: copy output cache -> downstream input cache
            copied = out.copy()
            record_copy(out)
            self._push(u, copied, states)

    def run(self) -> EngineRun:
        self.flow.validate()
        self.flow.reset_stats()
        bk = resolve_backend(self.backend)
        _assign_backend(self.flow, bk)
        with obs_trace.run_scope(flow=self.flow.name, engine="ordinary",
                                 backend=bk.name) as tracer:
            t_start = time.perf_counter()
            with cache_stats_scope() as stats, obs_trace.measured(tracer), \
                    obs_trace.span("phase", "execute"):
                states: Dict[str, list] = {
                    n: c.new_state() for n, c in self.flow.vertices.items()
                    if c.ctype in (ComponentType.BLOCK, ComponentType.SEMI_BLOCK)}
                # stream every source, chunk by chunk
                for sname in self.flow.sources():
                    src = self.flow.component(sname)
                    if isinstance(src, SourceComponent):
                        for chunk in src.chunks(self.chunk_rows):
                            self._route(sname, [chunk], states)
                            chunk.recycle()
                    else:
                        raise TypeError(
                            f"source {sname!r} is not a SourceComponent")
                # finalize block/semi-block components in topological order
                for name in self.flow.topo_order():
                    comp = self.flow.component(name)
                    if comp.ctype in (ComponentType.BLOCK,
                                      ComponentType.SEMI_BLOCK):
                        out = comp.finish(states[name])
                        self._route(name, [out], states)
                        out.recycle()
            wall = time.perf_counter() - t_start
            run = EngineRun(
                wall_time=wall, copies=0, bytes_copied=0,
                engine="ordinary",
                backend=bk.name,
                dispatch_calls=_dispatch_calls(self.flow),
                activity_times={n: c.busy_time
                                for n, c in self.flow.vertices.items()})
            _run_counters(run, stats.snapshot())
            _finish_obs(tracer, run)
        return run


# --------------------------------------------------------------------------
#  Optimized engine (the paper's framework on the streaming runtime)
# --------------------------------------------------------------------------
@dataclass
class OptimizeOptions:
    shared_cache: bool = True          # §3 shared caching scheme
    num_splits: int = 8                # m  — horizontal splits of root output
    pipeline_degree: Optional[int] = None  # m' — in-flight bound; None => m
    pipelined: bool = True             # False => sequential (non-pipeline)
    mt_threads: Dict[str, int] = field(default_factory=dict)  # §4.3 per component
    concurrent_trees: bool = True      # dataflow task planner concurrency
    chunk_rows: Optional[int] = None   # source chunking; None => total/num_splits
    streaming: bool = False            # inter-tree split streaming (executor.py)
    pool_width: Optional[int] = None   # shared pool size; None => planner
    channel_capacity: Optional[int] = None  # per-edge depth; None => planner
    cores: Optional[int] = None        # cap pool width at core count if set
    backend: Optional[str] = None      # operator backend ("numpy"/"torch"/
    #                                    "torch_cpu"); None => REPRO_BACKEND
    #                                    env / "torch"
    #: 1 = the paper's static framework (partition + plan once, up front);
    #: 2 = cost-based adaptive: calibrate on a source prefix, rewrite the
    #: flow from measured statistics (core/optimizer.py), then re-partition
    #: and re-plan with observed per-edge bytes and activity times.
    optimize_level: int = 1
    #: source-prefix rows for the optimize_level=2 calibration run
    calibration_rows: int = 4096
    #: segment fusion: collapse maximal row-synchronized chains into single
    #: compiled-kernel activities (optimizer.fuse_segments_flow).  None =>
    #: follow the REPRO_FUSION env var; applies at every optimize level.
    fuse_segments: Optional[bool] = None
    #: sharded execution (core/shard): partition the source rows over N
    #: shards, run the full per-shard flow, merge partials once at the
    #: coordinator — sinks keep the serial keys, row order and dtypes.
    #: None => follow REPRO_SHARDS (default 1 = serial); 0 = auto-pick from
    #: the row and split counts (shard.choose_shards).
    shards: Optional[int] = None
    #: shard worker route: "auto" | "process" | "mesh" | "inline".  None =>
    #: follow REPRO_SHARD_IMPL (default "auto": mesh on torch / torch_cpu).
    shard_impl: Optional[str] = None

    def fusion_enabled(self) -> bool:
        if self.fuse_segments is not None:
            return bool(self.fuse_segments)
        return config.fusion_default()


class OptimizedEngine:
    def __init__(self, flow: Dataflow, options: Optional[OptimizeOptions] = None,
                 metadata: Optional["MetadataStore"] = None):
        self.flow = flow
        self.options = options or OptimizeOptions()
        self.metadata = metadata       # §2 store: records flow/partition/plan
        self.g_tau: Optional[ExecutionTreeGraph] = None
        self.runtime_plan: Optional[RuntimePlan] = None

    @property
    def engine_name(self) -> str:
        return "streaming" if self.options.streaming else "optimized"

    # ---------------------------------------------------- adaptive planning
    def _adaptive_rewrite(self, bk: Backend, opts: OptimizeOptions):
        """optimize_level=2: calibrate, rewrite the flow from measured
        statistics, re-partition + re-plan with observed costs.  Returns
        (effective options, applied rewrites, refused rewrites)."""
        from .optimizer import (CostBasedOptimizer, measured_edge_bytes,
                                run_calibration, suggest_pipeline_degree)
        streaming = opts.streaming and opts.concurrent_trees
        # BEFORE: the static partitioning + plan the paper's framework uses
        before_tau = partition(self.flow)
        before_plan = plan_runtime(
            self.flow, before_tau,
            num_splits=opts.num_splits,
            m_prime=opts.pipeline_degree or opts.num_splits,
            mt_threads=opts.mt_threads, cores=opts.cores,
            pool_width=opts.pool_width,
            channel_capacity=opts.channel_capacity,
            streaming=streaming, backend=bk)
        with obs_trace.span("phase", "calibrate",
                            sample_rows=opts.calibration_rows):
            # calibration is idempotent (stats reset before/after, sinks
            # never written), so a transient mid-calibration failure just
            # re-runs the whole sample pass
            stats = faults.retry_call(
                lambda: run_calibration(self.flow,
                                        sample_rows=opts.calibration_rows,
                                        backend=bk),
                where=f"calibrate.{self.flow.name}")
        optimizer = CostBasedOptimizer(self.flow, stats, streaming=streaming,
                                       fuse_segments=opts.fusion_enabled())
        with obs_trace.span("phase", "optimize"):
            rewrites = optimizer.optimize()
        _assign_backend(self.flow, bk)     # rewrites may add components
        with obs_trace.span("phase", "plan"):
            self.g_tau = partition(self.flow)
            m_prime = (opts.pipeline_degree
                       or suggest_pipeline_degree(stats, opts.num_splits,
                                                  cores=opts.cores))
            self.runtime_plan = plan_runtime(
                self.flow, self.g_tau,
                num_splits=opts.num_splits, m_prime=m_prime,
                mt_threads=opts.mt_threads, cores=opts.cores,
                pool_width=opts.pool_width,
                channel_capacity=opts.channel_capacity,
                streaming=streaming, backend=bk,
                edge_bytes_override=measured_edge_bytes(self.flow, self.g_tau,
                                                        stats))
        if self.metadata is not None:
            self.metadata.register_statistics(self.flow, stats)
            self.metadata.register_adaptive(
                self.flow, stats=stats, rewrites=rewrites,
                before_partition=before_tau, before_plan=before_plan,
                after_partition=self.g_tau, after_plan=self.runtime_plan)
        # the executor reads m' from the options: hand it a private copy so
        # the caller's options object is never mutated
        return (replace(opts, pipeline_degree=m_prime), rewrites,
                optimizer.refusals)

    # ----------------------------------------------------------- fault replay
    def _reset_for_retry(self) -> None:
        """Return the flow to a runnable state between run-level retry
        attempts: clear the pipeline's order/busy bookkeeping on every
        component and drop any partial output a sink collected during the
        failed attempt (replaying into a half-filled sink would duplicate
        rows).  Accumulator state is per-executor (``new_state`` per run),
        so it needs no reset here."""
        for comp in self.flow.vertices.values():
            comp.next_split = 0
            comp.busy = False
            if comp.ctype is ComponentType.SINK and hasattr(comp, "clear"):
                comp.clear()

    # ---------------------------------------------------------------- run
    def run(self) -> EngineRun:
        opts = self.options
        self.flow.validate()
        self.flow.reset_stats()
        bk = resolve_backend(opts.backend)
        _assign_backend(self.flow, bk)      # before planning: est_output_bytes
        with obs_trace.run_scope(flow=self.flow.name, engine=self.engine_name,
                                 backend=bk.name) as tracer:
            rewrites, refusals = [], []
            if opts.optimize_level >= 2:
                opts, rewrites, refusals = self._adaptive_rewrite(bk, opts)
            else:
                if opts.fusion_enabled():
                    from .optimizer import fuse_segments_flow
                    rewrites = fuse_segments_flow(self.flow)
                    _assign_backend(self.flow, bk)   # fusion adds components
                with obs_trace.span("phase", "plan"):
                    self.g_tau = partition(self.flow)
                    m_prime = opts.pipeline_degree or opts.num_splits
                    self.runtime_plan = plan_runtime(
                        self.flow, self.g_tau,
                        num_splits=opts.num_splits, m_prime=m_prime,
                        mt_threads=opts.mt_threads, cores=opts.cores,
                        pool_width=opts.pool_width,
                        channel_capacity=opts.channel_capacity,
                        streaming=opts.streaming and opts.concurrent_trees,
                        backend=bk)
            if self.metadata is not None:
                self.metadata.register_flow(self.flow)
                self.metadata.register_partitioning(self.flow, self.g_tau)
                self.metadata.register_runtime_plan(self.flow,
                                                    self.runtime_plan)

            t_start = time.perf_counter()
            # Run-level retry: a transient failure that escalated past
            # chunk-level replay (source draw, accumulate, sink write, edge
            # transfer) aborts the executor; the whole run replays on a
            # fresh executor after the flow's transient state is reset.
            # The stats scope / tracer / span stay OUTSIDE the loop so
            # retry counters and failed-attempt work attribute to this run.
            sres = None
            attempt, delay = 0, config.retry_backoff()
            with cache_stats_scope() as stats, obs_trace.measured(tracer), \
                    obs_trace.span("phase", "execute"), \
                    faults.fault_recorder() as frec:
                n_shards = (opts.shards if opts.shards is not None
                            else config.shards())
                if n_shards != 1:
                    # planned inside the run's scopes so a shard_plan
                    # degradation (unshardable flow) attributes to this run
                    from .shard import plan_shards
                    shard_plan = plan_shards(
                        self.flow, self.g_tau, n_shards,
                        opts.shard_impl or config.shard_impl(), opts, bk)
                else:
                    shard_plan = None
                if shard_plan is not None:
                    # sharded path: per-shard transient replay (inside the
                    # runner) supersedes run-level retry
                    from .shard import ShardRunner
                    sres = ShardRunner(self.flow, self.g_tau, opts,
                                       self.runtime_plan, shard_plan,
                                       tracer=tracer).execute()
                    pool_stats = sres.pool_stats
                    streamed_edges = sres.streamed_edges
                    channel_hwm = sres.channel_hwm
                else:
                    while True:
                        executor = StreamingExecutor(self.flow, self.g_tau,
                                                     opts, self.runtime_plan)
                        try:
                            executor.execute()
                            break
                        except BaseException as e:
                            if (faults.classify(e) != "transient"
                                    or attempt >= config.retry_max()):
                                raise
                            faults.record_retry(f"run.{self.flow.name}",
                                                attempt, delay)
                            self._reset_for_retry()
                            if delay > 0.0:
                                time.sleep(delay)
                            delay = min(delay * 2.0 if delay else 0.0,
                                        faults.RETRY_BACKOFF_CAP_S)
                            attempt += 1
                        finally:
                            pool_stats = executor.pool.stats()
                            executor.shutdown()
                    streamed_edges = list(executor.streamed_edges)
                    channel_hwm = executor.channel_hwm()
            wall = time.perf_counter() - t_start
            run = EngineRun(
                wall_time=wall, copies=0, bytes_copied=0,
                engine=self.engine_name,
                backend=bk.name,
                dispatch_calls=_dispatch_calls(self.flow),
                activity_times={n: c.busy_time
                                for n, c in self.flow.vertices.items()},
                trees=[list(t.members) for t in self.g_tau.trees],
                runtime_plan=self.runtime_plan,
                streamed_edges=streamed_edges,
                pool_stats=pool_stats,
                degradation_events=[d.spec() for d in frec.degradations],
                rewrites=[r.spec() for r in rewrites],
                refusals=[r.spec() for r in refusals])
            snap = stats.snapshot()
            if sres is not None:
                # process-route worker counters were already absorbed into
                # this scope (shared_cache.absorb_external), so snap equals
                # the exact sum over all shards on every route
                run.shards = sres.shards
                run.shard_rows = list(sres.shard_rows)
                # dispatch counts live on Component.calls; process-route
                # shard passes ran on worker flow copies, so fold their
                # shipped totals in — inline passes already hit self.flow
                run.dispatch_calls += sres.worker_dispatch
                run.shard = sres
            _run_counters(run, snap)
            _finish_obs(tracer, run, pool_stats=pool_stats,
                        channel_hwm=channel_hwm)
            if self.metadata is not None:
                self.metadata.register_run(self.flow, run)
        return run


class StreamingEngine(OptimizedEngine):
    """OptimizedEngine with inter-tree split streaming enabled."""

    def __init__(self, flow: Dataflow, options: Optional[OptimizeOptions] = None,
                 metadata: Optional["MetadataStore"] = None):
        options = replace(options or OptimizeOptions(), streaming=True)
        super().__init__(flow, options, metadata=metadata)


# --------------------------------------------------------------------------
#  Serving engine (resident micro-batch loop for Session.serve)
# --------------------------------------------------------------------------
class ServingEngine:
    """Resident execution loop behind ``Session.serve``: partition and plan
    ONCE (on the first tick, when the ticking source has data to size
    against), keep one ``SharedWorkerPool`` alive across micro-batches, and
    run each tick as a fresh — but cheap — ``StreamingExecutor`` over the
    SAME flow objects.  Because compiled segment runners, device-resident
    DimTables with their packed hash tables, and arena buffers all live on
    the components (or the global arena), not on the executor, warm ticks
    reuse every piece of state a batch engine rebuilds per run.

    Terminal ``Aggregate`` components are switched into serving mode
    (incremental per-group partials, upsert deltas) for the lifetime of the
    loop; ``close()`` switches them back and releases the pool."""

    engine_name = "serving"

    def __init__(self, flow: Dataflow,
                 options: Optional[OptimizeOptions] = None,
                 metadata: Optional["MetadataStore"] = None):
        self.flow = flow
        self.options = options or OptimizeOptions()
        self.metadata = metadata
        self.g_tau: Optional[ExecutionTreeGraph] = None
        self.runtime_plan: Optional[RuntimePlan] = None
        self.backend: Optional[Backend] = None
        self.pool: Optional[SharedWorkerPool] = None
        self.tracer = None
        self.ticks = 0
        self._started = False
        self._closed = False
        self._serving_aggs: list = []

    # ------------------------------------------------------------ validation
    def _validate_serving_flow(self) -> None:
        """Serving supports row-synchronized chains plus TERMINAL aggregates
        (feeding sinks only).  Other block/semi-block components (Sort,
        Union, Merge) have no incremental upsert semantics — their finish()
        needs the whole input, which an unbounded source never yields."""
        for name, comp in self.flow.vertices.items():
            if hasattr(comp, "begin_serving"):
                bad = [u for u in self.flow.succ(name)
                       if self.flow.component(u).ctype
                       is not ComponentType.SINK]
                if bad:
                    raise ValueError(
                        f"serve(): aggregate {name!r} must feed sinks only "
                        f"(feeds {bad}) — per-tick upsert deltas cannot "
                        f"drive further blocking components")
            elif comp.ctype in (ComponentType.BLOCK,
                                ComponentType.SEMI_BLOCK):
                raise ValueError(
                    f"serve(): {type(comp).__name__} {name!r} is a "
                    f"{comp.ctype.value} component without incremental "
                    f"semantics; serving flows support row-synchronized "
                    f"chains and terminal Aggregates")

    # ----------------------------------------------------------- first tick
    def _start(self) -> None:
        opts = self.options
        if opts.optimize_level >= 2:
            raise ValueError(
                "serve() supports optimize_level<=1: the adaptive optimizer "
                "calibrates on a bounded source prefix, which an unbounded "
                "ticking source does not have")
        if opts.shards is not None and opts.shards > 1:
            # explicit request only — ambient REPRO_SHARDS is ignored here,
            # since the resident tick loop is already incremental and the
            # multi-pass shard protocol assumes a bounded batch input
            raise ValueError("serve() does not support sharded execution; "
                             "drop shards= for serving sessions")
        self.flow.validate()
        self.flow.reset_stats()
        bk = self.backend = resolve_backend(opts.backend)
        _assign_backend(self.flow, bk)
        if opts.fusion_enabled():
            from .optimizer import fuse_segments_flow
            fuse_segments_flow(self.flow)
            _assign_backend(self.flow, bk)   # fusion adds components
        self._validate_serving_flow()
        with obs_trace.span("phase", "plan"):
            self.g_tau = partition(self.flow)
            self.runtime_plan = plan_runtime(
                self.flow, self.g_tau,
                num_splits=opts.num_splits,
                m_prime=opts.pipeline_degree or opts.num_splits,
                mt_threads=opts.mt_threads, cores=opts.cores,
                pool_width=opts.pool_width,
                channel_capacity=opts.channel_capacity,
                streaming=opts.streaming and opts.concurrent_trees,
                backend=bk)
        self.pool = SharedWorkerPool(self.runtime_plan.pool_width,
                                     name=f"{self.flow.name}-serve")
        for comp in self.flow.vertices.values():
            if hasattr(comp, "begin_serving"):
                comp.begin_serving()
                self._serving_aggs.append(comp)
        if self.metadata is not None:
            # the session registers once at start — NOT once per tick, which
            # would grow the store without bound under a resident loop
            self.metadata.register_flow(self.flow)
            self.metadata.register_partitioning(self.flow, self.g_tau)
            self.metadata.register_runtime_plan(self.flow, self.runtime_plan)
        self._started = True

    # ----------------------------------------------------------------- tick
    def tick(self, watermark_lag: Optional[float] = None) -> Dict[str, object]:
        """Run one micro-batch over the source's CURRENT table.  Returns the
        tick's wall time and its exact per-tick ``CacheStats`` snapshot."""
        if self._closed:
            raise RuntimeError("serving engine is closed")
        if self.tracer is None and (obs_trace.ACTIVE.get()
                                    or config.trace_enabled()):
            # ONE tracer for the whole serving session: per-tick spans land
            # in it and a single trace export happens at close() — a
            # per-tick export would rewrite the trace file every tick
            self.tracer = obs_trace.Tracer(name=self.flow.name,
                                           measuring=False)
            self.tracer.meta = {"flow": self.flow.name, "engine": "serving"}
        i = self.ticks
        with (obs_trace.trace_scope(self.tracer)
              if self.tracer is not None else nullcontext()):
            if not self._started:
                self._start()
            # per-tick split numbering restarts at zero: order-sensitive
            # components gate on next_split == cache.split_index, which is
            # monotone within one executor run only.  busy is cleared too so
            # an aborted tick can never deadlock the next one behind a flag
            # its dying task had no chance to release.
            for comp in self.flow.vertices.values():
                comp.next_split = 0
                comp.busy = False
            executor = StreamingExecutor(self.flow, self.g_tau, self.options,
                                         self.runtime_plan, pool=self.pool)
            t0 = time.perf_counter()
            with cache_stats_scope() as stats, \
                    obs_trace.measured(self.tracer), \
                    obs_trace.span("tick", f"tick-{i}", tick=i):
                try:
                    executor.execute()
                finally:
                    executor.shutdown()      # no-op: the pool is resident
            wall = time.perf_counter() - t0
        self.ticks += 1
        if self.tracer is not None:
            m = self.tracer.metrics
            m.inc("ticks")
            m.observe("tick_s", wall)
            if watermark_lag is not None:
                m.gauge_set("watermark_lag_s", watermark_lag)
                m.gauge_max("watermark_lag_s_max", watermark_lag)
        return {"tick": i, "wall_s": wall, "cache_stats": stats.snapshot()}

    # ---------------------------------------------------------------- close
    def close(self) -> Dict[str, object]:
        """End the serving session: aggregates leave serving mode (reusable
        for batch runs), the resident pool joins, the session trace exports
        once.  Idempotent."""
        summary: Dict[str, object] = {
            "engine": self.engine_name, "ticks": self.ticks,
            "backend": self.backend.name if self.backend else None}
        if self._closed:
            return summary
        self._closed = True
        for comp in self._serving_aggs:
            comp.end_serving()
        self._serving_aggs = []
        if self.pool is not None:
            self.pool.shutdown(wait=True)
        if self.tracer is not None:
            self.tracer.meta.update(summary)
            summary["metrics"] = self.tracer.metrics.snapshot()
            summary["trace_file"] = obs_trace.export_run(
                self.tracer, meta={"ticks": self.ticks})
        return summary
