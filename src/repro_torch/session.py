"""Unified user-facing front end: declarative flow construction + one run
entry point.

``FlowBuilder`` (``repro_torch.flow("q4.1")``) chains ETL components
fluently over the column-expression DSL and finishes with ``.sink()``, which
validates the flow AND statically checks every expression's read columns
against the propagated schema (``core/planner.infer_schema``) — a typo'd
column name fails at build time with the component and column named, not as
a ``KeyError`` in a worker thread mid-run.

``Session`` unifies what used to take four engine classes, the backend
registry, ``OptimizeOptions``, calibration and the metadata store:

    import repro_torch
    import numpy as np

    f = (repro_torch.flow("q4.1")
         .source(data.lineorder)
         .lookup(cust_dim, "lo_custkey", {"c_nation": "c_nation"})
         .filter(repro_torch.col("c_nation") >= 0)
         .derive("profit", repro_torch.col("lo_revenue")
                 - repro_torch.col("lo_supplycost"))
         .aggregate(["d_year", "c_nation"], {"profit": ("profit", "sum")})
         .sink())

    session = repro_torch.Session(backend="torch")
    res = session.run(f, engine="streaming", optimize=2, fuse=True)
    res.table                     # {column: np.ndarray}
    res.run.summary()             # EngineRun instrumentation

``Session.run`` also accepts any object with ``.flow``/``.sink`` attributes
(e.g. an ``etl.queries.QueryFlow``) or a bare ``(Dataflow, sink)`` pair.

With no backend named (argument, ``options`` or ``REPRO_BACKEND``), runs
resolve to ``torch``, which needs a CUDA card; ``backend="torch_cpu"`` runs
the same code on the CPU through the kernels' plain versions.
"""
from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass, field, replace
from typing import Dict, Iterable, List, Optional, Sequence, Tuple, Union

import numpy as np

from .core import (Dataflow, EngineRun, MetadataStore, OptimizedEngine,
                   OptimizeOptions, OrdinaryEngine, ServingEngine,
                   StreamingEngine)
from .core import config as _config
from .core import faults as _faults
from .core.component import StageBoundary
from .core.optimizer import FlowStatistics, run_calibration
from .core.planner import infer_schema
from .etl.components import (Aggregate, ArraySource, CollectSink, Converter,
                             DimTable, Expression, Filter, Lookup, Project,
                             Sort)
from .etl.kettle import KettleEngine

__all__ = ["Flow", "FlowBuilder", "ServeSession", "Session", "SessionRun",
           "TickResult", "flow", "replay_deltas"]


@dataclass
class Flow:
    """A built dataflow plus its collecting sink — what ``FlowBuilder.sink``
    returns and ``Session.run`` consumes."""
    name: str
    flow: Dataflow
    sink: CollectSink
    #: statically inferred output schema at the sink (None when an
    #: unknown-provenance component poisoned the inference)
    schema: Optional[frozenset] = None

    def result(self) -> Dict[str, np.ndarray]:
        return self.sink.result()


class FlowBuilder:
    """Fluent linear-chain flow construction.  Every step appends one
    component; ``sink()`` validates and seals the flow.  Component names are
    auto-generated (``filter_1``, ``derive_2``, ...) unless ``name=`` is
    given."""

    def __init__(self, name: str = "flow"):
        self.name = name
        self._flow = Dataflow(name)
        self._chain: list = []
        self._n = 0

    # ------------------------------------------------------------ internals
    def _auto(self, prefix: str, name: Optional[str]) -> str:
        self._n += 1
        return name if name else f"{prefix}_{self._n}"

    def _append(self, comp) -> "FlowBuilder":
        if self._chain and isinstance(self._chain[-1], CollectSink):
            raise ValueError(f"flow {self.name!r} is already sealed by a "
                             f"sink — no further steps allowed")
        if not self._chain and not isinstance(comp, ArraySource):
            raise ValueError(f"flow {self.name!r} must start with .source()")
        self._chain.append(comp)
        return self

    @staticmethod
    def _dim(dim) -> DimTable:
        """Accept a prebuilt DimTable or a (key, payload[, row_filter])
        tuple."""
        if isinstance(dim, DimTable):
            return dim
        if isinstance(dim, tuple) and len(dim) in (2, 3):
            return DimTable(*dim)
        raise TypeError("lookup dimension must be a DimTable or a "
                        "(key_array, payload_dict[, row_filter]) tuple")

    # ----------------------------------------------------------------- steps
    def source(self, columns: Dict[str, np.ndarray], *,
               name: str = "source") -> "FlowBuilder":
        """Start the flow from an in-memory columnar table."""
        if self._chain:
            raise ValueError(f"flow {self.name!r} already has a source")
        self._chain.append(ArraySource(name, columns))
        return self

    def lookup(self, dim, key, returns: Dict[str, str], *,
               default: int = -1, matched_flag: Optional[str] = None,
               name: Optional[str] = None) -> "FlowBuilder":
        """Join a dimension table: ``returns`` maps output column -> dim
        payload column; unmatched rows get ``default``."""
        return self._append(Lookup(self._auto("lookup", name),
                                   self._dim(dim), key, dict(returns),
                                   default=default,
                                   matched_flag=matched_flag))

    def filter(self, predicate, *, name: Optional[str] = None,
               reads: Optional[Sequence[str]] = None) -> "FlowBuilder":
        """Keep rows where the predicate holds — preferably a DSL expression
        (exact derived provenance)."""
        return self._append(Filter(self._auto("filter", name), predicate,
                                   reads=reads))

    def derive(self, out_col: str, expr, *, name: Optional[str] = None,
               reads: Optional[Sequence[str]] = None) -> "FlowBuilder":
        """Compute a new column from existing ones."""
        return self._append(Expression(self._auto("derive", name), out_col,
                                       expr, reads=reads))

    def project(self, *keep, name: Optional[str] = None) -> "FlowBuilder":
        """Keep only the named columns (metadata-only under shared
        caching)."""
        return self._append(Project(self._auto("project", name), list(keep)))

    def convert(self, conversions: Optional[Dict[str, np.dtype]] = None, *,
                name: Optional[str] = None, **dtypes) -> "FlowBuilder":
        """Convert column dtypes: ``convert({"x": np.int32})`` or
        ``convert(x=np.int32)``."""
        conv = dict(conversions or {})
        conv.update(dtypes)
        return self._append(Converter(self._auto("convert", name), conv))

    def boundary(self, *, name: Optional[str] = None) -> "FlowBuilder":
        """Insert an explicit StageBoundary cut (streaming tree boundary)."""
        return self._append(StageBoundary(self._auto("boundary", name)))

    def aggregate(self, group_by: Sequence, aggs: Dict[str, Tuple], *,
                  name: Optional[str] = None) -> "FlowBuilder":
        """Group-by aggregation: ``aggs`` maps output column ->
        (input column, op) with op in sum/avg/min/max/count."""
        return self._append(Aggregate(self._auto("aggregate", name),
                                      list(group_by), dict(aggs)))

    def sort(self, by: Sequence, *, ascending: bool = True,
             name: Optional[str] = None) -> "FlowBuilder":
        """Total sort by the given key columns."""
        return self._append(Sort(self._auto("sort", name), list(by),
                                 ascending=ascending))

    # ------------------------------------------------------------------ seal
    def sink(self, *, name: str = "sink") -> Flow:
        """Seal the flow with a collecting sink, validate the DAG and
        statically check every declared read set against the propagated
        schema (exact with DSL expressions)."""
        sink = CollectSink(name)
        self._append(sink)
        self._flow.chain(*self._chain)
        self._flow.validate()
        schemas = infer_schema(self._flow, strict=True)
        return Flow(self.name, self._flow, sink, schema=schemas.get(name))


def flow(name: str = "flow") -> FlowBuilder:
    """Start a declarative flow: ``repro_torch.flow("q4.1").source(...)...``."""
    return FlowBuilder(name)


# ---------------------------------------------------------------------------
#  Session
# ---------------------------------------------------------------------------
@dataclass
class SessionRun:
    """One executed flow: the engine instrumentation + the sink table."""
    run: EngineRun
    table: Dict[str, np.ndarray]

    @property
    def run_id(self) -> str:
        """Opaque identifier joining this run to its metadata-store record,
        benchmark JSON and trace-file process (see ``repro_torch.obs``)."""
        return self.run.run_id

    @property
    def trace_file(self) -> Optional[str]:
        """Exported Perfetto trace (``REPRO_TRACE=1``), else ``None``."""
        return self.run.trace_file

    @property
    def metrics(self) -> Dict[str, object]:
        """The run tracer's metric snapshot (counters / gauges /
        histograms); ``{}`` when tracing was off."""
        return self.run.metrics

    def summary(self) -> str:
        return self.run.summary()


class Session:
    """One entry point over the four engines, backend resolution,
    ``OptimizeOptions``, calibration and metadata recording.

    ``backend`` and ``options`` set session-wide defaults;
    ``run(..., **overrides)`` wins per call.  Every run (and calibration)
    is recorded in the session's ``MetadataStore`` (pass ``metadata=None``
    explicitly to disable recording)."""

    ENGINES = ("ordinary", "kettle", "optimized", "streaming")

    _OWN_STORE = object()          # sentinel: create a private MetadataStore

    def __init__(self, *, backend: Optional[str] = None,
                 metadata=_OWN_STORE,
                 options: Optional[OptimizeOptions] = None):
        self.backend = backend
        self.metadata = (MetadataStore() if metadata is Session._OWN_STORE
                         else metadata)
        self.defaults = options or OptimizeOptions()

    # ------------------------------------------------------------ plumbing
    @staticmethod
    def _flow_pair(f) -> Tuple[Dataflow, Optional[CollectSink]]:
        if isinstance(f, Flow):
            return f.flow, f.sink
        if isinstance(f, Dataflow):
            return f, None
        if isinstance(f, tuple) and len(f) == 2:
            return f
        if hasattr(f, "flow") and hasattr(f, "sink"):   # e.g. QueryFlow
            return f.flow, f.sink
        raise TypeError(
            f"cannot run {f!r}: expected a built Flow, a QueryFlow-like "
            f"object with .flow/.sink, a Dataflow, or a (Dataflow, sink) "
            f"pair")

    # ----------------------------------------------------------------- runs
    def run(self, f, *, engine: str = "streaming",
            optimize: Optional[int] = None, fuse: Optional[bool] = None,
            backend: Optional[str] = None, **opts) -> SessionRun:
        """Execute a flow.  ``engine`` is one of ``ordinary`` / ``kettle``
        (the copy-everywhere baselines) / ``optimized`` / ``streaming``;
        ``optimize`` maps to ``OptimizeOptions.optimize_level`` (>= 2 turns
        on the cost-based adaptive path), ``fuse`` to segment fusion, and
        any other ``OptimizeOptions`` field may be overridden by keyword."""
        df, sink = self._flow_pair(f)
        if sink is not None and hasattr(sink, "clear"):
            sink.clear()          # re-running a flow must not accumulate
        # per-call > Session(backend=) > Session(options=...).backend
        if backend is None:
            backend = (self.backend if self.backend is not None
                       else self.defaults.backend)
        if engine in ("ordinary", "kettle"):
            if (optimize or 0) >= 2 or fuse:
                raise ValueError(
                    f"engine {engine!r} is a copy-everywhere baseline — "
                    f"optimize>=2 / fuse=True need the optimized or "
                    f"streaming engine")
            bad = set(opts) - {"chunk_rows"}
            if bad:
                raise TypeError(f"engine {engine!r} does not take "
                                f"{sorted(bad)}")
            cls = OrdinaryEngine if engine == "ordinary" else KettleEngine
            kw = {"backend": backend}
            if opts.get("chunk_rows"):
                kw["chunk_rows"] = opts["chunk_rows"]
            run = cls(df, **kw).run()
        elif engine in ("optimized", "streaming"):
            o = replace(self.defaults, **opts)
            if backend is not None:    # never clobber options.backend with None
                o = replace(o, backend=backend)
            if optimize is not None:
                o = replace(o, optimize_level=int(optimize))
            if fuse is not None:
                o = replace(o, fuse_segments=bool(fuse))
            cls = StreamingEngine if engine == "streaming" else OptimizedEngine
            run = cls(df, o, metadata=self.metadata).run()
        else:
            raise ValueError(f"unknown engine {engine!r}; "
                             f"expected one of {self.ENGINES}")
        if self.metadata is not None and engine in ("ordinary", "kettle"):
            self.metadata.register_run(df, run)
        table = sink.result() if sink is not None else {}
        return SessionRun(run=run, table=table)

    def serve(self, f, *, optimize: Optional[int] = None,
              fuse: Optional[bool] = None, backend: Optional[str] = None,
              **opts) -> "ServeSession":
        """Open a resident serving session over a flow: the worker pool,
        compiled segment kernels, device-resident dimension tables and arena
        buffers stay warm while micro-batches stream in through
        ``ServeSession.tick``.

        The flow's ``ArraySource`` defines the tick schema (every tick must
        supply exactly those columns); a terminal ``Aggregate`` switches to
        incremental upsert deltas (see ``replay_deltas``).  Options mirror
        ``run(engine="streaming", ...)`` except ``optimize >= 2`` (the
        adaptive rewrite path re-plans per run and is rejected for resident
        serving)."""
        df, sink = self._flow_pair(f)
        if sink is None or not hasattr(sink, "clear"):
            raise ValueError("serve() needs a flow with a collecting sink "
                             "(build with repro_torch.flow(...)....sink())")
        o = replace(self.defaults, **opts)
        if backend is None:
            backend = (self.backend if self.backend is not None
                       else self.defaults.backend)
        if backend is not None:
            o = replace(o, backend=backend)
        if optimize is not None:
            o = replace(o, optimize_level=int(optimize))
        if fuse is not None:
            o = replace(o, fuse_segments=bool(fuse))
        if o.optimize_level >= 2:
            raise ValueError(
                "serve() does not take optimize>=2: the cost-based adaptive "
                "path re-plans per run, which defeats resident serving")
        srcs = [c for c in df.vertices.values() if isinstance(c, ArraySource)]
        if len(srcs) != 1:
            raise ValueError(
                f"serve() needs exactly one ArraySource to feed ticks into; "
                f"flow {df.name!r} has {len(srcs)}")
        sink.clear()
        engine = ServingEngine(df, o, metadata=self.metadata)
        return ServeSession(df, engine, srcs[0], sink)

    def calibrate(self, f, *, sample_rows: int = 4096,
                  backend: Optional[str] = None) -> FlowStatistics:
        """Run the cost-based optimizer's calibration pass (source prefix,
        sinks suppressed) and record the statistics in the metadata store."""
        from .core.backend import resolve_backend
        df, _ = self._flow_pair(f)
        stats = run_calibration(
            df, sample_rows=sample_rows,
            backend=resolve_backend(backend if backend is not None
                                    else self.backend))
        if self.metadata is not None:
            self.metadata.register_statistics(df, stats)
        return stats


# ---------------------------------------------------------------------------
#  Resident serving
# ---------------------------------------------------------------------------
@dataclass
class TickResult:
    """One micro-batch through a resident serving session."""
    #: 0-based tick index
    tick: int
    #: rows ingested this tick
    rows_in: int
    #: emitted delta table — appended rows for row-sync flows, upserted
    #: groups (current merged values) for terminal-Aggregate flows
    delta: Dict[str, np.ndarray]
    #: the session's high-water mark after this tick (None if never given)
    watermark: Optional[float]
    #: wall-clock seconds for the tick
    wall_s: float
    #: per-tick cache-stats snapshot (copies / transfers / arena / compiles)
    cache_stats: Dict[str, int] = field(default_factory=dict)
    #: transient-failure retries this tick took before succeeding (0 on a
    #: clean tick)
    retries: int = 0
    #: True when the micro-batch was dropped into the session's dead-letter
    #: buffer (poison fault, or transient retries exhausted) — the delta is
    #: empty and the session stays alive
    dead_lettered: bool = False
    #: degradation-ladder steps this tick took (``Degradation.spec()``
    #: dicts): a kernel that failed non-transiently stepped one rung and
    #: the tick completed on it; later ticks stay on that rung
    degradation_events: List[Dict[str, object]] = field(default_factory=list)

    @property
    def rows_out(self) -> int:
        if not self.delta:
            return 0
        return len(next(iter(self.delta.values())))


class ServeSession:
    """A resident serving loop: one warm worker pool + compiled kernels +
    device caches, fed by ``tick(columns, watermark=...)``.

    Watermarks are monotone: a tick whose watermark regresses below the
    session high-water mark raises (``REPRO_SERVE_STRICT_WATERMARK=1``,
    the default) or is clamped up to it (``=0``).  ``close()`` drains the
    pool and returns the session summary; the flow itself stays reusable
    (``Session.run`` / a fresh ``serve()`` both work afterwards).

    Usable as a context manager:

        with session.serve(f, fuse=True) as srv:
            for batch, wm in source_feed:
                delta = srv.tick(batch, watermark=wm).delta
    """

    def __init__(self, flow: Dataflow, engine: ServingEngine,
                 source: ArraySource, sink: CollectSink):
        self.flow = flow
        self.engine = engine
        self.source = source
        self.sink = sink
        self.watermark: Optional[float] = None
        self._closed = False
        self._summary: Dict[str, object] = {}
        #: bounded record of recent TickResults (REPRO_SERVE_HISTORY)
        self.history: List[TickResult] = []
        #: bounded dead-letter buffer: micro-batches dropped after a poison
        #: fault or exhausted transient retries, oldest evicted first —
        #: each entry keeps the batch columns so an operator can re-tick it
        self.dead_letters: "deque" = deque(maxlen=_config.DEAD_LETTER_MAX)

    # ------------------------------------------------------------------ api
    @property
    def closed(self) -> bool:
        return self._closed

    @property
    def ticks(self) -> int:
        return self.engine.ticks

    def tick(self, columns: Dict[str, np.ndarray], *,
             watermark: Optional[float] = None) -> TickResult:
        """Ingest one micro-batch and return the emitted delta."""
        if self._closed:
            raise RuntimeError(
                f"serving session for flow {self.flow.name!r} is closed")
        lag: Optional[float] = None
        if watermark is not None:
            watermark = float(watermark)
            if self.watermark is not None and watermark < self.watermark:
                if _config.serve_strict_watermark():
                    raise ValueError(
                        f"watermark regressed: {watermark} < high-water mark "
                        f"{self.watermark} (set "
                        f"{_config.ENV_SERVE_STRICT_WATERMARK}=0 to clamp "
                        f"instead)")
                watermark = self.watermark
            self.watermark = watermark
            lag = max(0.0, time.time() - watermark)
        self.source.set_data(columns)
        rows_in = self.source.columns and len(
            next(iter(self.source.columns.values()))) or 0
        aggs = [c for c in self.flow.vertices.values()
                if hasattr(c, "serving_snapshot")]
        attempt, delay = 0, _config.retry_backoff()
        while True:
            # an aborted attempt (or previous tick) may have left partial
            # per-split rows buffered in the sink — they belong to an
            # execution that FAILED, so they must never leak into this
            # tick's delta
            self.sink.clear()
            # snapshot the cross-tick aggregate partials: a retried tick
            # must merge its rows exactly once
            snaps = [(c, c.serving_snapshot()) for c in aggs]
            try:
                _faults.inject("tick", component=self.flow.name,
                               split=self.engine.ticks)
                info = self.engine.tick(watermark_lag=lag)
                break
            except BaseException as e:
                for c, s in snaps:
                    if s is None and c._serving is not None:
                        # the failed attempt was the session's FIRST tick
                        # (serving mode began mid-attempt): a fresh store IS
                        # the pre-attempt state
                        c.begin_serving()
                    else:
                        c.serving_restore(s)
                kind = _faults.classify(e)
                if kind == "transient" and attempt < _config.retry_max():
                    _faults.record_retry(f"tick.{self.flow.name}", attempt,
                                         delay)
                    if delay > 0.0:
                        time.sleep(delay)
                    delay = min(delay * 2.0, _faults.RETRY_BACKOFF_CAP_S)
                    attempt += 1
                    continue
                if kind == "permanent":
                    # abort promptly with the original exception; the
                    # restores above leave the session consistent, so a
                    # later tick still works
                    raise
                # poison batch (or transient retries exhausted): drop it
                # into the bounded dead-letter buffer and stay alive
                self.sink.clear()
                self.dead_letters.append({
                    "tick": self.engine.ticks, "columns": columns,
                    "watermark": self.watermark, "attempts": attempt + 1,
                    "error": repr(e)})
                if self.engine.tracer is not None:
                    self.engine.tracer.metrics.inc("dead_letters")
                result = TickResult(tick=self.engine.ticks,
                                    rows_in=int(rows_in), delta={},
                                    watermark=self.watermark, wall_s=0.0,
                                    retries=attempt, dead_lettered=True)
                self.history.append(result)
                cap = _config.serve_history()
                if len(self.history) > cap:
                    del self.history[:len(self.history) - cap]
                return result
        delta = self.sink.result()
        self.sink.clear()
        result = TickResult(tick=info["tick"], rows_in=int(rows_in),
                            delta=delta, watermark=self.watermark,
                            wall_s=info["wall_s"],
                            cache_stats=info["cache_stats"],
                            retries=attempt,
                            degradation_events=info["degradation_events"])
        self.history.append(result)
        cap = _config.serve_history()
        if len(self.history) > cap:
            del self.history[:len(self.history) - cap]
        return result

    def close(self) -> Dict[str, object]:
        """Stop serving: drain the pool, export the session trace (if
        tracing), and leave the flow reusable.  Idempotent."""
        if self._closed:
            return dict(self._summary)
        self._summary = self.engine.close()
        self._closed = True
        return dict(self._summary)

    # -------------------------------------------------------- context mgmt
    def __enter__(self) -> "ServeSession":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def replay_deltas(deltas: Iterable[Union[TickResult, Dict[str, np.ndarray]]],
                  group_by: Optional[Sequence[str]] = None
                  ) -> Dict[str, np.ndarray]:
    """Reassemble the per-tick deltas of a serving session into the table
    the equivalent one-shot batch run would produce.

    For row-sync flows (no terminal Aggregate) pass ``group_by=None``: the
    deltas are append-only and simply concatenate in tick order.  For a
    terminal-Aggregate flow pass its group columns: each delta upserts the
    groups it touches (last write wins) and the result is sorted into the
    batch engines' lexicographic-ascending group order."""
    tables = [d.delta if isinstance(d, TickResult) else d for d in deltas]
    tables = [t for t in tables
              if t and len(next(iter(t.values()))) > 0]
    if not tables:
        return {}
    cols = list(tables[0])
    for t in tables[1:]:
        if set(t) != set(cols):
            raise ValueError(
                f"delta column sets differ: {sorted(cols)} vs {sorted(t)}")
    cat = {c: np.concatenate([t[c] for t in tables]) for c in cols}
    if group_by is None:
        return cat
    missing = [c for c in group_by if c not in cat]
    if missing:
        raise KeyError(f"group_by columns {missing} not in the deltas "
                       f"(have {sorted(cols)})")
    keys = [cat[c] for c in group_by]
    last: Dict[tuple, int] = {}
    for i in range(len(cat[cols[0]])):
        last[tuple(k[i].item() for k in keys)] = i
    idx = np.fromiter(last.values(), dtype=np.int64, count=len(last))
    sel = {c: cat[c][idx] for c in cols}
    if group_by:
        order = np.lexsort(tuple(sel[c] for c in group_by)[::-1])
        sel = {c: sel[c][order] for c in cols}
    return sel
