"""Contextvar-scoped structured tracing — spans, instants and counter events
emitted as Chrome-trace / Perfetto JSON.

Mirrors ``core.shared_cache.cache_stats_scope``: a ``Tracer`` pushed with
``trace_scope`` (or opened per run by the engines via ``run_scope`` when
``REPRO_TRACE=1``) is carried through ``contextvars``, so the shared worker
pool — which runs every task under the submitter's copied context — scopes
events to the right run even across threads.  Scopes nest; every emit goes
to ALL active tracers.

Zero-cost guarantee when disabled: every hot call site first checks
``ACTIVE.get()`` (one contextvar read); with no tracer in scope and
``REPRO_TRACE`` unset, no object is allocated and no lock is taken.

Event model (Chrome trace "traceEvents" array, ts/dur in µs):

  ph="X" complete spans    — engine phases (cat ``phase``), per-component
                             per-chunk dispatches (cat ``compute``), fused
                             kernel launches (cat ``kernel``), h2d/d2h
                             transfers (cat ``transfer``), blocking waits
                             (cat ``wait``: channel put/get/drain, admission,
                             activity busy-wait)
  ph="i" instant events    — cache copies (cat ``copy``), arena
                             acquire/release (cat ``arena``)
  ph="C" counter events    — channel occupancy (cat ``channel``)

Each run exported by an engine becomes its own Perfetto *process* (pid =
run ordinal, process_name = flow/engine/backend/run-id) with real thread
ids and names, so one ``REPRO_TRACE_PATH`` file from a whole benchmark
session opens in ``ui.perfetto.dev`` as a stack of runs.

The transfer/copy/arena hooks are called from ``core.shared_cache``'s
scoped-statistics funnels — the SAME call sites that feed ``CacheStats`` —
so metric counters reconcile exactly with the run's cache statistics (see
``obs.metrics``).
"""
from __future__ import annotations

import contextvars
import json
import os
import subprocess
import threading
import time
import uuid
from contextlib import contextmanager, nullcontext
from datetime import datetime, timezone
from typing import Dict, List, Optional

from ..core import config
from .metrics import MetricsRegistry

#: active tracer scopes (innermost last) — module-level so hot paths can do
#: the cheapest possible disabled check: ``if ACTIVE.get(): ...``
ACTIVE: "contextvars.ContextVar[tuple]" = contextvars.ContextVar(
    "repro_trace_scopes", default=())


def active() -> bool:
    """True when at least one tracer scope is open on this context."""
    return bool(ACTIVE.get())


# ---------------------------------------------------------------------------
#  Run identity (satellite: joinable bench / metadata / trace artifacts)
# ---------------------------------------------------------------------------
def new_run_id() -> str:
    """Fresh opaque run identifier (uuid4 hex)."""
    return uuid.uuid4().hex


def iso_now() -> str:
    """Current UTC time as an ISO-8601 string."""
    return datetime.now(timezone.utc).isoformat(timespec="seconds")


_GIT_SHA: List[Optional[str]] = []        # one-element cache (None = no repo)


def git_sha() -> Optional[str]:
    """HEAD commit of the working directory's git repo, cached per process;
    ``None`` when git is unavailable or the cwd is not a repository."""
    if not _GIT_SHA:
        sha: Optional[str] = None
        try:
            out = subprocess.run(
                ["git", "rev-parse", "HEAD"], cwd=os.getcwd(),
                capture_output=True, text=True, timeout=5.0)
            if out.returncode == 0:
                sha = out.stdout.strip() or None
        except (OSError, subprocess.SubprocessError):
            sha = None
        _GIT_SHA.append(sha)
    return _GIT_SHA[0]


# ---------------------------------------------------------------------------
#  Tracer
# ---------------------------------------------------------------------------
class Tracer:
    """Thread-safe event collector for one scope (usually one engine run).

    ``measuring`` gates the METRIC counters only (events always record while
    the tracer is in scope): the engines flip it on exactly where they open
    their per-run ``cache_stats_scope``, so ``metrics`` counters cover the
    identical window as the run's ``CacheStats`` — exact reconciliation.

    Event retention is capped (``max_events``, default
    ``REPRO_TRACE_MAX_EVENTS``): once the buffer exceeds the cap the OLDEST
    half rotates out (``dropped_events`` counts the loss).  A finite batch
    run never comes near the cap; a resident serving session emitting spans
    for thousands of ticks stays bounded instead of growing for the life of
    the process.  Metric counters are monotonic scalars and never rotate.
    """

    def __init__(self, name: str = "trace", measuring: bool = True,
                 max_events: Optional[int] = None):
        self.name = name
        self.measuring = measuring
        self.metrics = MetricsRegistry()
        self.events: List[dict] = []
        self.meta: Dict[str, object] = {}
        self._lock = threading.Lock()
        self.thread_names: Dict[int, str] = {}
        self.max_events = (config.trace_max_events()
                           if max_events is None else max(0, int(max_events)))
        self.dropped_events = 0
        #: per-shard sub-tracers of a sharded run (core/shard): each exports
        #: as its own shard-tagged Perfetto process next to the parent run
        self.shard_tracers: List["Tracer"] = []

    def emit(self, ph: str, cat: str, name: str, ts_us: float,
             dur_us: Optional[float] = None,
             args: Optional[dict] = None) -> None:
        tid = threading.get_ident()
        ev = {"ph": ph, "cat": cat, "name": name,
              "ts": ts_us, "pid": 0, "tid": tid}
        if dur_us is not None:
            ev["dur"] = dur_us
        if args:
            ev["args"] = args
        with self._lock:
            if tid not in self.thread_names:
                self.thread_names[tid] = threading.current_thread().name
            self.events.append(ev)
            if self.max_events and len(self.events) > self.max_events:
                # rotate the oldest half out in one bulk delete (amortized
                # O(1) per emit) rather than trimming one event per call
                drop = len(self.events) - self.max_events // 2
                del self.events[:drop]
                self.dropped_events += drop

    # ------------------------------------------------------------- exports
    def to_chrome(self, pid: int = 0) -> List[dict]:
        """This tracer's events as Chrome-trace dicts under process ``pid``
        (plus process/thread metadata events)."""
        with self._lock:
            events = [dict(ev) for ev in self.events]
            names = dict(self.thread_names)
        out: List[dict] = []
        label = self.meta.get("flow") or self.name
        detail = "/".join(str(self.meta[k]) for k in
                          ("engine", "backend") if self.meta.get(k))
        rid = str(self.meta.get("run_id", ""))[:8]
        pname = f"{label}" + (f" [{detail}]" if detail else "") \
            + (f" #{rid}" if rid else "")
        out.append({"ph": "M", "name": "process_name", "pid": pid, "tid": 0,
                    "args": {"name": pname}})
        out.append({"ph": "M", "name": "process_sort_index", "pid": pid,
                    "tid": 0, "args": {"sort_index": pid}})
        for tid, tname in names.items():
            out.append({"ph": "M", "name": "thread_name", "pid": pid,
                        "tid": tid, "args": {"name": tname}})
        for ev in events:
            ev["pid"] = pid
            out.append(ev)
        return out


# ---------------------------------------------------------------------------
#  Scoping
# ---------------------------------------------------------------------------
@contextmanager
def trace_scope(tracer: Optional[Tracer] = None):
    """Push a tracer onto this context (mirrors ``cache_stats_scope``).
    Every event emitted while the scope is active — including on worker-pool
    tasks submitted under it — lands in the yielded tracer; scopes nest."""
    tr = tracer if tracer is not None else Tracer()
    token = ACTIVE.set(ACTIVE.get() + (tr,))
    try:
        yield tr
    finally:
        ACTIVE.reset(token)


@contextmanager
def run_scope(**meta):
    """Engine entry point: opens a per-run tracer when tracing is enabled
    (``REPRO_TRACE=1``) or an outer ``trace_scope`` is already active —
    otherwise yields ``None`` without allocating anything (the hard
    zero-cost disabled path)."""
    if not (ACTIVE.get() or config.trace_enabled()):
        yield None
        return
    tr = Tracer(name=str(meta.get("flow", "run")), measuring=False)
    tr.meta = dict(meta)
    token = ACTIVE.set(ACTIVE.get() + (tr,))
    try:
        yield tr
    finally:
        ACTIVE.reset(token)


def measured(tracer: Optional[Tracer]):
    """Context manager opening the tracer's metric-counter window; the
    engines use it alongside ``cache_stats_scope`` so both cover the same
    events.  None-safe (no-op when tracing is off)."""
    if tracer is None:
        return nullcontext()

    @contextmanager
    def _measured():
        tracer.measuring = True
        try:
            yield tracer
        finally:
            tracer.measuring = False
    return _measured()


# ---------------------------------------------------------------------------
#  Span / event emitters (hot paths check ACTIVE first)
# ---------------------------------------------------------------------------
class _NullSpan:
    """Reusable no-op context manager returned by ``span`` when disabled."""
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL_SPAN = _NullSpan()


class _Span:
    __slots__ = ("cat", "name", "args", "t0")

    def __init__(self, cat: str, name: str, args: dict):
        self.cat = cat
        self.name = name
        self.args = args

    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        complete(self.cat, self.name, self.t0,
                 time.perf_counter() - self.t0, **self.args)
        return False


def span(cat: str, name: str, **args):
    """Context manager recording a complete span on every active tracer;
    a shared no-op singleton when tracing is off."""
    if not ACTIVE.get():
        return _NULL_SPAN
    return _Span(cat, name, args)


def complete(cat: str, name: str, t0: float, dt: float, **args) -> None:
    """Record a finished span [t0, t0+dt] (``perf_counter`` seconds)."""
    for tr in ACTIVE.get():
        tr.emit("X", cat, name, t0 * 1e6, dt * 1e6, args or None)


def instant(cat: str, name: str, **args) -> None:
    ts = time.perf_counter() * 1e6
    for tr in ACTIVE.get():
        tr.emit("i", cat, name, ts, args=args or None)


def counter(cat: str, name: str, **series) -> None:
    """Perfetto counter track sample (e.g. channel occupancy over time)."""
    ts = time.perf_counter() * 1e6
    for tr in ACTIVE.get():
        tr.emit("C", cat, name, ts, args=series)


# ---------------------------------------------------------------------------
#  Instrumentation hooks — called from core layers; every hook both records
#  an event and (inside the measuring window) the reconciling metric counter
# ---------------------------------------------------------------------------
def on_dispatch(component: str, t0: float, t1: float, split: int,
                rows_in: int, rows_out: int, mt: int = 0) -> None:
    """One per-chunk component dispatch (``Component.process`` or the §4.3
    multithreaded path).  Span count == ``EngineRun.dispatch_calls``."""
    scopes = ACTIVE.get()
    if not scopes:
        return
    args = {"component": component, "split": split,
            "rows_in": rows_in, "rows_out": rows_out}
    if mt:
        args["mt_threads"] = mt
    for tr in scopes:
        tr.emit("X", "compute", component, t0 * 1e6, (t1 - t0) * 1e6, args)
        if tr.measuring:
            tr.metrics.inc("dispatch_calls")


def on_accumulate(component: str, t0: float, t1: float, rows: int) -> None:
    """Per-chunk ``accumulate`` of a block/semi-block component (not a
    dispatch — it does not count toward ``dispatch_calls``)."""
    scopes = ACTIVE.get()
    if not scopes:
        return
    for tr in scopes:
        tr.emit("X", "compute", component, t0 * 1e6, (t1 - t0) * 1e6,
                {"component": component, "phase": "accumulate", "rows": rows})


def on_kernel(name: str, backend: str, t0: float, t1: float,
              rows: int) -> None:
    """One fused-segment kernel dispatch; feeds the per-kernel latency
    histogram."""
    scopes = ACTIVE.get()
    if not scopes:
        return
    dt = t1 - t0
    for tr in scopes:
        tr.emit("X", "kernel", name, t0 * 1e6, dt * 1e6,
                {"backend": backend, "rows": rows})
        if tr.measuring:
            tr.metrics.inc("kernel_dispatches")
            tr.metrics.observe("kernel_dispatch_s", dt)


def on_transfer(direction: str, nbytes: int, seconds: float = 0.0) -> None:
    """One h2d/d2h crossing (from ``shared_cache.record_transfer``).
    ``seconds`` is the measured copy duration where the call site timed it
    (0 => drawn as a zero-width slice)."""
    scopes = ACTIVE.get()
    if not scopes:
        return
    t1 = time.perf_counter()
    for tr in scopes:
        tr.emit("X", "transfer", direction, (t1 - seconds) * 1e6,
                seconds * 1e6, {"bytes": int(nbytes)})
        if tr.measuring:
            m = tr.metrics
            m.inc(f"{direction}_transfers")
            m.inc(f"{direction}_bytes", int(nbytes))
            if seconds:
                m.inc(f"{direction}_seconds", seconds)


def on_copy(nbytes: int) -> None:
    """One physical cache copy (from ``shared_cache.record_copy``)."""
    scopes = ACTIVE.get()
    if not scopes:
        return
    ts = time.perf_counter() * 1e6
    for tr in scopes:
        tr.emit("i", "copy", "cache.copy", ts, args={"bytes": int(nbytes)})
        if tr.measuring:
            tr.metrics.inc("copies")
            tr.metrics.inc("bytes_copied", int(nbytes))


def on_arena(hit: bool, nbytes: int) -> None:
    """One ``CacheArena.acquire`` (from ``shared_cache._record_arena``)."""
    scopes = ACTIVE.get()
    if not scopes:
        return
    ts = time.perf_counter() * 1e6
    name = "acquire-hit" if hit else "acquire-miss"
    for tr in scopes:
        tr.emit("i", "arena", name, ts, args={"bytes": int(nbytes)})
        if tr.measuring:
            m = tr.metrics
            if hit:
                m.inc("arena_hits")
                m.inc("arena_bytes_reused", int(nbytes))
            else:
                m.inc("arena_misses")


def on_arena_release(nbytes: int) -> None:
    """One buffer returned to the arena pool (event + non-reconciling
    counter — ``CacheStats`` does not track releases)."""
    scopes = ACTIVE.get()
    if not scopes:
        return
    ts = time.perf_counter() * 1e6
    for tr in scopes:
        tr.emit("i", "arena", "release", ts, args={"bytes": int(nbytes)})
        if tr.measuring:
            tr.metrics.inc("arena_releases")


def on_fault(site: str, kind: str, component=None) -> None:
    """One injected fault fired (from ``core.faults.record_fault``)."""
    scopes = ACTIVE.get()
    if not scopes:
        return
    ts = time.perf_counter() * 1e6
    for tr in scopes:
        tr.emit("i", "fault", f"inject:{site}", ts,
                args={"kind": kind, "component": component})
        if tr.measuring:
            tr.metrics.inc("faults_injected")


def on_retry(where: str, attempt: int, delay_s: float) -> None:
    """One transient-failure retry about to back off (from
    ``core.faults.record_retry``); feeds the retry-latency histogram."""
    scopes = ACTIVE.get()
    if not scopes:
        return
    ts = time.perf_counter() * 1e6
    for tr in scopes:
        tr.emit("i", "fault", "retry", ts,
                args={"where": where, "attempt": attempt,
                      "delay_s": delay_s})
        if tr.measuring:
            tr.metrics.inc("retries")
            tr.metrics.observe("retry_backoff_s", delay_s)


def on_degrade(kind: str, src: str, dst: str, component=None) -> None:
    """One degradation-ladder fallback (from
    ``core.faults.record_degradation``)."""
    scopes = ACTIVE.get()
    if not scopes:
        return
    ts = time.perf_counter() * 1e6
    for tr in scopes:
        tr.emit("i", "fault", f"degrade:{kind}", ts,
                args={"src": src, "dst": dst, "component": component})
        if tr.measuring:
            tr.metrics.inc("degradations")


def on_wait(kind: str, t0: float, t1: float, **args) -> None:
    """One blocking wait (channel put/get/drain, admission gate, activity
    busy-wait).  ``kind`` names the wait site, e.g. ``channel.put``."""
    scopes = ACTIVE.get()
    if not scopes:
        return
    dt = t1 - t0
    for tr in scopes:
        tr.emit("X", "wait", kind, t0 * 1e6, dt * 1e6, args or None)
        if tr.measuring:
            tr.metrics.inc(f"wait_s.{kind}", dt)


# ---------------------------------------------------------------------------
#  Trace file export (REPRO_TRACE=1 => REPRO_TRACE_PATH, Perfetto-loadable)
# ---------------------------------------------------------------------------
class _TraceFile:
    """Process-wide accumulator: each exported run becomes its own Perfetto
    process in one JSON file, so a whole benchmark session lands in a single
    artifact.

    Size-capped rotation: the file retains at most ``REPRO_TRACE_MAX_EVENTS``
    events ACROSS runs — once a new export pushes the total past the cap,
    the oldest retained runs rotate out (the newest run always stays, even
    oversized).  Historically ``_runs`` grew for the life of the process,
    which a per-run CLI never noticed but a resident serving session turns
    into an unbounded leak."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._runs: List[Tracer] = []
        self.rotated_runs = 0

    def add_and_flush(self, tracer: Tracer, path: str) -> str:
        cap = config.trace_max_events()
        with self._lock:
            self._runs.append(tracer)
            if cap:
                while (len(self._runs) > 1
                       and sum(len(tr.events) for tr in self._runs) > cap):
                    self._runs.pop(0)
                    self.rotated_runs += 1
            # flatten per-shard sub-tracers next to their run so each shard
            # renders as its own Perfetto process
            flat: List[Tracer] = []
            for tr in self._runs:
                flat.append(tr)
                for sub in tr.shard_tracers:
                    # run-level meta (run_id, git_sha, ...) is attached to
                    # the parent at export time — after the sub-tracers
                    # copied it — so inherit whatever they are missing
                    for mk, mv in tr.meta.items():
                        sub.meta.setdefault(mk, mv)
                    flat.append(sub)
            events: List[dict] = []
            for pid, tr in enumerate(flat, start=1):
                events.extend(tr.to_chrome(pid=pid))
            runs_meta = [dict(tr.meta, dropped_events=tr.dropped_events)
                         for tr in flat]
            rotated = self.rotated_runs
        payload = {
            "traceEvents": events,
            "displayTimeUnit": "ms",
            "otherData": {"producer": "repro.obs", "runs": runs_meta,
                          "rotated_runs": rotated},
        }
        with open(path, "w") as f:
            json.dump(payload, f)
        return path


_TRACE_FILE = _TraceFile()


def export_run(tracer: Optional[Tracer], meta: Optional[dict] = None
               ) -> Optional[str]:
    """Append one finished run to the process trace file and rewrite it.
    No-op (returns None) unless ``REPRO_TRACE=1`` — an explicitly scoped
    tracer (tests, libraries) reads ``tracer.events`` directly instead."""
    if tracer is None or not config.trace_enabled():
        return None
    if meta:
        tracer.meta.update(meta)
    return _TRACE_FILE.add_and_flush(tracer, config.trace_path())
