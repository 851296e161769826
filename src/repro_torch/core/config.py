"""Typed runtime configuration — every ``REPRO_*`` environment variable in
one place.

Historically each subsystem parsed its own environment variable at the point
of use (backend registry, engine fusion switch, cache arena, debug
guard).  This module is the single source of truth: one constant per
variable, one typed accessor per setting, and a ``snapshot()`` the metadata
store and benchmark JSON can record so a run's configuration is
reconstructable.

Accessors read the environment on every call (they are cheap), so tests can
``monkeypatch.setenv`` without cache invalidation, and a long-lived process
picks up changes the same way the historical inline ``os.environ`` reads
did.

Every setting also has a first-class API equivalent (see the README table):

    REPRO_BACKEND        OptimizeOptions(backend=...) / Session(backend=...)
    REPRO_FUSION         OptimizeOptions(fuse_segments=...)
    REPRO_ARENA          CacheArena(enabled=...)
    REPRO_ARENA_MAX_MB   CacheArena(max_bytes=...)
    REPRO_CACHE_GUARD    debug only (split-overlap checks + buffer poisoning)
    REPRO_SEGSUM_IMPL    kernels.segment_sum route in TorchBackend global sums
    REPRO_JOIN_IMPL      kernels.hash_join probe route in TorchBackend lookups
    REPRO_GROUPBY_IMPL   kernels.radix_groupby route in TorchBackend groupbys
    REPRO_FLOW_STYLE     etl.queries builders' use_dsl= argument
    REPRO_TRACE          repro_torch.obs.trace.trace_scope() (explicit scoping)
    REPRO_TRACE_PATH     repro_torch.obs.trace.export_run() target path
    REPRO_SERVE_STRICT_WATERMARK  ServeSession.tick(watermark=...) contract
    REPRO_SERVE_HISTORY  ServeSession.history retention
    REPRO_FAULTS         core.faults.fault_scope(FaultPlan.parse(...))
    REPRO_RETRY_MAX      core.faults.retry_call(max_retries=...)
    REPRO_RETRY_BACKOFF  core.faults.retry_call(backoff=...)
    REPRO_DEGRADE        debug only (disables the degradation ladders)
    REPRO_SHARDS         OptimizeOptions(shards=...) / Session.run(shards=...)
    REPRO_SHARD_IMPL     OptimizeOptions(shard_impl=...)

Kernel impl selectors (join / groupby / segsum) take ``auto`` (the CUDA
kernel for a CUDA tensor, the plain torch version for a CPU tensor),
``cuda`` (the kernel; a CPU tensor raises) or ``reference`` (the plain torch
version on any device), plus the legacy ``searchsorted`` / ``sort`` routes.
"""
from __future__ import annotations

import os
from typing import Dict, Optional

#: operator backend for the heavy component kernels ("numpy" / "torch" /
#: "torch_cpu")
ENV_BACKEND = "REPRO_BACKEND"
#: "1" turns segment fusion on when OptimizeOptions.fuse_segments is unset
ENV_FUSION = "REPRO_FUSION"
#: "0" disables the CacheArena buffer pool
ENV_ARENA = "REPRO_ARENA"
#: cap on pooled arena bytes, in MB
ENV_ARENA_MAX_MB = "REPRO_ARENA_MAX_MB"
#: "1" enables split-overlap checks + 0xAB buffer poisoning (debug mode)
ENV_CACHE_GUARD = "REPRO_CACHE_GUARD"
#: segment-sum kernel implementation selector ("auto" / "cuda" /
#: "reference")
ENV_SEGSUM_IMPL = "REPRO_SEGSUM_IMPL"
#: Lookup probe route on the torch backend: hash-join kernel impls ("auto" /
#: "cuda" / "reference") or "searchsorted" (legacy binary-search probe over
#: the sorted DimTable)
ENV_JOIN_IMPL = "REPRO_JOIN_IMPL"
#: groupby route on the torch backend: radix-groupby kernel impls ("auto" /
#: "cuda" / "reference") or "sort" (legacy lexsort + segment-sum route; also
#: the automatic fallback for sparse/non-integer key spaces)
ENV_GROUPBY_IMPL = "REPRO_GROUPBY_IMPL"
#: how the SSB query builders construct predicates/expressions:
#: "dsl" (column-expression AST, exact provenance) or "lambda" (the legacy
#: callable path, kept for A/B benchmarking)
ENV_FLOW_STYLE = "REPRO_FLOW_STYLE"
#: "1" enables per-run structured tracing (repro_torch.obs): engines open a
#: tracer scope, record spans/metrics, and export a Perfetto-loadable
#: Chrome-trace JSON file
ENV_TRACE = "REPRO_TRACE"
#: path of the exported trace file (default "repro_trace.json"); one file
#: accumulates every traced run of the process as its own Perfetto process
ENV_TRACE_PATH = "REPRO_TRACE_PATH"
#: cap on buffered trace events — per tracer AND across the runs the trace
#: file retains; oldest events/runs rotate out so a resident serving session
#: stays bounded (0 disables the cap)
ENV_TRACE_MAX_EVENTS = "REPRO_TRACE_MAX_EVENTS"
#: "0" relaxes the serving watermark contract from strict (a regressing
#: watermark raises) to clamping (a regressing watermark is lifted to the
#: session high-water mark)
ENV_SERVE_STRICT_WATERMARK = "REPRO_SERVE_STRICT_WATERMARK"
#: number of recent per-tick wall times a ServeSession retains for its
#: closing p50/p99 summary
ENV_SERVE_HISTORY = "REPRO_SERVE_HISTORY"
#: deterministic fault-injection plan for the whole process, in the
#: ``core.faults`` rule grammar (e.g. "seed=7;chunk:count=2;kernel:count=1");
#: unset => no injection
ENV_FAULTS = "REPRO_FAULTS"
#: max retries for a transient failure (chunk replay, run re-execution,
#: serve-tick retry) before it escalates; 0 disables retrying
ENV_RETRY_MAX = "REPRO_RETRY_MAX"
#: initial retry backoff in seconds (doubles per attempt, capped at
#: ``core.faults.RETRY_BACKOFF_CAP_S``)
ENV_RETRY_BACKOFF = "REPRO_RETRY_BACKOFF"
#: "0" disables the graceful-degradation ladders (failing kernels/segments
#: then abort instead of falling back to slower routes)
ENV_DEGRADE = "REPRO_DEGRADE"
#: shard count for the OptimizedEngine/StreamingEngine sharded-execution
#: route when ``OptimizeOptions.shards`` is unset: 1 (default) runs the
#: serial path, N>1 hash/range-partitions sources across N shards, 0 lets
#: the ShardPlanner choose from the row count and split count
ENV_SHARDS = "REPRO_SHARDS"
#: sharded-execution route: "auto" (mesh on the torch backends, else
#: inline), "process" (spawned worker processes running pickled per-shard
#: flows), "mesh" (inline passes whose Aggregate partials merge on the
#: backend's device, ``core/shard/mesh.py``), or "inline" (sequential
#: in-process shard passes — the always-available correctness route)
ENV_SHARD_IMPL = "REPRO_SHARD_IMPL"

DEFAULT_TRACE_PATH = "repro_trace.json"
DEFAULT_TRACE_MAX_EVENTS = 200_000
DEFAULT_SERVE_HISTORY = 4096
DEFAULT_RETRY_MAX = 3
DEFAULT_RETRY_BACKOFF_S = 0.05
#: bound on a ServeSession's dead-letter buffer (oldest entries drop)
DEAD_LETTER_MAX = 256

DEFAULT_ARENA_MAX_MB = 256
FLOW_STYLES = ("dsl", "lambda")
JOIN_IMPLS = ("auto", "cuda", "reference", "searchsorted")
GROUPBY_IMPLS = ("auto", "cuda", "reference", "sort")
SEGSUM_IMPLS = ("auto", "cuda", "reference")
SHARD_IMPLS = ("auto", "process", "mesh", "inline")


def _raw(name: str) -> Optional[str]:
    v = os.environ.get(name)
    if v is None:
        return None
    v = v.strip()
    return v or None


# ---------------------------------------------------------------------------
#  Typed accessors
# ---------------------------------------------------------------------------
def backend_name() -> Optional[str]:
    """Process-default operator backend name, or ``None`` when unset (the
    registry then falls back to its builtin default)."""
    return _raw(ENV_BACKEND)


def fusion_default() -> bool:
    """Segment-fusion default when ``OptimizeOptions.fuse_segments`` is left
    unset (``REPRO_FUSION=1`` => on)."""
    return _raw(ENV_FUSION) == "1"


def arena_enabled() -> bool:
    """CacheArena pooling switch (``REPRO_ARENA=0`` => off)."""
    return _raw(ENV_ARENA) != "0"


def arena_max_bytes() -> int:
    """Cap on pooled arena bytes (``REPRO_ARENA_MAX_MB``, default 256 MB)."""
    v = _raw(ENV_ARENA_MAX_MB)
    mb = int(v) if v is not None else DEFAULT_ARENA_MAX_MB
    return mb << 20


def cache_guard_enabled() -> bool:
    """Debug mode: split-overlap checks + poisoned arena releases
    (``REPRO_CACHE_GUARD=1``)."""
    return _raw(ENV_CACHE_GUARD) == "1"


def segsum_impl() -> str:
    """Implementation selector for the segment-sum kernel."""
    v = _raw(ENV_SEGSUM_IMPL) or "auto"
    if v not in SEGSUM_IMPLS:
        raise ValueError(
            f"{ENV_SEGSUM_IMPL}={v!r} is not a valid segsum impl; "
            f"expected one of {SEGSUM_IMPLS}")
    return v


def join_impl() -> str:
    """Lookup probe route on the torch backend: a hash-join kernel impl or
    "searchsorted" for the legacy binary-search probe."""
    v = _raw(ENV_JOIN_IMPL) or "auto"
    if v not in JOIN_IMPLS:
        raise ValueError(
            f"{ENV_JOIN_IMPL}={v!r} is not a valid join impl; "
            f"expected one of {JOIN_IMPLS}")
    return v


def groupby_impl() -> str:
    """Groupby route on the torch backend: a radix-groupby kernel impl or
    "sort" for the legacy lexsort + segment-sum route."""
    v = _raw(ENV_GROUPBY_IMPL) or "auto"
    if v not in GROUPBY_IMPLS:
        raise ValueError(
            f"{ENV_GROUPBY_IMPL}={v!r} is not a valid groupby impl; "
            f"expected one of {GROUPBY_IMPLS}")
    return v


def flow_style() -> str:
    """How the SSB query builders construct predicates/expressions when the
    caller does not pass ``use_dsl=`` explicitly: "dsl" (default) or
    "lambda"."""
    v = _raw(ENV_FLOW_STYLE) or "dsl"
    if v not in FLOW_STYLES:
        raise ValueError(
            f"{ENV_FLOW_STYLE}={v!r} is not a valid flow style; "
            f"expected one of {FLOW_STYLES}")
    return v


def trace_enabled() -> bool:
    """Per-run structured tracing + trace-file export (``REPRO_TRACE=1``).
    An explicitly opened ``repro_torch.obs.trace.trace_scope`` records regardless;
    this switch additionally makes every engine run open its own scope and
    write ``trace_path()``."""
    return _raw(ENV_TRACE) == "1"


def trace_path() -> str:
    """Export path for the Chrome-trace/Perfetto JSON file
    (``REPRO_TRACE_PATH``, default ``repro_trace.json``)."""
    return _raw(ENV_TRACE_PATH) or DEFAULT_TRACE_PATH


def trace_max_events() -> int:
    """Trace-event retention cap (``REPRO_TRACE_MAX_EVENTS``, default
    200000; 0 disables rotation).  Applies per tracer and to the total the
    process trace file keeps across runs."""
    v = _raw(ENV_TRACE_MAX_EVENTS)
    n = int(v) if v is not None else DEFAULT_TRACE_MAX_EVENTS
    return max(0, n)


def serve_strict_watermark() -> bool:
    """Serving watermark contract: strict (default — a tick whose watermark
    regresses below the session high-water mark raises) or clamping
    (``REPRO_SERVE_STRICT_WATERMARK=0`` — regressions are lifted to the
    high-water mark)."""
    return _raw(ENV_SERVE_STRICT_WATERMARK) != "0"


def serve_history() -> int:
    """Per-tick wall-time samples a ServeSession retains for its closing
    p50/p99 summary (``REPRO_SERVE_HISTORY``, default 4096)."""
    v = _raw(ENV_SERVE_HISTORY)
    n = int(v) if v is not None else DEFAULT_SERVE_HISTORY
    return max(1, n)


def faults_spec() -> Optional[str]:
    """The process-wide fault-injection plan spec (``REPRO_FAULTS``), or
    ``None`` when no injection is configured."""
    return _raw(ENV_FAULTS)


def retry_max() -> int:
    """Max transient-failure retries per recovery site
    (``REPRO_RETRY_MAX``, default 3; 0 disables retrying)."""
    v = _raw(ENV_RETRY_MAX)
    n = int(v) if v is not None else DEFAULT_RETRY_MAX
    return max(0, n)


def retry_backoff() -> float:
    """Initial retry backoff seconds (``REPRO_RETRY_BACKOFF``, default
    0.05; doubles per attempt up to the cap)."""
    v = _raw(ENV_RETRY_BACKOFF)
    s = float(v) if v is not None else DEFAULT_RETRY_BACKOFF_S
    return max(0.0, s)


def degrade_enabled() -> bool:
    """Graceful-degradation ladders switch (``REPRO_DEGRADE=0`` => off:
    failing kernel routes abort instead of falling back)."""
    return _raw(ENV_DEGRADE) != "0"


def shards() -> int:
    """Shard count when ``OptimizeOptions.shards`` is unset
    (``REPRO_SHARDS``, default 1 = serial; 0 = planner-chosen)."""
    v = _raw(ENV_SHARDS)
    n = int(v) if v is not None else 1
    if n < 0:
        raise ValueError(f"{ENV_SHARDS}={v!r} must be >= 0")
    return n


def shard_impl() -> str:
    """Sharded-execution route when ``OptimizeOptions.shard_impl`` is unset
    (``REPRO_SHARD_IMPL``, default "auto")."""
    v = _raw(ENV_SHARD_IMPL) or "auto"
    if v not in SHARD_IMPLS:
        raise ValueError(
            f"{ENV_SHARD_IMPL}={v!r} is not a valid shard impl; "
            f"expected one of {SHARD_IMPLS}")
    return v


def snapshot() -> Dict[str, object]:
    """Every setting's effective value — recorded in benchmark JSON so a
    run's configuration is reconstructable."""
    return {
        "backend": backend_name(),
        "fusion": fusion_default(),
        "arena": arena_enabled(),
        "arena_max_bytes": arena_max_bytes(),
        "cache_guard": cache_guard_enabled(),
        "segsum_impl": segsum_impl(),
        "join_impl": join_impl(),
        "groupby_impl": groupby_impl(),
        "flow_style": flow_style(),
        "trace": trace_enabled(),
        "trace_path": trace_path(),
        "trace_max_events": trace_max_events(),
        "serve_strict_watermark": serve_strict_watermark(),
        "serve_history": serve_history(),
        "faults": faults_spec(),
        "retry_max": retry_max(),
        "retry_backoff": retry_backoff(),
        "degrade": degrade_enabled(),
        "shards": shards(),
        "shard_impl": shard_impl(),
    }
