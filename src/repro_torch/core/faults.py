"""Deterministic fault injection + the runtime's retry/degradation vocabulary.

The fault-tolerance layer has three moving parts, all defined here:

1. **Taxonomy** — ``FaultError`` subclasses split failures into the three
   classes the runtime reacts to differently, and ``classify`` maps ANY
   exception (injected or real) onto the same axis:

   =============  ==========================================================
   ``transient``  worth retrying: injected ``TransientFault``, connection /
                  timeout / OS-level errors.  Chunk dispatches replay them
                  in place (``ActivityRunner``), engines re-run the
                  streaming phase, serve ticks re-tick.
   ``permanent``  not worth retrying: logic errors, bad schemas, explicit
                  ``PermanentFault``.  The run aborts promptly with the
                  original exception.
   ``poison``     the *data* is bad, not the attempt: retrying cannot help
                  and must not block the stream.  Serve sessions dead-letter
                  the micro-batch and keep ticking.
   =============  ==========================================================

2. **FaultPlan** — a seeded, declarative list of injection rules installed
   either via the ``fault_scope`` contextvar (mirrors ``cache_stats_scope``;
   scopes follow tasks across the worker pool because ``SharedWorkerPool``
   propagates contextvars) or process-wide via ``REPRO_FAULTS``.  Rules are
   matched at named injection **sites** wired through the runtime:

   =========  ==============================================================
   ``chunk``  a component dispatch (``Component.process`` /
              ``accumulate``) or a source split draw
   ``kernel`` a backend kernel launch: fused-segment runners, the torch
              join-probe and groupby routes
   ``edge``   ``ChannelGroup.put`` — cross-tree handoff (``delay=`` rules
              sleep here instead of raising)
   ``arena``  ``CacheArena.acquire`` — a fired rule simulates over-budget:
              the arena degrades to direct allocation instead of raising
   ``tick``   one ``ServeSession.tick`` micro-batch
   ``shard``  one whole shard pass of a sharded run — the coordinator
              replays the lost shard from its source snapshot
   =========  ==============================================================

   Spec grammar (``REPRO_FAULTS`` or ``FaultPlan.parse``)::

       seed=7; chunk@filter_hot:kind=transient,count=2; kernel:count=1;
       tick:p=0.25,count=10,kind=poison; edge:delay=0.005,count=3

   Rules are ``site[@component][:opt=val,...]`` separated by ``;``.  Options:
   ``kind`` (transient|permanent|poison, default transient), ``count`` (max
   fires, default 1), ``split`` (only that split index), ``after`` (skip the
   first N matching calls), ``p`` (per-call fire probability, drawn from the
   plan's seeded RNG), ``delay`` (sleep seconds instead of raising).  Counts
   are **plan-lifetime**, so a rule with ``count=1`` that already fired lets
   the retried attempt pass clean — which is exactly what makes transient
   plans survivable.

3. **Recording** — every injection, retry and degradation funnels through
   ``record_fault`` / ``record_retry`` / ``record_degradation`` into the
   scoped ``CacheStats`` counters (=> EngineRun / BENCH JSON), the obs trace
   hooks (instants + metric counters + the retry-backoff histogram), and any
   open ``fault_recorder`` scope (=> ``EngineRun.degradation_events``).

``retry_call`` is the core capped-exponential-backoff helper (the
generalization of ``train/fault.py:with_retries``): transient failures sleep
``REPRO_RETRY_BACKOFF * 2**attempt`` capped at ``RETRY_BACKOFF_CAP_S`` for up
to ``REPRO_RETRY_MAX`` retries; anything non-transient re-raises immediately.
"""
from __future__ import annotations

import random
import threading
import time
from contextlib import contextmanager
from contextvars import ContextVar
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from . import config
from . import shared_cache as _sc
from ..obs import trace as obs_trace

__all__ = [
    "FaultError", "TransientFault", "PermanentFault", "PoisonFault",
    "classify", "FaultRule", "FaultPlan", "fault_scope", "active", "inject",
    "retry_call", "with_retries", "backoff_schedule", "RETRY_BACKOFF_CAP_S",
    "Degradation", "fault_recorder", "record_fault", "record_retry",
    "record_degradation", "snapshot_cache", "restore_cache",
]

#: ceiling on a single retry backoff sleep — doubling stops here
RETRY_BACKOFF_CAP_S = 2.0

#: valid injection sites (see module docstring table)
SITES = ("chunk", "kernel", "edge", "arena", "tick", "shard")

KINDS = ("transient", "permanent", "poison")


# ---------------------------------------------------------------------------
#  Taxonomy
# ---------------------------------------------------------------------------
class FaultError(RuntimeError):
    """Base class for injected faults; ``kind`` is the classification axis."""
    kind = "permanent"


class TransientFault(FaultError):
    """Recoverable by retrying the same work (flaky I/O, lost worker)."""
    kind = "transient"


class PermanentFault(FaultError):
    """Unrecoverable — the run must abort with this exception."""
    kind = "permanent"


class PoisonFault(FaultError):
    """The input data itself is bad: retries cannot succeed, but the stream
    must not die — serving dead-letters the batch and moves on."""
    kind = "poison"


#: real-world exception types worth a retry (network / timeout / OS hiccups)
_TRANSIENT_REAL = (ConnectionError, TimeoutError, InterruptedError, OSError)


def classify(exc: BaseException) -> str:
    """Map any exception to ``"transient"`` / ``"permanent"`` / ``"poison"``.

    Injected ``FaultError``s carry their class; among real exceptions only
    connection/timeout/OS errors are considered transient — logic errors
    (ValueError, KeyError, ...) and ``ExecutionAborted`` are permanent."""
    if isinstance(exc, FaultError):
        return exc.kind
    if isinstance(exc, _TRANSIENT_REAL):
        return "transient"
    return "permanent"


# ---------------------------------------------------------------------------
#  FaultPlan
# ---------------------------------------------------------------------------
_EXC_BY_KIND = {"transient": TransientFault, "permanent": PermanentFault,
                "poison": PoisonFault}


@dataclass
class FaultRule:
    """One injection rule.  ``seen``/``fired`` are plan-lifetime runtime
    state, mutated under the owning plan's lock."""
    site: str
    component: Optional[str] = None   # None => any component
    kind: str = "transient"
    count: int = 1                    # max fires over the plan's lifetime
    split: Optional[int] = None       # only this split index
    after: int = 0                    # skip the first N matching calls
    p: float = 1.0                    # per-call fire probability
    delay_s: float = 0.0              # >0 => sleep instead of raising
    seen: int = 0
    fired: int = 0

    def matches(self, site: str, component: Optional[str],
                split: Optional[int]) -> bool:
        if site != self.site:
            return False
        if self.component is not None and component != self.component:
            return False
        if self.split is not None and split != self.split:
            return False
        return True

    def spec(self) -> Dict[str, object]:
        return {"site": self.site, "component": self.component,
                "kind": self.kind, "count": self.count, "split": self.split,
                "after": self.after, "p": self.p, "delay_s": self.delay_s,
                "seen": self.seen, "fired": self.fired}


class FaultPlan:
    """A seeded set of :class:`FaultRule`\\ s with thread-safe fire
    accounting.  Install with :func:`fault_scope` or ``REPRO_FAULTS``."""

    def __init__(self, rules: List[FaultRule], seed: int = 0,
                 spec: str = "") -> None:
        for r in rules:
            if r.site not in SITES:
                raise ValueError(
                    f"unknown fault site {r.site!r}; valid: {SITES}")
            if r.kind not in KINDS:
                raise ValueError(
                    f"unknown fault kind {r.kind!r}; valid: {KINDS}")
        self.rules = list(rules)
        self.seed = int(seed)
        self.spec = spec
        self.injected = 0
        self._rng = random.Random(self.seed)
        self._lock = threading.Lock()

    @classmethod
    def parse(cls, spec: str) -> "FaultPlan":
        """Parse the ``REPRO_FAULTS`` grammar (module docstring)."""
        rules: List[FaultRule] = []
        seed = 0
        for part in spec.split(";"):
            part = part.strip()
            if not part:
                continue
            if part.startswith("seed="):
                seed = int(part[5:])
                continue
            head, _, opt_str = part.partition(":")
            site, _, component = head.partition("@")
            kw: Dict[str, object] = {"site": site.strip(),
                                     "component": component.strip() or None}
            for opt in opt_str.split(","):
                opt = opt.strip()
                if not opt:
                    continue
                k, _, v = opt.partition("=")
                k, v = k.strip(), v.strip()
                if k == "kind":
                    kw["kind"] = v
                elif k in ("count", "split", "after"):
                    kw[k] = int(v)
                elif k == "p":
                    kw["p"] = float(v)
                elif k == "delay":
                    kw["delay_s"] = float(v)
                else:
                    raise ValueError(
                        f"unknown fault-rule option {k!r} in {part!r}")
            rules.append(FaultRule(**kw))
        return cls(rules, seed=seed, spec=spec)

    def reset(self) -> None:
        """Forget all fire accounting (fresh plan lifetime)."""
        with self._lock:
            self.injected = 0
            self._rng = random.Random(self.seed)
            for r in self.rules:
                r.seen = 0
                r.fired = 0

    def fire(self, site: str, component: Optional[str],
             split: Optional[int]) -> None:
        """Raise / sleep if a rule matches this call.  Called on the hot
        path only when a plan is actually installed."""
        for r in self.rules:
            if not r.matches(site, component, split):
                continue
            with self._lock:
                r.seen += 1
                if r.fired >= r.count or r.seen <= r.after:
                    continue
                if r.p < 1.0 and self._rng.random() >= r.p:
                    continue
                r.fired += 1
                self.injected += 1
            record_fault(site, r.kind, component)
            if r.delay_s > 0.0:
                time.sleep(r.delay_s)
                continue
            raise _EXC_BY_KIND[r.kind](
                f"injected {r.kind} fault at site {site!r}"
                f" (component={component!r}, split={split!r})")


# ---------------------------------------------------------------------------
#  Scope plumbing (mirrors shared_cache.cache_stats_scope)
# ---------------------------------------------------------------------------
_SCOPES: "ContextVar[Tuple[FaultPlan, ...]]" = ContextVar(
    "repro_fault_scopes", default=())

# cached parse of the REPRO_FAULTS env plan, keyed on the raw string so a
# changed env var (tests) re-parses; the plan object persists so rule fire
# counts survive across runs within one process — plan-lifetime semantics
_ENV_PLAN: Tuple[Optional[str], Optional[FaultPlan]] = (None, None)


@contextmanager
def fault_scope(plan: FaultPlan):
    """Install ``plan`` for the dynamic extent of the with-block (and any
    pool tasks submitted inside it).  Yields the plan."""
    token = _SCOPES.set(_SCOPES.get() + (plan,))
    try:
        yield plan
    finally:
        _SCOPES.reset(token)


def _env_plan(spec: str) -> FaultPlan:
    global _ENV_PLAN
    raw, plan = _ENV_PLAN
    if raw != spec or plan is None:
        plan = FaultPlan.parse(spec)
        _ENV_PLAN = (spec, plan)
    return plan


def active() -> bool:
    """Cheap check: is any fault plan installed (scope or env)?  Gates all
    snapshot/restore work so no-fault runs pay nothing."""
    return bool(_SCOPES.get()) or config.faults_spec() is not None


def inject(site: str, component: Optional[str] = None,
           split: Optional[int] = None) -> None:
    """Fire matching rules of every installed plan at this site.  No-op
    (two cheap reads) when no plan is installed."""
    plans = _SCOPES.get()
    spec = config.faults_spec()
    if not plans and spec is None:
        return
    if spec is not None:
        plans = plans + (_env_plan(spec),)
    for p in plans:
        p.fire(site, component, split)


# ---------------------------------------------------------------------------
#  Retry helpers
# ---------------------------------------------------------------------------
def backoff_schedule(retries: int, base: float,
                     cap: float = RETRY_BACKOFF_CAP_S) -> List[float]:
    """The sleep schedule ``retry_call`` uses: base * 2**i, capped."""
    return [min(base * (2.0 ** i), cap) for i in range(max(0, retries))]


def retry_call(fn: Callable, *args, where: str = "",
               max_retries: Optional[int] = None,
               backoff: Optional[float] = None,
               classify_fn: Callable[[BaseException], str] = classify,
               on_retry: Optional[Callable[[int, BaseException], None]] = None):
    """Call ``fn(*args)``, retrying transient failures with capped
    exponential backoff.  Defaults come from ``REPRO_RETRY_MAX`` /
    ``REPRO_RETRY_BACKOFF``; non-transient failures re-raise immediately."""
    retries = config.retry_max() if max_retries is None else int(max_retries)
    delay = config.retry_backoff() if backoff is None else float(backoff)
    attempt = 0
    while True:
        try:
            return fn(*args)
        except BaseException as e:
            if classify_fn(e) != "transient" or attempt >= retries:
                raise
            record_retry(where or getattr(fn, "__name__", "call"),
                         attempt, delay)
            if on_retry is not None:
                on_retry(attempt, e)
            time.sleep(delay)
            delay = min(delay * 2.0, RETRY_BACKOFF_CAP_S)
            attempt += 1


def with_retries(fn: Callable, max_retries: int = 3, backoff: float = 0.1,
                 retry_on: Tuple = (RuntimeError, OSError),
                 on_retry: Optional[Callable] = None) -> Callable:
    """Wrapper form of :func:`retry_call` with an explicit ``retry_on``
    exception filter — the ``train/fault.py`` interface, now core."""
    def _classify(e: BaseException) -> str:
        return "transient" if isinstance(e, retry_on) else "permanent"

    def wrapped(*args, **kwargs):
        return retry_call(lambda: fn(*args, **kwargs),
                          where=getattr(fn, "__name__", "call"),
                          max_retries=max_retries, backoff=backoff,
                          classify_fn=_classify, on_retry=on_retry)
    wrapped.__name__ = getattr(fn, "__name__", "wrapped")
    return wrapped


# ---------------------------------------------------------------------------
#  Degradations + recording funnels
# ---------------------------------------------------------------------------
@dataclass
class Degradation:
    """One recorded fallback step: ``kind`` names the ladder (segment, join,
    groupby, arena), ``src``/``dst`` the route degraded from/to."""
    kind: str
    src: str
    dst: str
    component: Optional[str] = None
    error: str = ""

    def spec(self) -> Dict[str, object]:
        return {"kind": self.kind, "src": self.src, "dst": self.dst,
                "component": self.component, "error": self.error}


@dataclass
class FaultRecorder:
    """Collects degradation/retry detail for attachment to an EngineRun."""
    degradations: List[Degradation] = field(default_factory=list)
    retries: List[Dict[str, object]] = field(default_factory=list)


_RECORDERS: "ContextVar[Tuple[FaultRecorder, ...]]" = ContextVar(
    "repro_fault_recorders", default=())


@contextmanager
def fault_recorder():
    """Scope that captures degradation/retry events (engines open one per
    run and attach the detail to the EngineRun)."""
    rec = FaultRecorder()
    token = _RECORDERS.set(_RECORDERS.get() + (rec,))
    try:
        yield rec
    finally:
        _RECORDERS.reset(token)


def record_fault(site: str, kind: str, component: Optional[str] = None) -> None:
    """An injection fired: bump scoped counters + emit a trace instant."""
    for stats in _sc._all_stats():
        stats.record_fault()
    if obs_trace.ACTIVE.get():
        obs_trace.on_fault(site, kind, component)


def record_retry(where: str, attempt: int, delay_s: float) -> None:
    """A transient failure is about to be retried after ``delay_s``."""
    for stats in _sc._all_stats():
        stats.record_retry()
    for rec in _RECORDERS.get():
        rec.retries.append({"where": where, "attempt": attempt,
                            "delay_s": delay_s})
    if obs_trace.ACTIVE.get():
        obs_trace.on_retry(where, attempt, delay_s)


def record_degradation(kind: str, src: str, dst: str,
                       component: Optional[str] = None,
                       error: str = "") -> Degradation:
    """A ladder fell back one rung: record counters + detail."""
    d = Degradation(kind=kind, src=src, dst=dst, component=component,
                    error=error)
    for stats in _sc._all_stats():
        stats.record_degradation()
    for rec in _RECORDERS.get():
        rec.degradations.append(d)
    if obs_trace.ACTIVE.get():
        obs_trace.on_degrade(kind, src, dst, component)
    return d


# ---------------------------------------------------------------------------
#  Chunk snapshot / restore (dispatch-granular replay)
# ---------------------------------------------------------------------------
def snapshot_cache(cache) -> Dict[str, object]:
    """Capture enough of a SharedCache to replay a failed in-place dispatch.

    Host columns are copied with plain numpy (NOT arena draws — replay
    bookkeeping must not perturb arena counters); device columns are kept by
    reference (device tensors are never mutated in place; components
    replace them).  Only the live ``[:n]`` prefix is copied."""
    cols: Dict[str, object] = {}
    n = cache.n
    for name, v in cache.columns.items():
        if _sc.is_host_column(v):
            cols[name] = np.array(v[:n])
        else:
            cols[name] = v
    return {"n": n, "cols": cols}


def restore_cache(cache, snap: Dict[str, object]) -> None:
    """Rewind a cache to a snapshot before replaying the dispatch.  The
    restored columns are FRESH buffers (detached from any arena roots the
    cache owns — those are still released exactly once by the normal
    recycle path), and the version bump invalidates device views."""
    cache.columns = {name: (np.array(v) if isinstance(v, np.ndarray) else v)
                     for name, v in snap["cols"].items()}
    cache.n = snap["n"]
    cache.version += 1
