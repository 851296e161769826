"""Dataflow components and the paper's §3 classification.

- ROW_SYNCHRONIZED: row-at-a-time processing; mutates a shared cache in place
  (filter, lookup, splitter, expression, format converter, projector, ...).
- BLOCK: accumulates ALL rows from a SINGLE upstream before any output
  (aggregations: sum/avg/min/max, sort, ...).  Roots a new execution tree.
- SEMI_BLOCK: accumulates rows from MULTIPLE upstreams until a condition is
  met (union, merge, ...).  Roots a new execution tree.
- SOURCE / SINK: dataflow entry (emits caches) / exit (consumes caches).
  Sources behave like roots; sinks are row-synchronized consumers.
"""
from __future__ import annotations

import enum
import threading
import time
from typing import Callable, Dict, Iterable, Iterator, List, Optional, Sequence

import numpy as np

from ..obs import trace as obs_trace
from . import faults
from .shared_cache import SharedCache, concat_caches


class ComponentType(enum.Enum):
    SOURCE = "source"
    ROW_SYNC = "row-synchronized"
    SEMI_BLOCK = "semi-block"
    BLOCK = "block"
    SINK = "sink"

    @property
    def roots_tree(self) -> bool:
        """Block and semi-block components root a new execution tree
        (Algorithm 1); sources do too, by virtue of in-degree 0."""
        return self in (ComponentType.BLOCK, ComponentType.SEMI_BLOCK)

    @property
    def streams(self) -> bool:
        return self in (ComponentType.ROW_SYNC, ComponentType.SINK)


class Component:
    """Base class.  An *activity* (the paper uses component/activity
    interchangeably) is the `process_*` method of a component.

    Thread-safety protocol (paper Algorithm 2 lines 6-11): each component owns
    a `busy` flag + Condition; pipeline consumer threads serialize access so a
    component processes one shared cache at a time, in split order when
    `order_sensitive` is set.
    """

    ctype: ComponentType = ComponentType.ROW_SYNC
    #: True if downstream semantics require split arrival order (e.g. before a
    #: Merge) — the pipeline then hands caches to this component in order.
    order_sensitive: bool = False
    #: True forces this component to root a new execution tree even when it is
    #: row-synchronized (an explicit stage cut — see StageBoundary).  The
    #: streaming executor pipes splits across such a boundary as they arrive.
    tree_boundary: bool = False
    #: True when the component maps each input row to exactly one output row
    #: in the same position (adds/overwrites columns only — Lookup,
    #: Expression, Converter, Project, StageBoundary).  Such components may be
    #: hopped by a commuting Filter (core/optimizer.py); row-dropping
    #: (Filter), row-reordering (Sort) and accumulate components must keep
    #: False.
    row_preserving: bool = False
    #: True when a failed per-chunk dispatch may be replayed in place after
    #: rewinding the cache to its pre-dispatch snapshot (the fault-tolerance
    #: replay contract).  Row-synchronized components qualify: they only
    #: mutate the cache handed to them.  Components with side effects beyond
    #: the cache — sinks (external writes), block/semi-block accumulators
    #: (state consumed by ``finish``), sources (chunk generation is re-driven
    #: by run-level replay) — must keep False; their transient failures
    #: escalate to run-level retry instead.
    replay_safe: bool = True
    #: sharded-execution role, set by the shard runtime for the duration of a
    #: sharded run on first-layer block/semi-block cut components only:
    #: ``"partial"`` — finish() is intercepted to stash a per-shard partial
    #: and emit an empty schema-shaped cache; ``"merge"`` — finish() combines
    #: the stashed partials into the exact serial result.  ``None`` (the
    #: default) leaves finish() untouched.
    shard_role: Optional[str] = None

    def __init__(self, name: str):
        self.name = name
        self.busy = False
        self.cond = threading.Condition()
        self.next_split = 0          # order enforcement for order_sensitive
        #: operator backend this component dispatches its kernels through;
        #: None => the process default (REPRO_BACKEND env var / "numpy").
        #: Engines assign the run's backend here before executing.
        self.backend = None
        # instrumentation
        self.rows_in = 0
        self.rows_out = 0
        self.busy_time = 0.0
        self.calls = 0

    def get_backend(self):
        """The active operator backend (core/backend/) for this component."""
        if self.backend is not None:
            return self.backend
        from .backend import get_default_backend     # deferred (cycle-free)
        return get_default_backend()

    # ------------------------------------------------------------ row-sync
    def process(self, cache: SharedCache, shared: bool = True) -> List[SharedCache]:
        """Process one cache.  With ``shared=True`` the component MUST mutate
        in place (shared caching scheme); with ``shared=False`` the engine has
        already handed it a private copy.  Returns the list of output caches
        (usually the same object; splitters return several)."""
        t0 = time.perf_counter()
        n_in = cache.n
        split = cache.split_index
        faults.inject("chunk", component=self.name, split=split)
        out = self._run(cache)
        t1 = time.perf_counter()
        self.busy_time += t1 - t0
        self.calls += 1
        self.rows_in += n_in
        n_out = sum(c.n for c in out)
        self.rows_out += n_out
        if obs_trace.ACTIVE.get():
            obs_trace.on_dispatch(self.name, t0, t1, split, n_in, n_out)
        return out

    def _run(self, cache: SharedCache) -> List[SharedCache]:  # pragma: no cover
        raise NotImplementedError

    # --------------------------------------------------- inside-component MT
    #: Override to True on heavy components that support §4.3 multithreading.
    supports_multithreading: bool = False

    def process_range(self, cache: SharedCache, rows: slice) -> Dict[str, np.ndarray]:
        """Process a sub-range of rows (inside-component parallelization).
        Returns the output columns for that range; the engine's row-order
        synchronizer merges ranges back in input order."""
        raise NotImplementedError

    # ------------------------------------------------------------ block/semi
    def new_state(self):
        """Per-execution accumulation state for block/semi-block components."""
        return []

    def accumulate(self, state, cache: SharedCache) -> None:
        t0 = time.perf_counter()
        faults.inject("chunk", component=self.name, split=cache.split_index)
        state.append(cache)
        t1 = time.perf_counter()
        self.busy_time += t1 - t0
        self.rows_in += cache.n
        if obs_trace.ACTIVE.get():
            obs_trace.on_accumulate(self.name, t0, t1, cache.n)

    def finish(self, state) -> SharedCache:
        """Consume accumulated caches, emit the result as one cache."""
        raise NotImplementedError

    # --------------------------------------------------- segment fusion
    def segment_ops(self) -> Optional[list]:
        """Declarative description of this component as fusable segment ops
        (see ``etl.components.FusedSegment``), or ``None`` when the component
        cannot join a fused segment (blocks, sinks, sources, anything with
        side effects or non-row-local semantics).  Row-synchronized
        components that implement this are row-local by the paper's §3
        contract: each output row depends only on its own input row."""
        return None

    # --------------------------------------------------- column provenance
    def produced_columns(self) -> Optional[frozenset]:
        """Columns this component ADDS or OVERWRITES on the cache.  ``None``
        means unknown — the cost-based optimizer then refuses any rewrite
        that needs the answer.  Pure pass-throughs return an empty set."""
        return None

    def consumed_columns(self) -> Optional[frozenset]:
        """Columns this component READS.  ``None`` means unknown (e.g. an
        undeclared predicate lambda) — rewrites requiring disjointness with a
        neighbour's outputs are refused."""
        return None

    def output_schema(self, incols: frozenset) -> Optional[frozenset]:
        """The column set this component emits given input columns
        ``incols`` — the static schema-propagation hook behind
        ``planner.infer_schema`` (build-time read validation in the Session
        API).  ``None`` means unknown; the inference pass then stops
        validating downstream of this component."""
        return None

    # ------------------------------------------------------------------ misc
    def est_output_bytes(self) -> Optional[int]:
        """Cache-size metadata: estimated total bytes this component emits
        over a full run, when knowable up front (sources know their table
        size).  ``None`` means unknown — the planner then falls back to the
        component's input estimate."""
        return None

    def reset_stats(self) -> None:
        self.rows_in = self.rows_out = 0
        self.busy_time = 0.0
        self.calls = 0
        self.next_split = 0
        # an aborted run may leave the flag set; clearing it here keeps the
        # flow reusable after a permanent fault
        self.busy = False

    def spec(self) -> Dict[str, str]:
        """Metadata-store component specification."""
        return {"name": self.name, "type": self.ctype.value,
                "class": type(self).__name__}

    # --------------------------------------------------------------- pickling
    # The process shard route ships whole flows to spawned workers.  Locks
    # and backends don't pickle; both are reconstructed on load (the worker
    # re-resolves the backend from its own environment).
    _UNPICKLABLE = ("cond", "backend", "_shard_ctx")

    def __getstate__(self):
        state = dict(self.__dict__)
        for k in self._UNPICKLABLE:
            state.pop(k, None)
        return state

    def __setstate__(self, state):
        self.__dict__.update(state)
        self.cond = threading.Condition()
        self.backend = None

    def __repr__(self) -> str:
        return f"{type(self).__name__}({self.name!r})"


class SourceComponent(Component):
    """Emits the input row set as a stream of caches (chunks)."""

    ctype = ComponentType.SOURCE
    replay_safe = False          # chunk draws re-run at run level

    #: True when the DATA this source emits depends on chunk boundaries
    #: (e.g. an RNG-per-chunk synthetic source).  The executor then never
    #: realigns the chunk size to a backend's preferred batch size
    #: (RuntimePlan.chunk_rows) — only an explicit OptimizeOptions.chunk_rows
    #: may change it.
    chunk_sensitive: bool = False

    def chunks(self, chunk_rows: int) -> Iterator[SharedCache]:  # pragma: no cover
        raise NotImplementedError

    def total_rows(self) -> int:  # pragma: no cover
        raise NotImplementedError


class SinkComponent(Component):
    """Consumes caches (writes results).  Row-synchronized semantics."""

    ctype = ComponentType.SINK
    replay_safe = False          # external writes are side effects

    def output_schema(self, incols: frozenset) -> frozenset:
        return incols            # a sink writes exactly what it receives

    def _run(self, cache: SharedCache) -> List[SharedCache]:
        self.write(cache)
        return [cache]

    def write(self, cache: SharedCache) -> None:  # pragma: no cover
        raise NotImplementedError


class BlockComponent(Component):
    """Accumulate-all-then-emit (single upstream)."""

    ctype = ComponentType.BLOCK
    replay_safe = False          # accumulated state is consumed by finish()

    def finish(self, state) -> SharedCache:
        raise NotImplementedError


class SemiBlockComponent(Component):
    """Accumulate from multiple upstreams, then emit."""

    ctype = ComponentType.SEMI_BLOCK
    replay_safe = False          # accumulated state is consumed by finish()

    def finish(self, state) -> SharedCache:
        raise NotImplementedError


class FnComponent(Component):
    """Row-synchronized component from a plain function
    ``fn(cache) -> None`` (mutates in place)."""

    def __init__(self, name: str, fn: Callable[[SharedCache], None]):
        super().__init__(name)
        self.fn = fn

    def _run(self, cache: SharedCache) -> List[SharedCache]:
        self.fn(cache)
        return [cache]


class StageBoundary(Component):
    """Explicit execution-tree boundary: a row-synchronized pass-through that
    the partitioner roots a new tree at (Algorithm 1 extended).

    Marks a stage cut in the dataflow — DOD-ETL-style stage decoupling.  The
    streaming executor connects the two trees with a bounded split channel
    and the downstream tree consumes splits AS THEY ARRIVE, overlapping the
    stages; the cut costs one copy per split (paper §4.1 tree->tree
    transition).  Useful to bound a stage's working set, isolate a slow
    stage behind backpressure, or (eventually) place stages on different
    workers."""

    tree_boundary = True
    row_preserving = True

    def _run(self, cache: SharedCache) -> List[SharedCache]:
        return [cache]

    def produced_columns(self) -> frozenset:
        return frozenset()

    def consumed_columns(self) -> frozenset:
        return frozenset()

    def output_schema(self, incols: frozenset) -> frozenset:
        return incols
