"""Streaming execution runtime — one shared worker pool + bounded inter-tree
split channels.

The paper pipelines splits *within* an execution tree (Algorithm 2) but runs
*across* trees with a barrier: a downstream tree starts only after ALL
upstream trees finish, and every delivered cache is list-accumulated first.
This module generalizes the paper's bounded-queue pipelining to the whole
execution-tree graph (DOD-ETL-style on-demand streaming between stages):

- ``SharedWorkerPool`` — ONE size-bounded pool for every kind of work: tree
  coordination tasks, pipeline split consumers (Algorithm 2 line 21) and
  §4.3 inside-component row ranges.  ``width`` bounds the number of
  *runnable* workers; a task that must block (channel put/get, admission
  gate, future join, activity busy-wait) does so inside a *managed blocking*
  region which releases its slot so a compensation worker can keep the queue
  draining — the ForkJoinPool/ManagedBlocker discipline, which makes the
  bounded pool deadlock-free even at ``width=1``.

- ``ChannelGroup`` — per-inter-tree-edge bounded buffers (the Algorithm-2
  BlockingQueue(m') lifted to tree->tree edges).  Producers block when an
  edge's buffer is full (backpressure); the destination tree's coordinator
  selects across its input edges as splits arrive.

- ``RunAbort`` — run-wide cooperative cancellation: the first failing task
  trips it, every blocking site wakes and re-raises, and the engine surfaces
  the ORIGINAL exception instead of joining all threads first.

- ``StreamingExecutor`` — drives an ``ExecutionTreeGraph``:
  * source-rooted trees stream their chunk splits through the tree pipeline;
  * a tree whose root is row-synchronized (an explicit ``StageBoundary``)
    consumes upstream splits AS THEY ARRIVE and pipes them straight through
    its own pipeline — cross-tree overlap, the new capability;
  * block / semi-block roots keep the paper's accumulate-then-finish
    semantics (they need the complete input), with deliveries drained
    concurrently and ordered deterministically by (src_tree, split_index).
"""
from __future__ import annotations

import contextvars
import threading
import time
import warnings
from collections import deque
from contextlib import contextmanager, nullcontext
from typing import (TYPE_CHECKING, Callable, Dict, Iterator, List, Optional,
                    Tuple)

from ..obs import trace as obs_trace
from . import faults
from .component import SourceComponent
from .graph import Dataflow
from .partitioner import ExecutionTreeGraph, streamable_tree_ids
from .shared_cache import SharedCache, record_copy

if TYPE_CHECKING:  # pragma: no cover
    from .planner import RuntimePlan


class ExecutionAborted(RuntimeError):
    """Secondary error raised at blocking sites after the run was aborted.
    The engine re-raises the ORIGINAL exception recorded by ``RunAbort``."""


# ---------------------------------------------------------------------------
#  Run-wide cancellation
# ---------------------------------------------------------------------------
class RunAbort:
    """First-error latch + waker for every blocking site of a run."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._evt = threading.Event()
        self.exc: Optional[BaseException] = None
        self._subscribers: List[Callable[[], None]] = []

    @property
    def aborted(self) -> bool:
        return self._evt.is_set()

    def subscribe(self, wake: Callable[[], None]) -> None:
        """Register a waker called once when the run aborts (used to
        notify_all() on conditions that might be waiting forever)."""
        with self._lock:
            self._subscribers.append(wake)
            tripped = self._evt.is_set()
        if tripped:
            wake()

    def trip(self, exc: BaseException) -> None:
        """Record the first real error and wake every blocked thread."""
        with self._lock:
            if self.exc is None and not isinstance(exc, ExecutionAborted):
                self.exc = exc
            already = self._evt.is_set()
            self._evt.set()
            subs = list(self._subscribers)
        if not already or self.exc is exc:
            for wake in subs:
                wake()

    def check(self) -> None:
        if self._evt.is_set():
            raise ExecutionAborted("execution aborted") from self.exc


# ---------------------------------------------------------------------------
#  Futures + the shared worker pool
# ---------------------------------------------------------------------------
class TaskFuture:
    """Minimal future for SharedWorkerPool tasks (join is pool-aware)."""

    __slots__ = ("_pool", "_evt", "_value", "_exc")

    def __init__(self, pool: "SharedWorkerPool"):
        self._pool = pool
        self._evt = threading.Event()
        self._value = None
        self._exc: Optional[BaseException] = None

    def _finish(self, value=None, exc: Optional[BaseException] = None) -> None:
        self._value = value
        self._exc = exc
        self._evt.set()

    def done(self) -> bool:
        return self._evt.is_set()

    def wait(self, timeout: Optional[float] = None) -> bool:
        """Block (pool-managed) until done; never raises the task error."""
        if not self._evt.is_set():
            with self._pool.blocking():
                self._evt.wait(timeout)
        return self._evt.is_set()

    def result(self, timeout: Optional[float] = None):
        if not self.wait(timeout):
            raise TimeoutError("task did not complete in time")
        if self._exc is not None:
            raise self._exc
        return self._value


class SharedWorkerPool:
    """Size-bounded worker pool with managed blocking.

    ``width`` bounds RUNNABLE workers (the CPU concurrency).  Any pool task
    about to block must wrap the wait in ``with pool.blocking():`` — the pool
    then excludes it from the runnable count and, if work is queued, spawns a
    compensation worker so progress never depends on a blocked slot.  Thread
    count is therefore bounded by ``width + concurrently-blocked tasks``
    rather than by thread-per-tree/thread-per-split as before.
    """

    #: default seconds ``shutdown`` waits for each worker to join before
    #: declaring it leaked
    DEFAULT_JOIN_TIMEOUT_S = 10.0

    def __init__(self, width: int, name: str = "repro-pool",
                 join_timeout: Optional[float] = None):
        self.width = max(1, int(width))
        self.name = name
        self.join_timeout = (self.DEFAULT_JOIN_TIMEOUT_S
                             if join_timeout is None else float(join_timeout))
        self.leaked_threads = 0         # workers that outlived shutdown joins
        self._cond = threading.Condition()
        self._work: deque = deque()
        self._threads: set = set()
        self._idle = 0
        self._blocked = 0
        self._shutdown = False
        self._tls = threading.local()
        self._seq = 0
        self.spawned_total = 0          # instrumentation
        self.tasks_run = 0
        self.threads_hwm = 0            # peak live worker threads
        self.runnable_hwm = 0           # peak concurrently-runnable workers

    # ------------------------------------------------------------- internals
    def _runnable(self) -> int:
        return len(self._threads) - self._blocked

    def _spawn_locked(self) -> None:
        self._seq += 1
        self.spawned_total += 1
        t = threading.Thread(target=self._worker, daemon=True,
                             name=f"{self.name}-{self._seq}")
        self._threads.add(t)
        self.threads_hwm = max(self.threads_hwm, len(self._threads))
        t.start()

    def _worker(self) -> None:
        self._tls.is_worker = True
        me = threading.current_thread()
        try:
            while True:
                with self._cond:
                    while not self._work:
                        if self._shutdown:
                            return
                        if self._runnable() > self.width:
                            return      # surplus compensation worker retires
                        self._idle += 1
                        self._cond.wait(0.2)
                        self._idle -= 1
                    fn, args, ctx, fut = self._work.popleft()
                    self.tasks_run += 1
                    self.runnable_hwm = max(self.runnable_hwm,
                                            self._runnable())
                try:
                    # run under the submitter's contextvars context so scoped
                    # instrumentation (cache_stats_scope) follows the task —
                    # nested submits re-capture transitively
                    fut._finish(value=ctx.run(fn, *args))
                except BaseException as e:  # noqa: BLE001 — goes to the future
                    fut._finish(exc=e)
        finally:
            with self._cond:
                self._threads.discard(me)
                self._cond.notify_all()

    # ------------------------------------------------------------------- API
    def submit(self, fn: Callable, *args) -> TaskFuture:
        fut = TaskFuture(self)
        ctx = contextvars.copy_context()
        with self._cond:
            if self._shutdown:
                raise RuntimeError("pool is shut down")
            self._work.append((fn, args, ctx, fut))
            if self._idle > 0:
                self._cond.notify()
            elif self._runnable() < self.width:
                self._spawn_locked()
        return fut

    def is_worker_thread(self) -> bool:
        return bool(getattr(self._tls, "is_worker", False))

    @contextmanager
    def blocking(self):
        """Managed blocking region (no-op off pool threads): the caller stops
        counting against ``width`` and a spare worker keeps the queue moving."""
        if not self.is_worker_thread():
            yield
            return
        with self._cond:
            self._blocked += 1
            if self._work and self._idle == 0 and self._runnable() < self.width:
                self._spawn_locked()
        try:
            yield
        finally:
            with self._cond:
                self._blocked -= 1

    def stats(self) -> Dict[str, int]:
        with self._cond:
            return {"width": self.width, "threads": len(self._threads),
                    "blocked": self._blocked, "spawned_total": self.spawned_total,
                    "tasks_run": self.tasks_run,
                    "threads_hwm": self.threads_hwm,
                    "runnable_hwm": self.runnable_hwm,
                    "leaked_threads": self.leaked_threads}

    def shutdown(self, wait: bool = True,
                 join_timeout: Optional[float] = None) -> None:
        """Stop the pool.  With ``wait=True`` joins each worker for up to
        ``join_timeout`` seconds (default: the pool's configured timeout);
        stragglers that fail to join are counted in ``leaked_threads``,
        reported as a ``pool_leaked_threads`` gauge on active tracers, and
        warned about — never again discarded silently."""
        with self._cond:
            self._shutdown = True
            self._cond.notify_all()
            threads = list(self._threads)
        if not wait:
            return
        timeout = (self.join_timeout if join_timeout is None
                   else float(join_timeout))
        leaked = []
        for t in threads:
            t.join(timeout=timeout)
            if t.is_alive():
                leaked.append(t.name)
        if leaked:
            self.leaked_threads += len(leaked)
            for tr in obs_trace.ACTIVE.get():
                tr.metrics.gauge_set("pool_leaked_threads",
                                     self.leaked_threads)
            warnings.warn(
                f"SharedWorkerPool {self.name!r}: {len(leaked)} worker "
                f"thread(s) did not join within {timeout:.1f}s: "
                f"{', '.join(leaked)}", RuntimeWarning, stacklevel=2)


# ---------------------------------------------------------------------------
#  Admission gate — Algorithm 2's BlockingQueue(m') on the shared pool
# ---------------------------------------------------------------------------
class AdmissionGate:
    """Bounds in-flight splits of one tree pipeline to m' (memory bound)."""

    def __init__(self, limit: int, abort: Optional[RunAbort] = None):
        self.limit = max(1, int(limit))
        self._cond = threading.Condition()
        self._inflight = 0
        self._abort = abort
        if abort is not None:
            abort.subscribe(self._wake)

    def _wake(self) -> None:
        with self._cond:
            self._cond.notify_all()

    def acquire(self, pool: Optional[SharedWorkerPool] = None) -> None:
        with self._cond:                       # fast path: slot available
            if self._abort is not None:
                self._abort.check()
            if self._inflight < self.limit:
                self._inflight += 1
                return
        ctx = pool.blocking() if pool is not None else nullcontext()
        t0 = time.perf_counter() if obs_trace.ACTIVE.get() else 0.0
        with ctx:                              # slow path: managed wait
            with self._cond:
                while self._inflight >= self.limit:
                    if self._abort is not None and self._abort.aborted:
                        self._abort.check()
                    self._cond.wait(0.2)
                if self._abort is not None:
                    self._abort.check()
                self._inflight += 1
        if t0:
            obs_trace.on_wait("gate.acquire", t0, time.perf_counter(),
                              limit=self.limit)

    def release(self) -> None:
        with self._cond:
            self._inflight -= 1
            self._cond.notify_all()


# ---------------------------------------------------------------------------
#  Bounded inter-tree channels
# ---------------------------------------------------------------------------
CLOSED = object()      # sentinel returned by ChannelGroup.get at end of stream

# a delivered split: (src_tree_id, split_index, dst_component, cache)
Delivery = Tuple[int, int, str, SharedCache]


class _EdgeBuffer:
    __slots__ = ("capacity", "items", "open")

    def __init__(self, capacity: Optional[int]):
        self.capacity = capacity          # None => unbounded (legacy mode)
        self.items: deque = deque()
        self.open = True


class ChannelGroup:
    """All inter-tree input buffers of ONE destination tree.

    Each incoming edge gets its own size-bounded buffer (per-edge queue depth
    from the planner); the buffers share a single condition so the consumer
    can select across edges as splits arrive.  Producers block on a full edge
    buffer — that is the cross-tree backpressure.
    """

    def __init__(self, pool: Optional[SharedWorkerPool] = None,
                 abort: Optional[RunAbort] = None, name: str = "chan"):
        self.name = name
        self._cond = threading.Condition()
        self._pool = pool
        self._abort = abort
        self._buffers: Dict[Tuple[int, int], _EdgeBuffer] = {}
        self._rr = 0
        self._closed_evt = threading.Event()   # set once EVERY edge is closed
        self.max_depth = 0               # instrumentation: peak buffered splits
        if abort is not None:
            abort.subscribe(self._wake)

    def _wake(self) -> None:
        with self._cond:
            self._cond.notify_all()
        self._closed_evt.set()           # release drain_on_close waiters too

    def add_edge(self, key: Tuple[int, int],
                 capacity: Optional[int] = None) -> None:
        with self._cond:
            self._buffers[key] = _EdgeBuffer(capacity)

    @property
    def edges(self) -> List[Tuple[int, int]]:
        return list(self._buffers.keys())

    def _check_abort(self) -> None:
        if self._abort is not None and self._abort.aborted:
            self._abort.check()

    # -------------------------------------------------------------- producer
    def put(self, key: Tuple[int, int], item: Delivery) -> None:
        # edge-site injection: delay rules sleep here (simulated slow edge);
        # raise rules fail the producing task, which escalates through
        # RunAbort to a run-level retry
        faults.inject("edge", component=item[2], split=item[1])
        buf = self._buffers[key]
        with self._cond:                       # fast path: space available
            self._check_abort()
            if buf.capacity is None or len(buf.items) < buf.capacity:
                buf.items.append(item)
                depth = sum(len(b.items) for b in self._buffers.values())
                self.max_depth = max(self.max_depth, depth)
                self._cond.notify_all()
                if obs_trace.ACTIVE.get():
                    obs_trace.counter("channel", self.name, depth=depth)
                return
        ctx = (self._pool.blocking() if self._pool is not None
               else nullcontext())
        t0 = time.perf_counter() if obs_trace.ACTIVE.get() else 0.0
        with ctx:                              # slow path: backpressure
            with self._cond:
                while len(buf.items) >= buf.capacity:
                    self._check_abort()
                    self._cond.wait(0.2)
                self._check_abort()
                buf.items.append(item)
                depth = sum(len(b.items) for b in self._buffers.values())
                self._cond.notify_all()
        if t0:
            obs_trace.on_wait("channel.put", t0, time.perf_counter(),
                              channel=self.name)
            obs_trace.counter("channel", self.name, depth=depth)

    def close(self, key: Tuple[int, int]) -> None:
        with self._cond:
            self._buffers[key].open = False
            self._cond.notify_all()
            if all(not b.open for b in self._buffers.values()):
                self._closed_evt.set()

    def _try_get_locked(self, keys):
        """One round-robin selection attempt; None when nothing buffered."""
        for i in range(len(keys)):
            buf = self._buffers[keys[(self._rr + i) % len(keys)]]
            if buf.items:
                self._rr = (self._rr + i + 1) % len(keys)
                item = buf.items.popleft()
                self._cond.notify_all()
                return item
        return None

    # -------------------------------------------------------------- consumer
    def get(self):
        """Next delivery from any edge (round-robin), blocking until one
        arrives; CLOSED once every edge is closed and drained."""
        with self._cond:                       # fast path: split buffered
            self._check_abort()
            keys = list(self._buffers.keys())
            item = self._try_get_locked(keys)
            if item is not None:
                return item
            if all(not b.open for b in self._buffers.values()):
                return CLOSED
        ctx = (self._pool.blocking() if self._pool is not None
               else nullcontext())
        t0 = time.perf_counter() if obs_trace.ACTIVE.get() else 0.0
        try:
            with ctx:                          # slow path: managed wait
                with self._cond:
                    while True:
                        self._check_abort()
                        item = self._try_get_locked(keys)
                        if item is not None:
                            return item
                        if all(not b.open for b in self._buffers.values()):
                            return CLOSED
                        self._cond.wait(0.2)
        finally:
            if t0:
                obs_trace.on_wait("channel.get", t0, time.perf_counter(),
                                  channel=self.name)

    def __iter__(self) -> Iterator[Delivery]:
        while True:
            item = self.get()
            if item is CLOSED:
                return
            yield item

    def drain_on_close(self) -> List[Delivery]:
        """Wait until every edge is closed, then take everything at once.
        For accumulate-semantics consumers (block / semi-block roots) this is
        cheaper than per-split wakeups — the full input must materialize
        before they can run anyway, so per-edge buffers feeding them are left
        unbounded and producers never stall on delivery."""
        if not self._closed_evt.is_set():
            ctx = (self._pool.blocking() if self._pool is not None
                   else nullcontext())
            t0 = time.perf_counter() if obs_trace.ACTIVE.get() else 0.0
            with ctx:
                self._closed_evt.wait()
            if t0:
                obs_trace.on_wait("channel.drain", t0, time.perf_counter(),
                                  channel=self.name)
        with self._cond:
            self._check_abort()
            items: List[Delivery] = []
            for buf in self._buffers.values():
                items.extend(buf.items)
                buf.items.clear()
            return items


# ---------------------------------------------------------------------------
#  The streaming executor
# ---------------------------------------------------------------------------
class StreamingExecutor:
    """Runs an execution-tree graph on one shared pool with streaming
    inter-tree channels.  Modes (from OptimizeOptions):

    - ``streaming=True`` + ``concurrent_trees=True``: all tree coordinators
      start immediately; dependencies are carried by channel closure, and
      row-synchronized (stage-boundary) roots overlap with their upstream.
    - ``streaming=False`` + ``concurrent_trees=True``: the paper's planner —
      coordinators gate on upstream completion, channels are unbounded and
      fully drained before the tree starts (legacy accumulate semantics).
    - ``concurrent_trees=False``: strict topological one-tree-at-a-time.
    """

    def __init__(self, flow: Dataflow, g_tau: ExecutionTreeGraph,
                 options, plan: "RuntimePlan",
                 pool: Optional[SharedWorkerPool] = None):
        from .pipeline import TreePipeline        # local import (cycle)
        self._TreePipeline = TreePipeline
        self.flow = flow
        self.g_tau = g_tau
        self.options = options
        self.plan = plan
        self.abort = RunAbort()
        self.pool = pool or SharedWorkerPool(plan.pool_width)
        self._owns_pool = pool is None
        self.streamed_edges: List[Tuple[int, int]] = []

        # wake every component condition on abort so busy/order waiters exit
        self.abort.subscribe(self._wake_components)

        streaming_on = bool(options.streaming) and bool(options.concurrent_trees)
        self._streamed_trees = (streamable_tree_ids(flow, g_tau)
                                if streaming_on else set())
        self._groups: Dict[int, ChannelGroup] = {}
        for (a, b) in g_tau.edges:
            grp = self._groups.get(b)
            if grp is None:
                grp = self._groups[b] = ChannelGroup(
                    self.pool, self.abort, name=f"tree{b}-in")
            # bounded depth (backpressure) only where splits are consumed as
            # they arrive; accumulate-semantics consumers need the full input
            # regardless, so their edges stay unbounded and are drained once
            depth = (plan.channel_depth.get((a, b))
                     if b in self._streamed_trees else None)
            grp.add_edge((a, b), capacity=depth)

    # ------------------------------------------------------------------ util
    def channel_hwm(self) -> int:
        """Peak buffered splits across all inter-tree channel groups."""
        return max((g.max_depth for g in self._groups.values()), default=0)

    def _wake_components(self) -> None:
        for comp in self.flow.vertices.values():
            with comp.cond:
                comp.cond.notify_all()

    # -------------------------------------------------------------- delivery
    def _deliver(self, dst: str, cache: SharedCache, split_index: int,
                 src_tree: int) -> None:
        dtid = self.g_tau.tree_of[dst]
        self._groups[dtid].put((src_tree, dtid),
                               (src_tree, split_index, dst, cache))

    # -------------------------------------------------------------- per tree
    def _source_splits(self, root: SourceComponent) -> Iterator[SharedCache]:
        opts = self.options
        total = root.total_rows()
        # explicit option wins; else the runtime plan's backend-aligned batch
        # size (unless this source's data is chunk-sensitive); else an even
        # split of the source
        planned = None if root.chunk_sensitive else self.plan.chunk_rows
        chunk = (opts.chunk_rows or planned
                 or max(1, -(-total // max(opts.num_splits, 1))))
        for i, c in enumerate(root.chunks(chunk)):
            c.split_index = i
            try:
                faults.inject("chunk", component=root.name, split=i)
            except BaseException:
                c.recycle()          # the drawn chunk must not strand buffers
                raise
            yield c

    @staticmethod
    def _copy_split(s: SharedCache) -> SharedCache:
        c = s.copy()
        record_copy(s)
        c.split_index = s.split_index
        s.recycle()          # the engine keeps only the private copy
        return c

    def _run_pipeline(self, tp, splits, process_root: bool) -> None:
        opts = self.options
        if not opts.shared_cache:
            splits = (self._copy_split(s) for s in splits)
        if opts.pipelined:
            m_prime = opts.pipeline_degree or opts.num_splits
            tp.run(splits, m_prime=m_prime, process_root=process_root)
        else:
            tp.run_sequential(splits, process_root=process_root)

    def run_tree(self, tree) -> None:
        opts = self.options
        flow = self.flow
        root = flow.component(tree.root)
        tp = self._TreePipeline(
            flow, tree, self.g_tau.tree_of, self._deliver,
            mt_config=opts.mt_threads, pool=self.pool,
            shared=opts.shared_cache, abort=self.abort)
        group = self._groups.get(tree.tree_id)

        if isinstance(root, SourceComponent):
            self._run_pipeline(tp, self._source_splits(root),
                               process_root=False)
            if group is not None:
                # cross-tree deliveries into a member of a source tree
                # (e.g. a shared sink fed by several trees)
                for (src, idx, dst, cache) in sorted(
                        group.drain_on_close(), key=lambda e: (e[0], e[1])):
                    cache.split_index = idx
                    tp.consume_at(dst, cache)
                    cache.recycle()
        elif root.ctype.roots_tree:
            # block / semi-block root: accumulate-then-finish (paper §3) —
            # deliveries taken once all upstream edges close, ordered
            # deterministically by (src_tree, split_index).
            entries = group.drain_on_close() if group is not None else []
            entries.sort(key=lambda e: (e[0], e[1]))
            state = root.new_state()
            extras: List[Delivery] = []
            out: Optional[SharedCache] = None
            # sharded runs intercept finish() on cut roots: tags records
            # each accumulated cache's (src_tree, split_index) provenance so
            # the merge pass can reassemble the serial accumulation order
            tags: List[Tuple[int, int]] = []
            try:
                for (src, idx, dst, cache) in entries:
                    if dst == tree.root:
                        tags.append((src, idx))
                        root.accumulate(state, cache)
                    else:
                        extras.append((src, idx, dst, cache))
                if root.shard_role is not None:
                    out = root._shard_ctx.intercept_finish(root, state, tags)
                else:
                    out = root.finish(state)
                state = None           # finish consumed (and recycled) it
                for (src, idx, dst, cache) in extras:
                    cache.split_index = idx
                    tp.consume_at(dst, cache)
                    cache.recycle()
                extras = []
                self._run_pipeline(tp, iter(out.split(opts.num_splits)),
                                   process_root=False)
            finally:
                # an abort between accumulate and the last consumed split
                # must not strand arena buffers: recycle whatever was not
                # handed downstream (recycle() is idempotent, so the success
                # path — where finish/consume already recycled — is a no-op)
                if state:
                    for cache in state:
                        cache.recycle()
                for (_, _, _, cache) in extras:
                    cache.recycle()
                if out is not None:
                    out.recycle()    # its splits (views) were consumed
        else:
            # row-synchronized root — an explicit stage boundary
            if tree.tree_id in self._streamed_trees and group is not None:
                self.streamed_edges.extend(group.edges)

                def arriving():
                    for (_, idx, _, cache) in group:
                        cache.split_index = idx
                        yield cache
                self._run_pipeline(tp, arriving(), process_root=True)
            else:
                entries = (group.drain_on_close()
                           if group is not None else [])
                entries.sort(key=lambda e: (e[0], e[1]))
                multi_src = len({e[0] for e in entries}) > 1

                def drained():
                    for k, (_, idx, dst, cache) in enumerate(entries):
                        cache.split_index = k if multi_src else idx
                        yield cache
                self._run_pipeline(tp, drained(), process_root=True)

    def _run_tree_guarded(self, tree) -> None:
        try:
            self.run_tree(tree)
        finally:
            # close this tree's outgoing edge buffers (even on error, so
            # downstream consumers wake and observe the abort)
            for (a, b) in self.g_tau.edges:
                if a == tree.tree_id:
                    self._groups[b].close((a, b))

    # ------------------------------------------------------------------- run
    def execute(self) -> None:
        from .scheduler import run_tree_graph     # local import (cycle)
        opts = self.options
        gate_upstream = not (opts.streaming and opts.concurrent_trees)
        try:
            run_tree_graph(self.g_tau, self._run_tree_guarded,
                           concurrent=opts.concurrent_trees,
                           pool=self.pool, abort=self.abort,
                           gate_on_upstream=gate_upstream)
        except BaseException as e:
            raise (self.abort.exc if self.abort.exc is not None else e) from None

    def shutdown(self) -> None:
        if self._owns_pool:
            self.pool.shutdown()
