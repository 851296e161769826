"""Algorithm 2 — pipeline parallelization within an execution tree.

A *pipeline consumer task* carries ONE shared cache (one horizontal split)
through the tree's activities in sequence.  Each activity has a `busy` flag
guarded by a Condition: a consumer `wait()`s while the activity is processing
another split and is woken by `notify_all()` when it frees up — exactly the
paper's Algorithm 2 lines 6-11.

Admission is bounded to m' in-flight shared caches (the paper's fix-sized
BlockingQueue, lines 14-21).  Consumers run as tasks on the run's
``SharedWorkerPool`` (see executor.py) instead of a thread per split: the
pool is shared with tree-coordination tasks and §4.3 row-range work, and
every blocking wait (admission, busy/order wait, row-range join, cross-tree
channel put) is a managed-blocking region so a size-bounded pool cannot
deadlock.  ``BlockingQueue``/``HouseKeepingThread`` below keep the paper's
literal thread-queue formulation for reference and tests.

Inside-component parallelization (§4.3) hooks in here too: activities with a
configured thread count split their cache into row ranges, process the ranges
on the shared pool and merge with the row-order synchronizer.
"""
from __future__ import annotations

import queue
import threading
import time
from contextlib import nullcontext
from typing import Callable, Dict, List, Optional

from ..obs import trace as obs_trace
from . import config, faults
from .component import Component
from .executor import AdmissionGate, RunAbort, SharedWorkerPool, TaskFuture
from .graph import Dataflow
from .partitioner import ExecutionTree
from .shared_cache import SharedCache, record_copy

# deliver_fn(dst_component_name, cache, split_index, src_tree_id)
DeliverFn = Callable[[str, SharedCache, int, int], None]


class BlockingQueue:
    """Fix-sized queue of live consumer threads (paper line 14).  Kept as the
    paper's literal formulation; the engine path now bounds admission with
    ``executor.AdmissionGate`` on the shared pool instead."""

    def __init__(self, capacity: int):
        self.q: "queue.Queue" = queue.Queue(maxsize=max(1, capacity))

    def add(self, th: threading.Thread) -> None:
        self.q.put(th)      # blocks while the queue is full

    def reap(self) -> int:
        """Remove finished threads; returns the number reaped."""
        reaped = 0
        alive = []
        try:
            while True:
                th = self.q.get_nowait()
                if th.is_alive():
                    alive.append(th)
                else:
                    reaped += 1
        except queue.Empty:
            pass
        for th in alive:
            self.q.put(th)
        return reaped


class HouseKeepingThread(threading.Thread):
    """Cleans finished consumer threads out of the blocking queue so new
    consumers can be admitted (paper line 15)."""

    def __init__(self, bq: BlockingQueue, stop_evt: threading.Event,
                 interval: float = 0.001):
        super().__init__(daemon=True, name="housekeeper")
        self.bq = bq
        self.stop_evt = stop_evt
        self.interval = interval

    def run(self) -> None:
        while not self.stop_evt.is_set():
            self.bq.reap()
            time.sleep(self.interval)
        self.bq.reap()


class ActivityRunner:
    """Wraps one component as a pipeline activity with the busy/wait/notify
    protocol plus optional §4.3 multithreading."""

    def __init__(self, comp: Component, mt_threads: int = 1,
                 pool: Optional[SharedWorkerPool] = None,
                 abort: Optional[RunAbort] = None):
        self.comp = comp
        self.mt_threads = mt_threads
        self.pool = pool
        self.abort = abort

    def _ready(self, cache: SharedCache) -> bool:
        comp = self.comp
        return not comp.busy and (not comp.order_sensitive
                                  or comp.next_split == cache.split_index)

    def _acquire(self, cache: SharedCache) -> None:
        comp = self.comp
        with comp.cond:                         # fast path, no managed block
            if self._ready(cache):
                comp.busy = True                # paper line 8
                return
        ctx = self.pool.blocking() if self.pool is not None else nullcontext()
        t0 = time.perf_counter() if obs_trace.ACTIVE.get() else 0.0
        with ctx:
            with comp.cond:
                while not self._ready(cache):
                    if self.abort is not None and self.abort.aborted:
                        self.abort.check()
                    comp.cond.wait(0.2)         # paper line 7
                comp.busy = True                # paper line 8
        if t0:
            obs_trace.on_wait("activity.busy", t0, time.perf_counter(),
                              component=comp.name, split=cache.split_index)

    def process(self, cache: SharedCache, shared: bool) -> List[SharedCache]:
        comp = self.comp
        self._acquire(cache)
        try:
            mt = (self.mt_threads > 1 and comp.supports_multithreading
                  and self.pool is not None and cache.n > self.mt_threads)
            if comp.replay_safe and faults.active():
                out = self._process_replayed(cache, shared, mt)
            elif mt:
                out = self._process_multithreaded(cache)
            else:
                out = comp.process(cache, shared=shared)    # paper line 9
        finally:
            with comp.cond:
                comp.busy = False               # paper line 10
                comp.next_split += 1
                comp.cond.notify_all()          # paper line 11
        return out

    def _process_replayed(self, cache: SharedCache, shared: bool,
                          mt: bool) -> List[SharedCache]:
        """Chunk-granular replay: transient dispatch failures rewind the
        cache to its pre-dispatch snapshot and retry in place.  Must run
        INSIDE the acquire window — the finally above advances
        ``next_split`` even on failure, so a retry at any outer level would
        deadlock order-sensitive successors.  Only entered when a fault plan
        is installed (``faults.active()``), so no-fault runs never pay for
        the snapshot."""
        comp = self.comp
        snap = faults.snapshot_cache(cache)
        retries = config.retry_max()
        delay = config.retry_backoff()
        attempt = 0
        while True:
            try:
                if mt:
                    return self._process_multithreaded(cache)
                return comp.process(cache, shared=shared)
            except BaseException as e:
                if faults.classify(e) != "transient" or attempt >= retries:
                    raise
                if self.abort is not None and self.abort.aborted:
                    raise                # the run already failed elsewhere
                faults.restore_cache(cache, snap)
                faults.record_retry(f"chunk.{comp.name}", attempt, delay)
                time.sleep(delay)
                delay = min(delay * 2.0, faults.RETRY_BACKOFF_CAP_S)
                attempt += 1

    # -------------------------------------------------- §4.3 multithreading
    def _process_multithreaded(self, cache: SharedCache) -> List[SharedCache]:
        comp = self.comp
        t0 = time.perf_counter()
        faults.inject("chunk", component=comp.name, split=cache.split_index)
        ranges = cache.row_ranges(self.mt_threads)
        fn = comp.process_range
        if config.retry_max() > 0:
            # §4.3 row-range tasks are read-only over their range, so a
            # transient task failure retries in place without a snapshot
            fn = faults.with_retries(
                fn, max_retries=config.retry_max(),
                backoff=config.retry_backoff(),
                retry_on=(faults.TransientFault,) + (ConnectionError,
                                                     TimeoutError, OSError))
        futures = [self.pool.submit(fn, cache, r) for r in ranges]
        parts = [f.result() for f in futures]       # row-order synchronizer:
        out = comp.merge_ranges(cache, ranges, parts)   # merge in input order
        t1 = time.perf_counter()
        comp.busy_time += t1 - t0
        comp.calls += 1
        comp.rows_in += cache.n
        n_out = sum(c.n for c in out)
        comp.rows_out += n_out
        if obs_trace.ACTIVE.get():
            obs_trace.on_dispatch(comp.name, t0, t1, cache.split_index,
                                  cache.n, n_out, mt=len(ranges))
        return out


class TreePipeline:
    """Executes one execution tree over a stream of input splits."""

    def __init__(self, flow: Dataflow, tree: ExecutionTree,
                 tree_of: Dict[str, int],
                 deliver: DeliverFn,
                 mt_config: Optional[Dict[str, int]] = None,
                 pool: Optional[SharedWorkerPool] = None,
                 shared: bool = True,
                 abort: Optional[RunAbort] = None):
        self.flow = flow
        self.tree = tree
        self.tree_of = tree_of
        self.deliver = deliver
        self.mt_config = mt_config or {}
        self.pool = pool
        self.shared = shared
        self.abort = abort
        self.runners: Dict[str, ActivityRunner] = {
            n: ActivityRunner(flow.component(n), self.mt_config.get(n, 1),
                              pool, abort)
            for n in tree.members
        }
        self.errors: List[BaseException] = []

    # ------------------------------------------------------------- routing
    def _route(self, node: str, outs: List[SharedCache], split_index: int) -> None:
        succs = self.flow.succ(node)
        if not succs:
            return
        per_port = len(outs) == len(succs) and len(outs) > 1
        if per_port:
            for i, u in enumerate(succs):
                out = outs[i]
                out.split_index = split_index
                if self.tree_of.get(u) == self.tree.tree_id:
                    self._walk(u, out)
                else:
                    # tree -> tree transition: COPY edge (paper §4.1); the
                    # deliver fn may block on a bounded channel (backpressure)
                    copied = out.copy()
                    record_copy(out)
                    copied.split_index = split_index
                    self.deliver(u, copied, split_index, self.tree.tree_id)
            return
        out = outs[0]
        out.split_index = split_index
        # ONE intra-tree successor consumes the shared cache in place; every
        # other successor's copy is snapshotted BEFORE any in-place walk can
        # mutate it (a compacting Filter on the first branch must not drop
        # rows from its siblings' input)
        intra = [u for u in succs if self.tree_of.get(u) == self.tree.tree_id]
        in_place = intra[0] if intra else None
        handoff: List[SharedCache] = []
        original_used = False
        for u in succs:
            if u == in_place and not original_used:
                original_used = True
                handoff.append(out)
            else:
                branch = out.copy()       # unavoidable copy on fan-out
                record_copy(out)
                branch.split_index = split_index
                handoff.append(branch)
        for u, cache in zip(succs, handoff):
            if self.tree_of.get(u) == self.tree.tree_id:
                self._walk(u, cache)
                if cache is not out:
                    cache.recycle()
            else:
                self.deliver(u, cache, split_index, self.tree.tree_id)

    def _walk(self, node: str, cache: SharedCache) -> None:
        outs = self.runners[node].process(cache, shared=self.shared)
        self._route(node, outs, cache.split_index)

    def consume_at(self, node: str, cache: SharedCache) -> None:
        """Process one delivered cache starting at an arbitrary tree member
        (cross-tree deliveries that target a non-root member, e.g. a shared
        sink)."""
        self._walk(node, cache)

    def _consume(self, cache: SharedCache, process_root: bool) -> None:
        try:
            if process_root:
                self._walk(self.tree.root, cache)
            else:
                self._route(self.tree.root, [cache], cache.split_index)
            # the split has fully flowed through the tree (sinks snapshot,
            # cross-tree successors got copies): return its arena buffers
            cache.recycle()
        except BaseException as e:
            self.errors.append(e)
            # failure path: the split's arena buffers still go back exactly
            # once (recycle is idempotent — the owned-root swap hands them
            # over on the first call only), so an aborted run leaks nothing
            # and REPRO_CACHE_GUARD=1 sees no double release
            cache.recycle()
            if self.abort is not None:
                self.abort.trip(e)

    def _consume_task(self, cache: SharedCache, process_root: bool,
                      gate: AdmissionGate) -> None:
        try:
            if self.abort is not None and self.abort.aborted:
                return
            self._consume(cache, process_root)
        finally:
            gate.release()

    # ------------------------------------------------------------ execution
    def run(self, splits, m_prime: int, process_root: bool = False) -> None:
        """Pipeline-parallel: one consumer task per split on the shared pool,
        admission bounded to m' in flight (paper lines 13-21)."""
        if self.pool is None:
            # no pool (direct library use): degenerate to sequential
            return self.run_sequential(splits, process_root)
        gate = AdmissionGate(m_prime, self.abort)
        futures: List[TaskFuture] = []
        try:
            for sc in splits:                                 # line 16
                gate.acquire(self.pool)   # line 20: blocks at m' in flight
                futures.append(self.pool.submit(
                    self._consume_task, sc, process_root, gate))  # line 21
        finally:
            for f in futures:
                f.wait()
        if self.errors:
            raise self.errors[0]

    def run_sequential(self, splits, process_root: bool = False) -> None:
        """Non-pipeline fashion: each split flows through all activities
        before the next is admitted (the m'=1 degenerate case)."""
        for sc in splits:
            if self.abort is not None and self.abort.aborted:
                break
            self._consume(sc, process_root)
        if self.errors:
            raise self.errors[0]
