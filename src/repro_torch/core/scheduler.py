"""Dataflow task planner (§2): when a dataflow is partitioned, the job is
generated into multiple tasks (one per execution tree) and the planner
executes them according to the dependency of the generated tasks.

Tree tasks run as coordination tasks on the run's shared ``SharedWorkerPool``
(executor.py) rather than a thread per tree.  Two gating modes:

- ``gate_on_upstream=True`` (the paper's semantics): a tree's task starts as
  soon as ALL upstream trees have finished — block / semi-block roots require
  the complete input.
- ``gate_on_upstream=False`` (streaming mode): every coordinator starts
  immediately; inter-tree dependencies are carried by the bounded split
  channels instead (closure of a channel == upstream completion), which is
  what lets row-synchronized stage boundaries overlap across trees.

Error handling: the first exception in any tree task trips the run-wide
``RunAbort`` — queued tasks are cancelled, blocked tasks wake and unwind —
and the ORIGINAL exception is re-raised promptly instead of being surfaced
only after every thread has joined.
"""
from __future__ import annotations

import threading
from typing import Callable, Dict, List, Optional

from .executor import RunAbort, SharedWorkerPool, TaskFuture
from .partitioner import ExecutionTree, ExecutionTreeGraph

RunTreeFn = Callable[[ExecutionTree], None]


def run_tree_graph(g_tau: ExecutionTreeGraph, run_tree: RunTreeFn,
                   concurrent: bool = True,
                   pool: Optional[SharedWorkerPool] = None,
                   abort: Optional[RunAbort] = None,
                   gate_on_upstream: bool = True) -> None:
    order = g_tau.topo_tree_order()
    if not concurrent:
        for tid in order:
            run_tree(g_tau.tree(tid))
        return

    own_pool = pool is None
    if own_pool:
        pool = SharedWorkerPool(width=max(2, len(order)),
                                name="tree-graph")
    if abort is None:
        abort = RunAbort()
    done: Dict[int, threading.Event] = {tid: threading.Event() for tid in order}
    # on abort, release every upstream waiter (they re-check abort right after)
    abort.subscribe(lambda: [evt.set() for evt in done.values()])

    def run_one(tid: int) -> None:
        try:
            if gate_on_upstream:
                for up in g_tau.upstream_trees(tid):
                    if not done[up].is_set():
                        with pool.blocking():
                            done[up].wait()
            abort.check()                       # cancelled while queued/gated
            run_tree(g_tau.tree(tid))
        except BaseException as e:  # noqa: BLE001 — recorded, re-raised below
            abort.trip(e)
        finally:
            done[tid].set()

    futures: List[TaskFuture] = [pool.submit(run_one, tid) for tid in order]
    try:
        for f in futures:
            f.wait()
    finally:
        if own_pool:
            pool.shutdown()
    if abort.aborted:
        raise abort.exc if abort.exc is not None else \
            RuntimeError("execution aborted")


def plan_schedule(g_tau: ExecutionTreeGraph) -> List[List[int]]:
    """Return the wave schedule: list of waves, each a list of tree ids that
    may run concurrently (all deps in earlier waves).  Raises ``ValueError``
    on a cyclic execution-tree graph."""
    remaining = {t.tree_id for t in g_tau.trees}
    waves: List[List[int]] = []
    finished: set = set()
    while remaining:
        wave = sorted(tid for tid in remaining
                      if all(up in finished for up in g_tau.upstream_trees(tid)))
        if not wave:
            raise ValueError("cycle in execution-tree graph")
        waves.append(wave)
        finished.update(wave)
        remaining.difference_update(wave)
    return waves
