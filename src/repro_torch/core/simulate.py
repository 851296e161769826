"""Discrete-event simulator for pipeline execution on a k-core machine.

On a host with fewer free cores than the paper's machine, the paper's
*parallel* speedups (Fig 12-14) cannot materialize in wall-clock.  The
simulator replays measured per-(activity, split) costs under the same
execution semantics as `core/pipeline.py` — grid-DAG precedence with list
scheduling on k cores — which is exactly the cost model Theorem 1 assumes.

Task (i, s) = activity i processing split s.  Precedence:
  (i-1, s): the split must have passed the previous activity;
  (i, s-1): an activity processes one split at a time, in order.
Admission: at most m' splits in flight (BlockingQueue(m')).
Contention model: when the in-flight thread count exceeds the core count,
each task pays a switching overhead `switch_cost * excess_threads` — the
mechanism the paper blames for the decline past 8 pipelines (§5.1).
"""
from __future__ import annotations

import heapq
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np


@dataclass
class SimResult:
    makespan: float
    sequential_time: float
    speedup: float
    core_busy: np.ndarray          # per-core busy seconds
    avg_cpu_usage: float           # mean utilization across cores


def simulate_tree(costs: np.ndarray, cores: int = 8,
                  m_prime: Optional[int] = None,
                  switch_cost: float = 0.0) -> SimResult:
    """Simulate pipeline execution of an execution tree.

    ``costs``: array [n_activities, m_splits] of seconds per task.
    ``m_prime``: admission bound (defaults to m_splits = paper's m=m' case).
    """
    costs = np.asarray(costs, dtype=np.float64)
    n, m = costs.shape
    if m_prime is None:
        m_prime = m
    m_prime = max(1, min(m_prime, m))

    seq_time = float(costs.sum())
    done = np.full((n, m), np.inf)
    # event heap of (time, kind, payload): core frees / split admitted
    core_free = [0.0] * cores          # availability time per core
    core_busy = np.zeros(cores)

    # split s can be admitted when at most m'-1 of splits < s are unfinished.
    # A split is finished when it clears the last activity.
    finish_split = np.full(m, np.inf)

    # schedule greedily in precedence order; contention via latest-available
    # core.  admit_time[s] = inf until the BlockingQueue slot opens: the
    # first m' splits are admitted at t=0, later ones when s-m' finishes.
    admit_time = np.full(m, np.inf)
    admit_time[:m_prime] = 0.0
    for s in range(m):
        if s >= m_prime:
            # wait for the (s - m')th in-flight split to finish
            admit_time[s] = np.partition(finish_split[:s], s - m_prime)[s - m_prime]
        for i in range(n):
            ready = admit_time[s]
            if i > 0:
                ready = max(ready, done[i - 1, s])
            if s > 0:
                ready = max(ready, done[i, s - 1])
            # live consumer threads at `ready`: splits admitted (queue slot
            # held) whose last activity has not finished — including those
            # still waiting for a busy activity (paper: blocked in wait())
            in_flight = int(np.sum((admit_time <= ready)
                                   & (finish_split > ready)))
            overhead = switch_cost * max(0, in_flight - cores)
            # earliest available core
            k = int(np.argmin(core_free))
            start = max(ready, core_free[k])
            dur = costs[i, s] + overhead
            done[i, s] = start + dur
            core_free[k] = done[i, s]
            core_busy[k] += dur
        finish_split[s] = done[n - 1, s]

    makespan = float(done[n - 1, :].max())
    usage = float(core_busy.sum() / (cores * makespan)) if makespan > 0 else 0.0
    return SimResult(makespan=makespan, sequential_time=seq_time,
                     speedup=seq_time / makespan if makespan > 0 else float("inf"),
                     core_busy=core_busy, avg_cpu_usage=usage)


def speedup_curve(per_activity_cost: Sequence[float], total_rows: int,
                  degrees: Sequence[int], cores: int = 8,
                  t0: float = 0.0, switch_cost: float = 0.0) -> Dict[int, float]:
    """Paper Fig-12-style curve: speedup vs number of pipelines (m = m').

    ``per_activity_cost``: net seconds per activity for the FULL input; each
    split of degree m costs net/m + t0 (the Theorem-1 linear model)."""
    out: Dict[int, float] = {}
    net = np.asarray(per_activity_cost, dtype=np.float64)
    for m in degrees:
        costs = np.tile((net / m + t0)[:, None], (1, m))
        res = simulate_tree(costs, cores=cores, m_prime=m,
                            switch_cost=switch_cost)
        # speedup vs the m=1 (non-pipeline) execution including misc time
        seq = float(net.sum() + t0 * len(net))
        out[m] = seq / res.makespan
    return out


def cpu_usage_curve(per_activity_cost: Sequence[float],
                    degrees: Sequence[int], cores: int = 8,
                    t0: float = 0.0, switch_cost: float = 0.0) -> Dict[int, float]:
    """Paper Fig-13-style curve: average CPU usage vs number of pipelines."""
    out: Dict[int, float] = {}
    net = np.asarray(per_activity_cost, dtype=np.float64)
    for m in degrees:
        costs = np.tile((net / m + t0)[:, None], (1, m))
        res = simulate_tree(costs, cores=cores, m_prime=m,
                            switch_cost=switch_cost)
        out[m] = res.avg_cpu_usage
    return out


def multithreading_curve(bottleneck_cost: float, other_cost: float,
                         thread_counts: Sequence[int], cores: int = 8,
                         parallel_fraction: float = 0.95,
                         switch_cost: float = 0.0) -> Dict[int, float]:
    """Paper Fig-14-style curve: inside-component multithreading speedup.
    Amdahl-style with core saturation and over-threading penalty."""
    out: Dict[int, float] = {}
    base = bottleneck_cost + other_cost
    for t in thread_counts:
        eff = min(t, cores)
        par = bottleneck_cost * parallel_fraction / eff
        ser = bottleneck_cost * (1 - parallel_fraction)
        penalty = switch_cost * max(0, t - cores) * bottleneck_cost
        out[t] = base / (par + ser + other_cost + penalty)
    return out
