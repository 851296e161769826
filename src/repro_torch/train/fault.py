"""Fault tolerance for 1000+-node deployments (host code, a copy of
``repro/train/fault.py``).

Three mechanisms (composable with the CheckpointManager):

1. ``with_retries`` — transient-failure retry with exponential backoff
   (preemptions, flaky interconnect RPCs, data-source hiccups).
2. ``StragglerWatchdog`` — per-step wall-time monitor.  In an SPMD job a
   straggling host stalls every step (collectives are synchronous), so
   persistent step-time inflation IS the straggler signal; the watchdog
   detects it (median × threshold over a sliding window) and fires a policy
   callback (alert / checkpoint-now / request re-shard).  The detection
   logic is hardware-independent and unit-tested with synthetic timings.
3. ``ElasticRunner`` — restart loop: on failure, restore the latest
   checkpoint onto the CURRENT device topology (possibly fewer/more hosts;
   the caller's ``restore`` places it) and continue.
"""
from __future__ import annotations

import collections
from dataclasses import dataclass
from typing import Any, Callable, List, Optional

import numpy as np

from ..core.faults import with_retries as _core_with_retries


def with_retries(fn: Callable, max_retries: int = 3, backoff: float = 0.1,
                 retry_on=(RuntimeError, OSError), on_retry=None):
    """Wrap fn with retry + exponential backoff.

    Thin shim over the generalized ``core.faults.with_retries`` (the
    dataflow engines' retry primitive), keeping this module's historical
    defaults (``retry_on=(RuntimeError, OSError)``)."""
    return _core_with_retries(fn, max_retries=max_retries, backoff=backoff,
                              retry_on=retry_on, on_retry=on_retry)


@dataclass
class StragglerEvent:
    step: int
    step_time: float
    median: float
    ratio: float


class StragglerWatchdog:
    """Sliding-window step-time monitor.

    ``threshold``: a step slower than threshold x running-median is a
    straggler suspicion; ``patience`` consecutive suspicions fire the
    policy (default: record only)."""

    def __init__(self, window: int = 32, threshold: float = 2.0,
                 patience: int = 3,
                 on_straggler: Optional[Callable[[StragglerEvent], None]] = None):
        self.window = window
        self.threshold = threshold
        self.patience = patience
        self.on_straggler = on_straggler
        self.times: collections.deque = collections.deque(maxlen=window)
        self.suspicions = 0
        self.events: List[StragglerEvent] = []

    def observe(self, step: int, step_time: float) -> Optional[StragglerEvent]:
        med = float(np.median(self.times)) if len(self.times) >= 4 else None
        self.times.append(step_time)
        if med is None or med <= 0:
            return None
        ratio = step_time / med
        if ratio > self.threshold:
            self.suspicions += 1
            if self.suspicions >= self.patience:
                ev = StragglerEvent(step, step_time, med, ratio)
                self.events.append(ev)
                if self.on_straggler is not None:
                    self.on_straggler(ev)
                self.suspicions = 0
                return ev
        else:
            self.suspicions = 0
        return None


class ElasticRunner:
    """Checkpoint-restart loop with topology-change tolerance.

    run(make_state, train_loop) calls ``train_loop(state, start_step)``;
    on an exception from ``recover_on`` it restores the newest checkpoint
    (resharded onto the current mesh by the caller-provided ``restore``)
    and retries, up to ``max_restarts``."""

    def __init__(self, restore: Callable[[], tuple], max_restarts: int = 3,
                 recover_on=(RuntimeError,)):
        self.restore = restore
        self.max_restarts = max_restarts
        self.recover_on = recover_on
        self.restarts = 0

    def run(self, train_loop: Callable[[Any, int], Any], init_state,
            start_step: int = 0):
        state, step = init_state, start_step
        while True:
            try:
                return train_loop(state, step)
            except self.recover_on as e:
                self.restarts += 1
                if self.restarts > self.max_restarts:
                    raise
                state, step = self.restore()
