"""Pipelined host->device prefetch — Algorithm 2's BlockingQueue(m') applied
at the host/device boundary.

The producer thread runs the host ETL dataflow and stages ready batches in a
bounded queue (depth m'); the consumer (training loop) pops a batch while the
NEXT one is being produced — exactly the paper's pipeline consumer thread
protocol, with the device step playing the role of the downstream activity.
The trainer's ``stage_fn`` copies each batch to the card on the producer
thread.  (Host code, a copy of ``repro/data/prefetch.py``.)

The producer runs under the creator's copied context, so the tracers in
scope where the queue was built see its spans: the pipeline's refills,
the ETL engine's own, and each batch's copy (``data.stage``, an ``h2d``
transfer).  The consumer's blocking get is the wait ``prefetch.get``.
Both carry ``batch``, the item's ordinal.
"""
from __future__ import annotations

import contextvars
import queue
import threading
import time
from typing import Any, Callable, Iterator, Optional

from ..obs import trace

_EOS = object()


def _nbytes(item: Any) -> int:
    """Bytes of a staged item: an array, or a dict of them."""
    if isinstance(item, dict):
        return sum(getattr(v, "nbytes", 0) for v in item.values())
    return getattr(item, "nbytes", 0)


class PrefetchQueue:
    """Bounded producer/consumer staging queue (depth = pipeline degree m')."""

    def __init__(self, it: Iterator[Any], depth: int = 2,
                 stage_fn: Optional[Callable[[Any], Any]] = None):
        self.q: "queue.Queue" = queue.Queue(maxsize=max(1, depth))
        self.stage_fn = stage_fn
        self.error: Optional[BaseException] = None
        self._taken = 0
        self._thread = threading.Thread(
            target=contextvars.copy_context().run, args=(self._produce, it),
            daemon=True, name="prefetch")
        self._stop = threading.Event()
        self._thread.start()

    def _produce(self, it: Iterator[Any]) -> None:
        try:
            for k, item in enumerate(it):
                if self._stop.is_set():
                    return
                if self.stage_fn is not None:
                    item = self._stage(item, k)
                self.q.put(item)
        except BaseException as e:  # noqa: BLE001 — surfaced on next()
            self.error = e
        finally:
            self.q.put(_EOS)

    def _stage(self, item: Any, k: int) -> Any:
        if not trace.ACTIVE.get():
            return self.stage_fn(item)   # e.g. a copy to the card
        t0 = time.perf_counter()
        item = self.stage_fn(item)
        trace.on_transfer("h2d", _nbytes(item), time.perf_counter() - t0,
                          name="data.stage", batch=k)
        return item

    def __iter__(self):
        return self

    def __next__(self):
        if trace.ACTIVE.get():
            depth, t0 = self.q.qsize(), time.perf_counter()
            item = self.q.get()
            trace.on_wait("prefetch.get", t0, time.perf_counter(),
                          batch=self._taken, depth=depth)
        else:
            item = self.q.get()
        if item is _EOS:
            if self.error is not None:
                raise self.error
            raise StopIteration
        self._taken += 1
        return item

    def close(self) -> None:
        """Stop the producer and wait for its thread to end: it finishes the
        item in hand, sees the stop and leaves (the queue is drained until
        then, so no put blocks it)."""
        self._stop.set()
        while self._thread.is_alive():
            try:
                self.q.get(timeout=0.05)
            except queue.Empty:
                pass
