"""Pipelined host->device prefetch — Algorithm 2's BlockingQueue(m') applied
at the host/device boundary.

The producer thread runs the host ETL dataflow and stages ready batches in a
bounded queue (depth m'); the consumer (training loop) pops a batch while the
NEXT one is being produced — exactly the paper's pipeline consumer thread
protocol, with the device step playing the role of the downstream activity.
The trainer's ``stage_fn`` copies each batch to the card on the producer
thread.  (Host code, a copy of ``repro/data/prefetch.py``.)
"""
from __future__ import annotations

import queue
import threading
from typing import Any, Callable, Iterator, Optional

_EOS = object()


class PrefetchQueue:
    """Bounded producer/consumer staging queue (depth = pipeline degree m')."""

    def __init__(self, it: Iterator[Any], depth: int = 2,
                 stage_fn: Optional[Callable[[Any], Any]] = None):
        self.q: "queue.Queue" = queue.Queue(maxsize=max(1, depth))
        self.stage_fn = stage_fn
        self.error: Optional[BaseException] = None
        self._thread = threading.Thread(target=self._produce, args=(it,),
                                        daemon=True, name="prefetch")
        self._stop = threading.Event()
        self._thread.start()

    def _produce(self, it: Iterator[Any]) -> None:
        try:
            for item in it:
                if self._stop.is_set():
                    return
                if self.stage_fn is not None:
                    item = self.stage_fn(item)   # e.g. a copy to the card
                self.q.put(item)
        except BaseException as e:  # noqa: BLE001 — surfaced on next()
            self.error = e
        finally:
            self.q.put(_EOS)

    def __iter__(self):
        return self

    def __next__(self):
        item = self.q.get()
        if item is _EOS:
            if self.error is not None:
                raise self.error
            raise StopIteration
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
