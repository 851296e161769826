"""Metrics registry — counters / gauges / histograms for one traced run.

Each ``trace.Tracer`` owns one ``MetricsRegistry``; the instrumentation
hooks (``trace.on_transfer`` / ``on_copy`` / ``on_arena`` / ``on_dispatch``
/ ``on_wait`` / ``on_kernel``) increment it while the tracer's *measuring*
window is open.  The engines open that window exactly where they open
``cache_stats_scope``, so the counter family below reconciles EXACTLY with
the run's ``CacheStats`` snapshot — the same call sites feed both — and the
snapshot lands in ``EngineRun.metrics`` / ``MetadataStore.register_run`` /
``BENCH_<tag>.json``.

Everything here is stdlib-only (thread-safe via one lock per registry) and
JSON-safe via ``snapshot()``.
"""
from __future__ import annotations

import threading
from typing import Dict, List, Optional

#: histogram bucket upper bounds, in seconds (log2 from 1 µs to ~16 s);
#: observations above the last bound land in the +Inf overflow slot
_BUCKET_BOUNDS_S: List[float] = [1e-6 * (1 << k) for k in range(25)]


class Histogram:
    """Fixed log2-bucket latency histogram (seconds)."""

    __slots__ = ("count", "sum_s", "min_s", "max_s", "buckets", "overflow")

    def __init__(self) -> None:
        self.count = 0
        self.sum_s = 0.0
        self.min_s: Optional[float] = None
        self.max_s: Optional[float] = None
        self.buckets = [0] * len(_BUCKET_BOUNDS_S)
        self.overflow = 0

    def observe(self, seconds: float) -> None:
        self.count += 1
        self.sum_s += seconds
        self.min_s = seconds if self.min_s is None else min(self.min_s, seconds)
        self.max_s = seconds if self.max_s is None else max(self.max_s, seconds)
        for i, bound in enumerate(_BUCKET_BOUNDS_S):
            if seconds <= bound:
                self.buckets[i] += 1
                return
        self.overflow += 1

    def snapshot(self) -> dict:
        return {
            "count": self.count,
            "sum_s": self.sum_s,
            "min_s": self.min_s,
            "max_s": self.max_s,
            # sparse [le_us, count] pairs — only occupied buckets
            "buckets": [[round(b * 1e6, 3), n]
                        for b, n in zip(_BUCKET_BOUNDS_S, self.buckets) if n],
            "overflow": self.overflow,
        }


class MetricsRegistry:
    """Thread-safe named counters (monotonic adds), gauges (set / high-water)
    and latency histograms."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._counters: Dict[str, float] = {}
        self._gauges: Dict[str, float] = {}
        self._hists: Dict[str, Histogram] = {}

    # ----------------------------------------------------------- counters
    def inc(self, name: str, delta=1) -> None:
        with self._lock:
            self._counters[name] = self._counters.get(name, 0) + delta

    def counter(self, name: str):
        with self._lock:
            return self._counters.get(name, 0)

    # ------------------------------------------------------------- gauges
    def gauge_set(self, name: str, value) -> None:
        with self._lock:
            self._gauges[name] = value

    def gauge_max(self, name: str, value) -> None:
        """High-water gauge: keeps the maximum observed value."""
        with self._lock:
            cur = self._gauges.get(name)
            if cur is None or value > cur:
                self._gauges[name] = value

    # --------------------------------------------------------- histograms
    def observe(self, name: str, seconds: float) -> None:
        with self._lock:
            h = self._hists.get(name)
            if h is None:
                h = self._hists[name] = Histogram()
            h.observe(seconds)

    # ------------------------------------------------------------ exports
    def snapshot(self) -> dict:
        """JSON-safe {"counters", "gauges", "histograms"} snapshot."""
        with self._lock:
            return {
                "counters": dict(self._counters),
                "gauges": dict(self._gauges),
                "histograms": {k: h.snapshot() for k, h in self._hists.items()},
            }
