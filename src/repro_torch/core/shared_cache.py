"""Shared cache — the paper's §3 caching scheme.

A cache is a columnar row buffer (dict of equal-length arrays plus a
valid-row count).  The *shared caching scheme* means one cache object is
reused in place by every row-synchronized component of an execution tree:
components add/drop/overwrite columns and compact rows inside the same
object, so no output-cache -> input-cache copy ever happens.

The *ordinary* scheme (`copy()`) physically duplicates every column, which is
what the paper's baseline (Figure 3, "Copy") does on every edge.

Columns are host numpy arrays by default, but a cache may also hold
**device-resident columns** (``torch.Tensor``) produced by an accelerated
operator backend (`core/backend/`).  Device columns are treated as
immutable, so the in-place row mutators (``compact`` / ``take``) replace
those column objects functionally instead of writing into the buffer head;
host columns keep the historical in-place behaviour.  A tensor on the CPU
(the ``torch_cpu`` backend) is a device column too: it is never aliased with
a host buffer, because every host->device path here copies.  Every
device->host crossing made here is recorded in ``CacheStats`` — the
copy-cost analogue of §3 for the device tier.

Two cross-cutting services live here as well:

- ``CacheArena`` — a size-bucketed, thread-safe pool of recycled host column
  buffers.  ``SharedCache.copy``, ``concat_caches`` and the per-chunk source
  caches draw their buffers from the global arena and the executor returns
  them (``SharedCache.recycle``) once a split has fully flowed through its
  tree, so the steady state of a chunked run performs zero per-chunk host
  allocation.  Hit/miss/bytes-reused counters land in ``CacheStats``.
- **Scoped statistics** — ``cache_stats_scope`` opens a per-run
  ``CacheStats`` collector carried through ``contextvars`` (the shared
  worker pool propagates the context into its tasks), so concurrently
  benchmarked engines attribute copies/transfers/arena traffic to the right
  run instead of diffing the racy global counters.

Debug mode: ``REPRO_CACHE_GUARD=1`` enables the split-overlap check (see
``split``) and poisons released arena buffers with ``0xAB`` so any
use-after-recycle surfaces as loud data corruption instead of a silent
wrong answer.
"""
from __future__ import annotations

import contextvars
import sys
import threading
import time
from contextlib import contextmanager
from typing import Callable, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from . import config
from ..obs import trace as obs_trace

# a column is np.ndarray (host) or a device tensor (torch.Tensor)
Columns = Dict[str, np.ndarray]

#: host dtype -> the 32-bit dtype a device column stores (the reference's
#: device columns are 32-bit: 64-bit host columns narrow on upload)
_NARROW = {np.dtype(np.int64): np.dtype(np.int32),
           np.dtype(np.uint64): np.dtype(np.uint32),
           np.dtype(np.float64): np.dtype(np.float32),
           np.dtype(np.complex128): np.dtype(np.complex64)}


def device_dtype(dtype) -> np.dtype:
    """The dtype a host column of ``dtype`` has once it lives on device."""
    dt = np.dtype(dtype)
    return _NARROW.get(dt, dt)


def is_host_column(v) -> bool:
    """True for mutable host (numpy) columns; device columns are anything
    else array-like (immutable, updated functionally)."""
    return isinstance(v, np.ndarray)


def tensor_to_host(v: torch.Tensor) -> np.ndarray:
    """A host numpy copy of a tensor.  Always a copy: ``.numpy()`` of a CPU
    tensor aliases its storage, and host columns are mutated in place."""
    return v.detach().to("cpu", copy=True).numpy()


def host_to_device(a: np.ndarray, device) -> torch.Tensor:
    """A device copy of a host column in its device dtype (64-bit narrowed).
    Always a copy: on the CPU, ``torch.from_numpy`` and ``.to("cpu")`` alias
    the numpy buffer, which the CacheArena recycles."""
    a = np.ascontiguousarray(a, dtype=device_dtype(a.dtype))
    return torch.from_numpy(a).to(device, copy=True)


def _to_host(v) -> np.ndarray:
    """Materialize on host, recording the d2h transfer for device arrays."""
    if is_host_column(v):
        return v
    t0 = time.perf_counter() if obs_trace.ACTIVE.get() else 0.0
    out = tensor_to_host(v)
    record_transfer("d2h", out.nbytes,
                    seconds=(time.perf_counter() - t0) if t0 else 0.0)
    return out


def _index_on(vals: torch.Tensor, idx, idx_h: np.ndarray) -> torch.Tensor:
    """``idx`` as an index tensor on ``vals``' device: the caller's own
    tensor when it already lives there, else an upload of the host copy."""
    if isinstance(idx, torch.Tensor) and idx.device == vals.device:
        return idx
    return torch.from_numpy(np.ascontiguousarray(idx_h)).to(vals.device)


def cache_guard_enabled() -> bool:
    """True when ``REPRO_CACHE_GUARD=1``: split-overlap checks run and
    released arena buffers are poisoned (debug mode)."""
    return config.cache_guard_enabled()


def assert_views_disjoint(caches: List["SharedCache"]) -> None:
    """Debug-mode overlap check: the host-buffer byte ranges behind every
    column of the given caches must be pairwise disjoint.  ``split`` hands
    out *views* of the parent buffers; if two splits ever aliased the same
    bytes, an in-place mutation (a compacting Filter or a fused segment)
    would silently corrupt the sibling.  Raises ``RuntimeError`` naming the
    offending pair."""
    spans: Dict[str, List[Tuple[int, int, int]]] = {}
    for i, c in enumerate(caches):
        for name, v in c.columns.items():
            if not is_host_column(v) or v.nbytes == 0:
                continue
            ptr = v.__array_interface__["data"][0]
            spans.setdefault(name, []).append((ptr, ptr + v.nbytes, i))
    for name, sp in spans.items():
        sp.sort()
        for (a0, a1, i), (b0, b1, j) in zip(sp, sp[1:]):
            if b0 < a1:
                raise RuntimeError(
                    f"cache guard: splits #{i} and #{j} overlap on column "
                    f"{name!r} (byte ranges [{a0},{a1}) and [{b0},{b1}))")


class SharedCache:
    """Columnar row buffer that can be mutated in place.

    ``split_index`` tracks which horizontal split of the execution-tree input
    this cache carries (used by the row-order synchronizer to restore global
    row order at tree leaves).
    """

    __slots__ = ("columns", "n", "split_index", "copies", "lock", "version",
                 "_owned", "__weakref__")

    def __init__(self, columns: Optional[Columns] = None, n: Optional[int] = None,
                 split_index: int = 0):
        self.columns: Columns = dict(columns) if columns else {}
        if n is None:
            n = len(next(iter(self.columns.values()))) if self.columns else 0
        self.n = int(n)
        self.split_index = split_index
        self.copies = 0          # instrumentation: number of physical copies taken
        #: bumped on every mutation — device backends key cached device views
        #: of this cache on it, so a stale view is never reused
        self.version = 0
        #: root buffers drawn from the CacheArena that back this cache's host
        #: columns; returned to the pool by ``recycle()`` once the cache is
        #: consumed.  None for caches built over foreign/user arrays.
        self._owned: Optional[List[np.ndarray]] = None
        self.lock = threading.Lock()
        self._check()

    # ------------------------------------------------------------------ util
    def _check(self) -> None:
        for k, v in self.columns.items():
            if len(v) < self.n:
                raise ValueError(f"column {k!r} shorter ({len(v)}) than n={self.n}")

    @property
    def names(self) -> List[str]:
        return list(self.columns.keys())

    def nbytes(self) -> int:
        return sum(v[: self.n].nbytes for v in self.columns.values())

    def col(self, name: str):
        """Valid slice of a column (view, no copy)."""
        return self.columns[name][: self.n]

    def to_dict(self) -> Columns:
        """Materialized host dict of valid rows (copies — for sinks/tests)."""
        return {k: np.array(_to_host(v[: self.n]))
                for k, v in self.columns.items()}

    # --------------------------------------------------------- ordinary path
    def copy(self) -> "SharedCache":
        """Physical copy — the operation the shared caching scheme removes.
        Device columns are immutable, so sharing the same array IS a safe
        copy (copy-on-write); only host buffers are duplicated (drawn from
        the global ``CacheArena`` so the bytes are recycled, not freshly
        allocated, once the copy is consumed)."""
        cols: Columns = {}
        owned: List[np.ndarray] = []
        for k, v in self.columns.items():
            if is_host_column(v):
                arr, root = GLOBAL_ARENA.acquire_copy(v[: self.n])
                cols[k] = arr
                if root is not None:
                    owned.append(root)
            else:
                cols[k] = v[: self.n]
        out = SharedCache(cols, self.n, self.split_index)
        out._owned = owned or None
        self.copies += 1
        return out

    def recycle(self) -> None:
        """Return this cache's arena-owned host buffers to the pool.

        Call ONLY when the cache is fully consumed: its columns still view
        the returned buffers, so any later read observes whatever the next
        borrower wrote (under ``REPRO_CACHE_GUARD=1`` the bytes are poisoned
        with ``0xAB`` to make such misuse loud).  Idempotent; a no-op for
        caches that own no arena buffers (user caches, splits, snapshots)."""
        owned, self._owned = self._owned, None
        if owned:
            for root in owned:
                GLOBAL_ARENA.release(root)

    # ------------------------------------------------------- in-place mutators
    def add_column(self, name: str, values) -> None:
        if len(values) < self.n:
            raise ValueError(f"add_column {name!r}: {len(values)} < n={self.n}")
        self.columns[name] = values
        self.version += 1

    def drop_columns(self, names) -> None:
        for name in names:
            self.columns.pop(name, None)
        self.version += 1

    def keep_columns(self, names) -> None:
        names = set(names)
        for k in list(self.columns.keys()):
            if k not in names:
                del self.columns[k]
        self.version += 1

    def compact(self, mask) -> None:
        """Keep rows where ``mask`` is True, in place (row filter)."""
        if mask.dtype not in (np.bool_, torch.bool):
            raise TypeError("compact expects a boolean mask")
        if len(mask) < self.n:
            raise ValueError("mask shorter than valid rows")
        mask_h = _to_host(mask)[: self.n]
        k = int(mask_h.sum())
        for name, vals in self.columns.items():
            if is_host_column(vals):
                # write the surviving rows into the head of the SAME buffer
                vals[:k] = vals[: self.n][mask_h]
            else:
                # device column: immutable — replace functionally
                m = _index_on(vals, mask, mask_h)[: self.n]
                self.columns[name] = vals[: self.n][m]
        self.n = k
        self.version += 1

    def take(self, idx) -> None:
        """Reorder/select rows by integer index, in place.

        ``idx`` must address the valid row window ``[0, n)`` (negative
        indices count from ``n``).  It may contain duplicates and be LONGER
        than ``n``; a host buffer too small for the gather is grown by
        allocating a fresh buffer explicitly (never by silently writing into
        the stale tail beyond the valid window)."""
        if isinstance(idx, (list, tuple)):
            idx = np.asarray(idx)
        idx_h = _to_host(idx)
        if idx_h.dtype == np.bool_:
            raise TypeError("take expects integer indices (use compact for "
                            "boolean masks)")
        k = len(idx_h)
        if k:
            lo, hi = int(idx_h.min()), int(idx_h.max())
            if lo < -self.n or hi >= self.n:
                raise IndexError(
                    f"take: index range [{lo}, {hi}] outside the valid row "
                    f"window [0, {self.n})")
        for name, vals in self.columns.items():
            if not is_host_column(vals):
                self.columns[name] = vals[: self.n][
                    _index_on(vals, idx, idx_h).long()]
                continue
            gathered = vals[: self.n][idx_h]     # fancy index: fresh array
            if k <= self.n:
                vals[:k] = gathered
            else:
                # gather larger than the valid window: grow explicitly with a
                # fresh buffer instead of overwriting the stale tail
                self.columns[name] = gathered
        self.n = k
        self.version += 1

    def truncate(self, n: int) -> None:
        self.n = min(self.n, int(n))
        self.version += 1

    # ----------------------------------------------------------- partitioning
    def split(self, m: int) -> List["SharedCache"]:
        """Horizontally partition into ``m`` even splits (views, zero copy).

        ALIASING CONTRACT: each split's host columns are *views* of this
        cache's buffers over disjoint, contiguous row ranges — no bytes are
        copied.  A split may therefore be mutated in place (compact / take /
        a fused segment) only within its own range, which the in-place
        mutators guarantee by construction; the parent must outlive its
        splits and must not be recycled while any split is in flight.  Under
        ``REPRO_CACHE_GUARD=1`` the handed-out views are checked for pairwise
        byte-range overlap so a bounds-computation bug can never silently
        corrupt a sibling split."""
        m = max(1, min(m, max(self.n, 1)))
        bounds = np.linspace(0, self.n, m + 1).astype(np.int64)
        out = []
        for i in range(m):
            lo, hi = int(bounds[i]), int(bounds[i + 1])
            out.append(SharedCache({k: v[lo:hi] for k, v in self.columns.items()},
                                   hi - lo, split_index=i))
        if cache_guard_enabled():
            assert_views_disjoint(out)
        return out

    def row_ranges(self, t: int) -> List[slice]:
        """Even row ranges for inside-component parallelization."""
        t = max(1, min(t, max(self.n, 1)))
        bounds = np.linspace(0, self.n, t + 1).astype(np.int64)
        return [slice(int(bounds[i]), int(bounds[i + 1])) for i in range(t)]

    def __len__(self) -> int:
        return self.n

    def __repr__(self) -> str:
        return f"SharedCache(n={self.n}, cols={self.names}, split={self.split_index})"


def _concat_column(parts: List):
    """Concatenate column parts, staying on device if any part lives there."""
    if all(is_host_column(p) for p in parts):
        return np.concatenate(parts)
    device = next(p.device for p in parts if not is_host_column(p))
    for p in parts:
        if is_host_column(p):
            record_transfer("h2d", p.nbytes)
    # host parts are copied up (host_to_device never aliases): the input
    # caches' arena buffers are recycled right after this merge
    return torch.cat([p if not is_host_column(p)
                      else host_to_device(p, device) for p in parts])


def _concat_column_arena(parts: List, owned: List[np.ndarray]):
    """Host concat into an arena buffer when the parts agree on dtype and
    trailing shape; falls back to ``_concat_column`` otherwise."""
    if (all(is_host_column(p) for p in parts)
            and len({p.dtype for p in parts}) == 1
            and len({p.shape[1:] for p in parts}) == 1):
        total = sum(len(p) for p in parts)
        arr, root = GLOBAL_ARENA.acquire(parts[0].dtype,
                                         (total,) + parts[0].shape[1:])
        off = 0
        for p in parts:
            arr[off:off + len(p)] = p
            off += len(p)
        if root is not None:
            owned.append(root)
        return arr
    return _concat_column(parts)


def concat_caches(caches: List[SharedCache], ordered: bool = True,
                  recycle_inputs: bool = False) -> SharedCache:
    """Row-order synchronizer: merge caches back into one, restoring the
    original split order (paper §4.3 — 'maintains the row order of the output
    to be the same of the input').

    All caches must carry the same column set; a mismatch raises a
    ``ValueError`` naming the offending cache and columns instead of
    ``KeyError``-ing on the first cache's schema.

    The merged host columns are drawn from the global ``CacheArena``.  With
    ``recycle_inputs=True`` the caller hands over ownership of the parts:
    their arena buffers are recycled after the rows are copied out, so the
    inputs must not be read again (the engine's block/semi-block ``finish``
    paths, whose accumulated state is discarded afterwards).  The default
    leaves the inputs untouched — safe for callers that keep them."""
    caches = [c for c in caches if c is not None]
    if not caches:
        return SharedCache({}, 0)
    if ordered:
        caches = sorted(caches, key=lambda c: c.split_index)
    names = caches[0].names
    expected = set(names)
    for i, c in enumerate(caches[1:], start=1):
        got = set(c.names)
        if got != expected:
            missing = sorted(expected - got)
            extra = sorted(got - expected)
            detail = []
            if missing:
                detail.append(f"missing {missing}")
            if extra:
                detail.append(f"unexpected {extra}")
            raise ValueError(
                f"concat_caches: cache #{i} (split {c.split_index}) column "
                f"set differs from cache #0 (split {caches[0].split_index}): "
                + ", ".join(detail))
    owned: List[np.ndarray] = []
    cols = {k: _concat_column_arena([c.col(k) for c in caches], owned)
            for k in names}
    out = SharedCache(cols, sum(c.n for c in caches))
    out._owned = owned or None
    if recycle_inputs:
        for c in caches:
            c.recycle()
    return out


class CacheStats:
    """Instrumentation for copies / bytes moved (thread-safe).

    Besides host-side cache copies (the paper's §3 metric), tracks explicit
    host<->device transfers made by accelerated operator backends — the
    copy-cost analogue for the device tier — plus ``CacheArena`` buffer
    recycling (hits / misses / bytes served from the pool).

    One process-wide instance (``GLOBAL_CACHE_STATS``) always records; a
    per-run collector opened with ``cache_stats_scope`` records the same
    events for exact per-run attribution."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self.copies = 0
        self.bytes_copied = 0
        self.h2d_transfers = 0
        self.h2d_bytes = 0
        self.d2h_transfers = 0
        self.d2h_bytes = 0
        self.arena_hits = 0
        self.arena_misses = 0
        self.arena_bytes_reused = 0
        self.dim_h2d_transfers = 0
        self.dim_h2d_bytes = 0
        self.segment_compiles = 0
        self.retries = 0
        self.degradations = 0
        self.faults_injected = 0

    def record(self, cache: SharedCache) -> None:
        with self._lock:
            self.copies += 1
            self.bytes_copied += cache.nbytes()

    def record_transfer(self, direction: str, nbytes: int) -> None:
        with self._lock:
            if direction == "h2d":
                self.h2d_transfers += 1
                self.h2d_bytes += int(nbytes)
            elif direction == "d2h":
                self.d2h_transfers += 1
                self.d2h_bytes += int(nbytes)
            else:
                raise ValueError(f"unknown transfer direction {direction!r}")

    def record_arena(self, hit: bool, nbytes: int) -> None:
        with self._lock:
            if hit:
                self.arena_hits += 1
                self.arena_bytes_reused += int(nbytes)
            else:
                self.arena_misses += 1

    def record_dim_upload(self, nbytes: int) -> None:
        """A dimension-table device upload (keys/payload/hash build).  Also
        recorded as a plain h2d transfer by the backend's ``asarray`` — this
        counter isolates the dim-table share so a resident serving session
        can assert warm ticks re-upload nothing."""
        with self._lock:
            self.dim_h2d_transfers += 1
            self.dim_h2d_bytes += int(nbytes)

    def record_segment_compile(self) -> None:
        """A fused-segment kernel compile: composing the host runner, or a
        jit trace of a new (bucket, column-layout) shape on an accelerated
        backend.  Warm serving ticks must record zero of these."""
        with self._lock:
            self.segment_compiles += 1

    def record_retry(self) -> None:
        """A transient failure retried (chunk replay, run re-execution, or
        serve-tick retry).  No-fault runs must record zero of these."""
        with self._lock:
            self.retries += 1

    def record_degradation(self) -> None:
        """A degradation ladder fell back one rung (segment/join/groupby
        route, or arena over-budget to direct allocation)."""
        with self._lock:
            self.degradations += 1

    def record_fault(self) -> None:
        """An injected fault fired (``core.faults``)."""
        with self._lock:
            self.faults_injected += 1

    def reset(self) -> None:
        with self._lock:
            self.copies = 0
            self.bytes_copied = 0
            self.h2d_transfers = 0
            self.h2d_bytes = 0
            self.d2h_transfers = 0
            self.d2h_bytes = 0
            self.arena_hits = 0
            self.arena_misses = 0
            self.arena_bytes_reused = 0
            self.dim_h2d_transfers = 0
            self.dim_h2d_bytes = 0
            self.segment_compiles = 0
            self.retries = 0
            self.degradations = 0
            self.faults_injected = 0

    def snapshot(self):
        with self._lock:
            return {"copies": self.copies, "bytes_copied": self.bytes_copied,
                    "h2d_transfers": self.h2d_transfers,
                    "h2d_bytes": self.h2d_bytes,
                    "d2h_transfers": self.d2h_transfers,
                    "d2h_bytes": self.d2h_bytes,
                    "arena_hits": self.arena_hits,
                    "arena_misses": self.arena_misses,
                    "arena_bytes_reused": self.arena_bytes_reused,
                    "dim_h2d_transfers": self.dim_h2d_transfers,
                    "dim_h2d_bytes": self.dim_h2d_bytes,
                    "segment_compiles": self.segment_compiles,
                    "retries": self.retries,
                    "degradations": self.degradations,
                    "faults_injected": self.faults_injected}


GLOBAL_CACHE_STATS = CacheStats()

# ---------------------------------------------------------------------------
#  Scoped (per-run) statistics
# ---------------------------------------------------------------------------
#: active per-run collectors; carried through contextvars so the shared
#: worker pool propagates a run's scope into its tasks (see
#: SharedWorkerPool.submit) and concurrent engines never cross-attribute
_STATS_SCOPES: "contextvars.ContextVar[tuple]" = contextvars.ContextVar(
    "repro_cache_stats_scopes", default=())


@contextmanager
def cache_stats_scope(stats: Optional[CacheStats] = None):
    """Open a per-run ``CacheStats`` collector.  Every copy / transfer /
    arena event recorded while the scope is active (including on worker-pool
    tasks submitted under it) lands in the yielded collector as well as in
    ``GLOBAL_CACHE_STATS``.  Scopes nest: a benchmark section scope and the
    engine's own run scope both see the run's events."""
    s = stats if stats is not None else CacheStats()
    token = _STATS_SCOPES.set(_STATS_SCOPES.get() + (s,))
    try:
        yield s
    finally:
        _STATS_SCOPES.reset(token)


def _all_stats():
    return (GLOBAL_CACHE_STATS,) + _STATS_SCOPES.get()


def absorb_external(snap: dict) -> None:
    """Fold a ``CacheStats.snapshot()`` measured in another process (a
    process-route shard worker) into the global collector and every active
    scope, so child-process copies/transfers stay visible to run- and
    benchmark-level attribution exactly as in-process work does."""
    for s in _all_stats():
        with s._lock:
            for k, v in snap.items():
                if v:
                    setattr(s, k, getattr(s, k) + int(v))


def record_copy(cache: SharedCache) -> None:
    """Record one physical cache copy in the global and scoped collectors
    (and, under an active trace scope, as an ``obs`` event + metric)."""
    for s in _all_stats():
        s.record(cache)
    if obs_trace.ACTIVE.get():
        obs_trace.on_copy(cache.nbytes())


def record_transfer(direction: str, nbytes: int, seconds: float = 0.0) -> None:
    """Record one host<->device transfer in the global + scoped collectors.
    ``seconds`` is the measured copy duration where the caller timed it —
    trace spans get a real width, ``CacheStats`` ignores it.  This funnel is
    the single source for both ``CacheStats`` and the ``obs`` tracer, which
    is what makes their transfer counters reconcile exactly."""
    for s in _all_stats():
        s.record_transfer(direction, nbytes)
    if obs_trace.ACTIVE.get():
        obs_trace.on_transfer(direction, nbytes, seconds)


def _record_arena(hit: bool, nbytes: int) -> None:
    for s in _all_stats():
        s.record_arena(hit, nbytes)
    if obs_trace.ACTIVE.get():
        obs_trace.on_arena(hit, nbytes)


def record_dim_upload(nbytes: int) -> None:
    """Record one dimension-table device upload (in ADDITION to the h2d
    transfer the backend's ``asarray`` records for the same bytes)."""
    for s in _all_stats():
        s.record_dim_upload(nbytes)


def record_segment_compile() -> None:
    """Record one fused-segment kernel compile / new-layout jit trace."""
    for s in _all_stats():
        s.record_segment_compile()


# ---------------------------------------------------------------------------
#  CacheArena — recycled host column buffers
# ---------------------------------------------------------------------------
#: smallest pooled bucket; requests below it still round up to this
_ARENA_MIN_BUCKET = 256


def _faults_active() -> bool:
    """True when any fault plan is installed.  Import-cycle-safe: the faults
    module imports us, so scope-installed plans are only checked when it is
    already loaded (a plan cannot exist otherwise)."""
    if config.faults_spec() is not None:
        return True
    mod = sys.modules.get(__package__ + ".faults")
    return mod is not None and bool(mod._SCOPES.get())


class CacheArena:
    """Size-bucketed, thread-safe pool of recycled host column buffers.

    ``acquire`` returns a correctly-typed array *view* over a pow2-sized
    ``uint8`` root buffer (popped from the pool on a hit, freshly allocated
    on a miss) together with that root; callers record roots on the caches
    they build (``SharedCache._owned``) and hand them back via
    ``SharedCache.recycle`` / ``release`` once the cache is consumed.  Pooled
    bytes are capped (``REPRO_ARENA_MAX_MB``, default 256) — releases beyond
    the cap simply drop the buffer to the GC.

    ``REPRO_ARENA=0`` disables pooling entirely: ``acquire`` falls back to
    plain allocation and hands back no root, so every release is a no-op.
    Under ``REPRO_CACHE_GUARD=1`` released buffers are poisoned with ``0xAB``
    and a double release raises instead of being ignored."""

    def __init__(self, max_bytes: Optional[int] = None,
                 enabled: Optional[bool] = None):
        if enabled is None:
            enabled = config.arena_enabled()
        if max_bytes is None:
            max_bytes = config.arena_max_bytes()
        self.enabled = bool(enabled)
        self.max_bytes = int(max_bytes)
        self._lock = threading.Lock()
        self._pools: Dict[int, List[np.ndarray]] = {}
        self._pooled_bytes = 0
        self._pooled_ids: set = set()

    @staticmethod
    def _bucket(nbytes: int) -> int:
        b = _ARENA_MIN_BUCKET
        while b < nbytes:
            b <<= 1
        return b

    # ------------------------------------------------------------------ API
    def acquire(self, dtype, shape) -> Tuple[np.ndarray, Optional[np.ndarray]]:
        """Borrow a ``(view, root)`` pair for an array of ``dtype``/``shape``.
        ``root`` is None when pooling is disabled (nothing to give back)."""
        dtype = np.dtype(dtype)
        if not isinstance(shape, (tuple, list)):
            shape = (shape,)
        shape = tuple(int(s) for s in shape)
        if not self.enabled:
            return np.empty(shape, dtype), None
        if _faults_active():
            # injected over-budget condition: degrade to direct allocation
            # (root=None => the release path is a no-op) instead of raising
            from . import faults as _faults       # lazy: faults imports us
            try:
                _faults.inject("arena", component="acquire")
            except _faults.FaultError as e:
                _faults.record_degradation("arena", src="pooled",
                                           dst="direct", error=repr(e))
                return np.empty(shape, dtype), None
        nbytes = int(np.prod(shape, dtype=np.int64)) * dtype.itemsize \
            if shape else dtype.itemsize
        bucket = self._bucket(nbytes)
        root = None
        with self._lock:
            pool = self._pools.get(bucket)
            if pool:
                root = pool.pop()
                self._pooled_bytes -= bucket
                self._pooled_ids.discard(id(root))
        if root is None:
            root = np.empty(bucket, np.uint8)
            _record_arena(False, nbytes)
        else:
            _record_arena(True, nbytes)
        return root[:nbytes].view(dtype).reshape(shape), root

    def acquire_like(self, arr) -> Tuple[np.ndarray, Optional[np.ndarray]]:
        return self.acquire(arr.dtype, arr.shape)

    def acquire_copy(self, src: np.ndarray) -> Tuple[np.ndarray,
                                                     Optional[np.ndarray]]:
        """Borrow a buffer shaped/typed like ``src`` with its rows copied in
        — the one pattern every arena-backed cache builder uses."""
        arr, root = self.acquire(src.dtype, src.shape)
        np.copyto(arr, src)
        return arr, root

    def release(self, root: Optional[np.ndarray]) -> None:
        """Return a root buffer to the pool.  Non-arena arrays (wrong dtype /
        shape / non-owning) are ignored, so callers may pass anything they
        recorded without re-checking provenance."""
        if root is None or not self.enabled:
            return
        if not (isinstance(root, np.ndarray) and root.dtype == np.uint8
                and root.ndim == 1 and root.flags["OWNDATA"]):
            return
        bucket = root.nbytes
        if bucket < _ARENA_MIN_BUCKET or bucket & (bucket - 1):
            return                       # not one of our pow2 buckets
        guard = cache_guard_enabled()
        with self._lock:
            if id(root) in self._pooled_ids:
                if guard:
                    raise RuntimeError("CacheArena: double release of the "
                                       "same buffer")
                return
            if self._pooled_bytes + bucket > self.max_bytes:
                return                   # over budget: drop to the GC
            if guard:
                root.fill(0xAB)          # poison: use-after-recycle is loud
            self._pools.setdefault(bucket, []).append(root)
            self._pooled_bytes += bucket
            self._pooled_ids.add(id(root))
        # the trace event only AFTER the buffer is actually accepted into the
        # pool: a rejected release (double release, over budget, foreign
        # buffer) must not inflate another run's arena-release accounting
        if obs_trace.ACTIVE.get():
            obs_trace.on_arena_release(bucket)

    # -------------------------------------------------------------- observe
    @property
    def pooled_bytes(self) -> int:
        with self._lock:
            return self._pooled_bytes

    def pooled_buffers(self) -> int:
        with self._lock:
            return sum(len(p) for p in self._pools.values())

    def clear(self) -> None:
        with self._lock:
            self._pools.clear()
            self._pooled_bytes = 0
            self._pooled_ids.clear()


GLOBAL_ARENA = CacheArena()
