"""Operator-backend interface + registry.

A ``Backend`` supplies the heavy per-operator kernels the ETL component
library dispatches through (`etl/components.py`):

    filter_mask          row predicate -> boolean keep-mask
    searchsorted_probe   dimension-table probe (sorted keys + searchsorted)
    lookup_gather        payload gather with unmatched-default substitution
    eval_expression      derived-column computation
    groupby_reduce       group-by aggregation (sum/avg/min/max/count)
    sort_rows            stable multi-key row ordering (lexsort)

plus the array plumbing the shared-cache layer needs (``asarray`` /
``to_host`` / ``concat``) and the sizing metadata the runtime planner uses
(``dtype_width`` / ``batch_align``).

Three ship: the ``numpy`` reference backend (bit-identical to the
historical inlined component code), the ``torch`` accelerated backend
(device-resident columns on CUDA, hand-written CUDA kernels) and
``torch_cpu``, the same backend pinned to the CPU with the kernels' plain
torch versions.  Selection order:

    OptimizeOptions(backend=...)  >  REPRO_BACKEND env var  >  "torch"

Backends are process-wide singletons created lazily: importing this module
touches no device, and only resolving ``torch`` needs a CUDA card.
"""
from __future__ import annotations

import threading
from typing import (Callable, Dict, List, Mapping, Optional, Sequence, Tuple,
                    TYPE_CHECKING)

import numpy as np

from .. import config

if TYPE_CHECKING:  # pragma: no cover
    from ..shared_cache import SharedCache

#: aggregation ops every backend must implement in groupby_reduce
AGG_OPS = ("sum", "avg", "min", "max", "count")

#: sentinel column a deferring fused segment leaves in its output cache: the
#: segment's combined keep-mask, NOT applied per chunk (that would force a
#: device->host sync every chunk).  The terminal ``Aggregate`` pops it after
#: the device-side concat and compacts the merged cache ONCE.  The name is
#: illegal as a user column (spaces), so it can never shadow real data.
SEGMENT_KEEP_MASK = "__segment keep mask__"

#: environment variable naming the default backend for the process
#: (typed accessor: ``core.config.backend_name``)
BACKEND_ENV_VAR = config.ENV_BACKEND

DEFAULT_BACKEND = "torch"


class Backend:
    """Abstract operator backend.  Subclasses implement the kernel set; the
    base class carries the sizing/precision metadata with safe defaults."""

    #: registry key ("numpy", "torch", ...)
    name: str = "abstract"
    #: planner hint: round source chunk sizes up to a multiple of this (the
    #: torch backend aligns so fused-segment staging layouts take few
    #: distinct sizes; 1 means no preference)
    batch_align: int = 1
    #: expected relative error of float aggregation vs a float64 oracle —
    #: engine-vs-oracle equality checks use this per-backend tolerance
    #: (float32 device accumulation cannot hit float64 exactness)
    oracle_rtol: float = 1e-9
    #: whether this backend's ``compile_segment`` runner honors
    #: ``FusedSegment.defer_cols`` — leaving the chunk uncompacted with a
    #: ``SEGMENT_KEEP_MASK`` column for the terminal Aggregate to apply once.
    #: Only meaningful for backends where an eager compact costs a
    #: device->host sync; host backends compact for free and ignore deferral.
    supports_segment_defer: bool = False

    # ------------------------------------------------------------ array ops
    def asarray(self, x) -> object:
        """Convert to this backend's native array type (may record a
        host->device transfer in CacheStats)."""
        raise NotImplementedError

    def to_host(self, x) -> np.ndarray:
        """Convert a backend array to numpy (may record device->host)."""
        raise NotImplementedError

    def concat(self, parts: Sequence) -> object:
        """Concatenate row-range outputs (the row-order synchronizer's merge
        step) into one backend-native column."""
        raise NotImplementedError

    # --------------------------------------------------------------- sizing
    def dtype_width(self, dtype) -> int:
        """Bytes per element this backend stores for ``dtype`` (device
        backends may canonicalize, e.g. 64-bit -> 32-bit)."""
        return int(np.dtype(dtype).itemsize)

    def est_nbytes(self, columns: Mapping[str, np.ndarray]) -> int:
        """Estimated bytes of a columnar table under this backend's dtype
        widths — feeds ``Component.est_output_bytes`` so ``plan_runtime``
        channel sizing stays correct when columns are device arrays.
        ``v.size`` (total elements) keeps multi-dimensional columns (e.g. a
        [n, doc_len] token table) counted in full."""
        return int(sum(self.dtype_width(v.dtype) * v.size
                       for v in columns.values()))

    # ------------------------------------------------------- operator kernels
    def filter_mask(self, predicate: Callable, cache: "SharedCache",
                    rows: slice):
        """Evaluate ``predicate(cache_view, rows)`` to a boolean keep-mask."""
        raise NotImplementedError

    def eval_expression(self, fn: Callable, cache: "SharedCache",
                        rows: slice):
        """Evaluate ``fn(cache_view, rows)`` to a derived column."""
        raise NotImplementedError

    def searchsorted_probe(self, dim, vals) -> Tuple[object, object]:
        """Probe a ``DimTable``: returns (row_idx, matched_mask)."""
        raise NotImplementedError

    def lookup_gather(self, dim, dim_col: str, idx, matched, default):
        """Gather a payload column at ``idx``; unmatched rows get
        ``default``."""
        raise NotImplementedError

    def groupby_reduce(self, keys: Sequence, values: Mapping[str, Tuple[object, str]],
                       n_rows: int) -> Tuple[List[object], Dict[str, object]]:
        """Group-by aggregation.  ``keys`` are the group-by columns (empty =>
        one global group over ``n_rows`` rows); ``values`` maps output name
        -> (value column, op) with op in AGG_OPS.  Returns (group key
        columns in lexicographic ascending group order, aggregate columns in
        the same group order)."""
        raise NotImplementedError

    def sort_rows(self, keys: Sequence, ascending: bool = True):
        """Stable multi-key row order (last key major — lexsort semantics on
        ``keys[::-1]``); returns the permutation index array."""
        raise NotImplementedError

    # ------------------------------------------------------- segment fusion
    def compile_segment(self, segment) -> Callable:
        """Compile a ``FusedSegment`` (a maximal row-synchronized chain of
        Filter/Expression/Lookup/Project/Converter activities) into ONE
        callable ``run(cache) -> None`` that mutates the shared cache in
        place exactly like running the chain component by component — but as
        a single backend dispatch per chunk.

        The base implementation is the loop-free composed host reference:
        each op is evaluated vectorized over the current row set with filter
        masks applied eagerly, so results are bit-identical to the unfused
        chain.  Accelerated backends override this with a device runner (the
        torch backend runs the whole segment on device: one h2d in, one d2h
        out per chunk).  The returned runner is cached on the segment by the
        component, so compilation happens once per (segment, backend)."""
        from ..shared_cache import record_segment_compile   # cycle-free
        ops = list(segment.ops)
        backend = self
        record_segment_compile()

        def run(cache) -> None:
            _run_segment_host(backend, ops, cache)
        return run

    def __repr__(self) -> str:
        return f"<{type(self).__name__} {self.name!r}>"


# ---------------------------------------------------------------------------
#  Composed host reference for fused segments
# ---------------------------------------------------------------------------
def segment_written_columns(ops) -> List[str]:
    """Columns a fused segment produces/overwrites, in last-write order —
    static analysis over the op list (no data needed)."""
    written: List[str] = []

    def note(name: str) -> None:
        if name in written:
            written.remove(name)
        written.append(name)

    for op in ops:
        kind = op[0]
        if kind == "expr":
            note(op[1])
        elif kind == "lookup":
            for out_name in op[3]:
                note(out_name)
            if op[5]:
                note(op[5])
        elif kind == "convert":
            for col in op[1]:
                note(col)
    return written


def segment_final_live(ops, initial_names) -> set:
    """The column set left visible after the segment runs over a cache that
    started with ``initial_names`` (Projects prune, everything else adds)."""
    live = set(initial_names)
    for op in ops:
        kind = op[0]
        if kind == "expr":
            live.add(op[1])
        elif kind == "lookup":
            live.update(op[3])
            if op[5]:
                live.add(op[5])
        elif kind == "convert":
            live.update(op[1])
        elif kind == "project":
            live &= set(op[1])
    return live
class SegmentEnv:
    """The cache-like view fused predicates/expressions evaluate against:
    ``col(name)`` returns the column's CURRENT value at this point of the
    segment (input column, or the output of an earlier fused op)."""

    __slots__ = ("_get", "_live", "n")

    def __init__(self, get: Callable[[str], object], live, n: int):
        self._get = get
        self._live = live
        self.n = n

    @property
    def names(self) -> List[str]:
        return list(self._live)

    def col(self, name: str):
        if name not in self._live:
            raise KeyError(
                f"column {name!r} is not visible at this point of the fused "
                f"segment (dropped by an earlier Project, or an undeclared "
                f"read — declare it via the component's reads=)")
        return self._get(name)


def _run_segment_host(bk: Backend, ops, cache) -> None:
    """Reference execution of a fused segment: one pass over the op list with
    vectorized numpy kernels, filter masks applied eagerly (so every op sees
    exactly the rows the unfused chain would), and a single write-back to the
    shared cache (one compact + the produced columns)."""
    n0 = cache.n
    env: Dict[str, np.ndarray] = {}          # materialized current values
    live = set(cache.names)                  # columns visible right now
    written: List[str] = []                  # produced/overwritten, in order
    sel: Optional[np.ndarray] = None         # surviving original-row indices
    n_cur = n0

    def get(name: str) -> np.ndarray:
        if name not in live:
            # same visibility rule the unfused chain enforces: a column
            # dropped by an earlier Project (or never present) must not be
            # silently resurrected from the underlying cache
            raise KeyError(
                f"column {name!r} is not visible at this point of the fused "
                f"segment (dropped by an earlier Project, or missing)")
        got = env.get(name)
        if got is None:
            got = bk.to_host(cache.col(name))
            if sel is not None:
                got = got[sel]
            env[name] = got
        return got

    def note_written(name: str) -> None:
        live.add(name)
        if name in written:
            written.remove(name)
        written.append(name)

    for op in ops:
        kind = op[0]
        view = SegmentEnv(get, live, n_cur)
        rows = slice(0, n_cur)
        if kind == "filter":
            mask = np.asarray(op[1](view, rows), dtype=bool)
            sel_new = np.flatnonzero(mask) if sel is None else sel[mask]
            for k in list(env):
                env[k] = env[k][mask]
            sel = sel_new
            n_cur = int(len(sel))
        elif kind == "expr":
            _, out_col, fn = op[0], op[1], op[2]
            env[out_col] = np.asarray(fn(view, rows))
            note_written(out_col)
        elif kind == "lookup":
            _, dim, key_col, return_cols, default, matched_flag = op
            idx, matched = bk.searchsorted_probe(dim, get(key_col))
            idx, matched = bk.to_host(idx), bk.to_host(matched)
            for out_name, dim_col in return_cols.items():
                env[out_name] = bk.to_host(
                    bk.lookup_gather(dim, dim_col, idx, matched, default))
                note_written(out_name)
            if matched_flag:
                env[matched_flag] = np.asarray(matched, dtype=bool)
                note_written(matched_flag)
        elif kind == "project":
            live = live & set(op[1])
            for k in list(env):
                if k not in live:
                    del env[k]
        elif kind == "convert":
            for col, dt in op[1].items():
                env[col] = get(col).astype(dt)
                note_written(col)
        else:  # pragma: no cover — op kinds are produced by segment_ops()
            raise ValueError(f"unknown segment op kind {kind!r}")

    # single write-back: one compact, then the produced columns, then the
    # final column set (Project) — same end state as the unfused chain
    if sel is not None:
        final_mask = np.zeros(n0, dtype=bool)
        final_mask[sel] = True
        cache.compact(final_mask)
    for name in written:
        if name in live:
            cache.add_column(name, env[name])
    if live != set(cache.names):
        cache.keep_columns([k for k in cache.names if k in live])


# ---------------------------------------------------------------------------
#  Registry
# ---------------------------------------------------------------------------
_lock = threading.Lock()
_factories: Dict[str, Callable[[], Backend]] = {}
_instances: Dict[str, Backend] = {}
_default_override: Optional[str] = None


def register_backend(name: str, factory: Callable[[], Backend]) -> None:
    """Register a backend factory (instantiated lazily, cached)."""
    with _lock:
        _factories[name] = factory
        _instances.pop(name, None)


def available_backends() -> List[str]:
    with _lock:
        return sorted(_factories)


def get_backend(name: str) -> Backend:
    """Resolve a backend by name (lazy singleton)."""
    with _lock:
        if name not in _factories:
            raise ValueError(
                f"unknown backend {name!r}; available: {sorted(_factories)}")
        inst = _instances.get(name)
        if inst is None:
            inst = _instances[name] = _factories[name]()
        return inst


def set_default_backend(name: Optional[str]) -> None:
    """Process-wide default override (None restores env/builtin order)."""
    global _default_override
    if name is not None:
        get_backend(name)                      # validate eagerly
    _default_override = name


def resolve_backend(name: Optional[str] = None) -> Backend:
    """Selection order: explicit ``name`` > set_default_backend override >
    ``REPRO_BACKEND`` env var > "torch"."""
    if name is None:
        name = (_default_override
                or config.backend_name()
                or DEFAULT_BACKEND)
    return get_backend(name)


def get_default_backend() -> Backend:
    return resolve_backend(None)
