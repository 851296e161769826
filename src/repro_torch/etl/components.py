"""ETL component library over columnar numpy row sets.

Component classification follows the paper's §3:
  row-synchronized: Filter, Lookup, Project, Expression, Converter, Splitter
  block:            Aggregate, Sort
  semi-block:       Union, Merge
  plus ArraySource / CollectSink / FileSink.

Row-synchronized components mutate the shared cache IN PLACE (shared caching
scheme).  Heavy row-synchronized components (Filter/Lookup/Expression)
implement `process_range` + `merge_ranges` for §4.3 inside-component
multithreading with a row-order synchronizer.

Heavy components do not inline their kernels: they dispatch through the
active operator backend (``core/backend/``) — ``numpy`` reference or
``torch`` accelerated — via ``Component.get_backend()``.  Engines assign the
run's backend on every component before executing.

Predicates and derived-column expressions are preferably **column-expression
AST nodes** (``core/expr.py``): their read sets are derived from the AST, so
the optimizer's commute/fusion rules and the fused-kernel upload sets get
exact provenance.  Legacy ``fn(cache, rows)`` callables still work as a
deprecated shim — without a ``reads=`` declaration they emit a
``DeprecationWarning`` and opt out of every provenance-driven rewrite.
"""
from __future__ import annotations

import threading
import time
import warnings
from typing import (Callable, Dict, FrozenSet, Iterator, List, Optional,
                    Sequence, Tuple, Union)

import numpy as np

from ..core import faults
from ..core.backend import AGG_OPS, SEGMENT_KEEP_MASK
from ..core.component import (BlockComponent, Component, ComponentType,
                              SemiBlockComponent, SinkComponent,
                              SourceComponent)
from ..core.expr import Col, Expr, cast, expr_reads
from ..core.shared_cache import GLOBAL_ARENA, SharedCache, concat_caches
from ..obs import trace as obs_trace

ColumnRef = Union[str, Col]


def _col_name(ref: ColumnRef) -> str:
    """Column arguments accept a plain name or a DSL ``col()`` reference.
    Composite expressions are rejected — materialize them with an
    ``Expression`` (``FlowBuilder.derive``) first."""
    if isinstance(ref, Col):
        return ref.name
    if isinstance(ref, Expr):
        raise TypeError(
            f"{ref!r} is a composite expression; only bare col() references "
            f"name a column here — derive() it into a column first")
    if isinstance(ref, str):
        return ref
    raise TypeError(f"expected a column name or col() reference, got {ref!r}")


def _resolve_reads(fn, reads: Optional[Sequence[str]], owner: str,
                   kind: str) -> Optional[FrozenSet[str]]:
    """The declared read set of a predicate/expression.

    DSL ``Expr`` nodes derive it exactly from the AST (a conflicting manual
    ``reads=`` raises — the declaration would otherwise silently drift from
    the truth).  Legacy callables keep their hand-declared ``reads=``; a
    callable WITHOUT one gets a ``DeprecationWarning`` naming the DSL
    replacement, because ``None`` silently opts the component out of
    filter-commute, segment fusion and the minimal device upload set."""
    if isinstance(fn, Expr):
        derived = expr_reads(fn)
        if reads is not None and frozenset(reads) != derived:
            raise ValueError(
                f"{kind} {owner!r}: reads={sorted(reads)} conflicts with the "
                f"expression's derived read set {sorted(derived)} — drop the "
                f"reads= argument (provenance is derived from the AST)")
        return derived
    if reads is None:
        warnings.warn(
            f"{kind} {owner!r}: opaque callable without reads= — the "
            f"optimizer and fused kernels cannot see its column provenance, "
            f"so every provenance-driven rewrite refuses.  Build the "
            f"predicate/expression with the repro_torch.col() DSL (exact derived "
            f"reads), or declare reads= explicitly.",
            DeprecationWarning, stacklevel=3)
        return None
    return frozenset(reads)


# ---------------------------------------------------------------------------
#  Sources
# ---------------------------------------------------------------------------
class ArraySource(SourceComponent):
    """In-memory columnar table source; yields chunked caches (views)."""

    def __init__(self, name: str, columns: Dict[str, np.ndarray]):
        super().__init__(name)
        lens = {len(v) for v in columns.values()}
        if len(lens) > 1:
            raise ValueError("ragged source columns")
        self.columns = columns
        self._n = lens.pop() if lens else 0

    def total_rows(self) -> int:
        return self._n

    def output_schema(self, incols: FrozenSet[str]) -> FrozenSet[str]:
        return frozenset(self.columns)

    def est_output_bytes(self) -> int:
        """Cache-size metadata for the runtime planner (channel sizing),
        computed with the active backend's dtype widths so the estimate stays
        correct when columns live on device (e.g. 64-bit host columns
        narrowed to 32-bit device tensors)."""
        return self.get_backend().est_nbytes(self.columns)

    def set_data(self, columns: Dict[str, np.ndarray]) -> None:
        """Swap the table this source emits — the serving loop's feed point.
        The column SET must match the original schema (runtime plans and
        compiled segment kernels are built against it); the row count may
        change freely between ticks."""
        if set(columns) != set(self.columns):
            missing = sorted(set(self.columns) - set(columns))
            extra = sorted(set(columns) - set(self.columns))
            raise ValueError(
                f"source {self.name!r}: tick columns do not match the "
                f"declared schema (missing {missing}, unexpected {extra})")
        lens = {len(v) for v in columns.values()}
        if len(lens) > 1:
            raise ValueError("ragged source columns")
        self.columns = dict(columns)
        self._n = lens.pop() if lens else 0

    def chunks(self, chunk_rows: int) -> Iterator[SharedCache]:
        i = 0
        idx = 0
        while i < self._n:
            j = min(i + chunk_rows, self._n)
            # a chunk view is the root output split; downstream mutators
            # compact/overwrite in place, so materialize the chunk buffer
            # once — drawn from the CacheArena, so the steady state of a
            # chunked run recycles the same few buffers (zero per-chunk
            # allocation) once the executor returns consumed splits
            cols: Dict[str, np.ndarray] = {}
            owned = []
            for k, v in self.columns.items():
                arr, root = GLOBAL_ARENA.acquire_copy(v[i:j])
                cols[k] = arr
                if root is not None:
                    owned.append(root)
            cache = SharedCache(cols, j - i, split_index=idx)
            cache._owned = owned or None
            self.rows_out += j - i
            yield cache
            i = j
            idx += 1


# ---------------------------------------------------------------------------
#  Row-synchronized components
# ---------------------------------------------------------------------------
class RowSyncMT(Component):
    """Base for row-sync components with §4.3 multithreading support."""

    supports_multithreading = True

    def _run(self, cache: SharedCache) -> List[SharedCache]:
        full = slice(0, cache.n)
        part = self.process_range(cache, full)
        return self.merge_ranges(cache, [full], [part])

    # subclasses implement process_range(cache, rows) -> dict and
    # merge_ranges(cache, ranges, parts) -> [cache]


class Filter(RowSyncMT):
    """Keep rows where predicate(cache, rows) is True.  In-place compaction.

    The predicate is preferably a DSL expression
    (``col("lo_quantity") < 25``) — its read set is then derived exactly
    from the AST.  Legacy callables may declare ``reads=`` by hand; the
    cost-based optimizer commutes this filter ahead of adjacent
    row-preserving components only when the read set is known and disjoint
    from the neighbour's outputs, so an undeclared (None) read set refuses
    every commute."""

    def __init__(self, name: str,
                 predicate: Union[Expr, Callable[[SharedCache, slice],
                                                 np.ndarray]],
                 reads: Optional[Sequence[str]] = None):
        super().__init__(name)
        if isinstance(predicate, Expr) and not predicate.columns():
            raise ValueError(
                f"Filter {name!r}: predicate {predicate!r} reads no columns "
                f"— a constant predicate either keeps or drops every row")
        self.predicate = predicate
        self.reads = _resolve_reads(predicate, reads, name, "Filter")

    def output_schema(self, incols: FrozenSet[str]) -> FrozenSet[str]:
        return incols

    def produced_columns(self) -> frozenset:
        return frozenset()          # drops rows, never adds columns

    def consumed_columns(self) -> Optional[frozenset]:
        return self.reads

    def segment_ops(self) -> list:
        return [("filter", self.predicate, self.reads)]

    def process_range(self, cache: SharedCache, rows: slice) -> dict:
        return {"__mask__": self.get_backend().filter_mask(self.predicate,
                                                           cache, rows)}

    def merge_ranges(self, cache: SharedCache, ranges: List[slice],
                     parts: List[dict]) -> List[SharedCache]:
        mask = self.get_backend().concat([p["__mask__"] for p in parts])
        cache.compact(mask)          # row order preserved (synchronizer)
        return [cache]


class DimTable:
    """Dimension table for Lookup: key -> payload columns, vectorized via
    sorted keys + searchsorted.  ``row_filter`` marks non-qualifying dim rows
    as unmatched at build time (the paper's `AND c_region='AMERICA'` style
    join conditions)."""

    def __init__(self, key: np.ndarray, payload: Dict[str, np.ndarray],
                 row_filter: Optional[np.ndarray] = None):
        order = np.argsort(key, kind="stable")
        self.keys = np.asarray(key)[order]
        self.payload = {k: np.asarray(v)[order] for k, v in payload.items()}
        if row_filter is not None:
            self.qualifies = np.asarray(row_filter, dtype=bool)[order]
        else:
            self.qualifies = np.ones(len(self.keys), dtype=bool)

    def probe(self, vals: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """Returns (row_idx, matched_mask)."""
        idx = np.searchsorted(self.keys, vals)
        idx = np.clip(idx, 0, max(len(self.keys) - 1, 0))
        matched = (self.keys[idx] == vals) & self.qualifies[idx] \
            if len(self.keys) else np.zeros(len(vals), dtype=bool)
        return idx, matched

    def __getstate__(self):
        # the torch backend caches device tensors on the instance; they are
        # not part of the table and rebuild lazily after unpickling
        state = dict(self.__dict__)
        state.pop("_torch_device_cache", None)
        state.pop("_torch_hash_cache", None)
        return state


class Lookup(RowSyncMT):
    """Join with a dimension table; unmatched rows get ``default`` (-1) in
    every returned column — downstream Filter drops them (paper §5.1)."""

    row_preserving = True

    def __init__(self, name: str, dim: DimTable, key_col: ColumnRef,
                 return_cols: Dict[str, str], default: int = -1,
                 matched_flag: Optional[str] = None):
        super().__init__(name)
        self.dim = dim
        self.key_col = _col_name(key_col)
        self.return_cols = return_cols       # out_name -> dim payload col
        self.default = default
        self.matched_flag = matched_flag     # optional bool col with match bit

    def output_schema(self, incols: FrozenSet[str]) -> FrozenSet[str]:
        return incols | self.produced_columns()

    def produced_columns(self) -> frozenset:
        out = set(self.return_cols)
        if self.matched_flag:
            out.add(self.matched_flag)
        return frozenset(out)

    def consumed_columns(self) -> frozenset:
        return frozenset({self.key_col})

    def segment_ops(self) -> list:
        return [("lookup", self.dim, self.key_col, dict(self.return_cols),
                 self.default, self.matched_flag)]

    def process_range(self, cache: SharedCache, rows: slice) -> dict:
        bk = self.get_backend()
        vals = cache.col(self.key_col)[rows]
        idx, matched = bk.searchsorted_probe(self.dim, vals)
        out: Dict[str, np.ndarray] = {}
        for out_name, dim_col in self.return_cols.items():
            out[out_name] = bk.lookup_gather(self.dim, dim_col, idx, matched,
                                             self.default)
        if self.matched_flag:
            out[self.matched_flag] = matched
        return out

    def merge_ranges(self, cache: SharedCache, ranges: List[slice],
                     parts: List[dict]) -> List[SharedCache]:
        bk = self.get_backend()
        names = parts[0].keys()
        for name in names:                     # merge in input-range order
            cache.add_column(name, bk.concat([p[name] for p in parts]))
        return [cache]


class Expression(RowSyncMT):
    """Compute a new column from existing ones (paper's component 8).

    ``fn`` is preferably a DSL expression (``col("a") * col("b")``) whose
    read set is derived from the AST; legacy callables may declare
    ``reads=`` by hand — provenance metadata for the cost-based optimizer's
    commute/fusion rules and the fused-kernel upload sets."""

    row_preserving = True

    def __init__(self, name: str, out_col: str,
                 fn: Union[Expr, Callable[[SharedCache, slice], np.ndarray]],
                 reads: Optional[Sequence[str]] = None):
        super().__init__(name)
        if isinstance(fn, Expr) and not fn.columns():
            raise ValueError(
                f"Expression {name!r}: {fn!r} reads no columns — a scalar "
                f"constant is not a per-row column (it would crash at "
                f"merge time); derive it from a real column, e.g. "
                f"col(x) * 0 + value")
        self.out_col = _col_name(out_col)
        self.fn = fn
        self.reads = _resolve_reads(fn, reads, name, "Expression")

    def output_schema(self, incols: FrozenSet[str]) -> FrozenSet[str]:
        return incols | {self.out_col}

    def produced_columns(self) -> frozenset:
        return frozenset({self.out_col})

    def consumed_columns(self) -> Optional[frozenset]:
        return self.reads

    def segment_ops(self) -> list:
        return [("expr", self.out_col, self.fn, self.reads)]

    def process_range(self, cache: SharedCache, rows: slice) -> dict:
        return {self.out_col: self.get_backend().eval_expression(self.fn,
                                                                 cache, rows)}

    def merge_ranges(self, cache: SharedCache, ranges: List[slice],
                     parts: List[dict]) -> List[SharedCache]:
        cache.add_column(self.out_col, self.get_backend().concat(
            [p[self.out_col] for p in parts]))
        return [cache]


class FusedExpression(Component):
    """Several Expression activities collapsed into ONE pipeline activity by
    the cost-based optimizer (expression fusion).  The sub-expressions run
    sequentially against the shared cache, each output column visible to the
    next — identical results, one activity's worth of per-split overhead
    (the t0 of Theorem 1) instead of several."""

    row_preserving = True

    def __init__(self, name: str,
                 exprs: Sequence[Tuple[str, Callable]],
                 reads: Optional[frozenset] = None):
        super().__init__(name)
        self.exprs = list(exprs)             # [(out_col, fn), ...] in order
        self.reads = reads                   # None => unknown

    @classmethod
    def fuse(cls, a: Component, b: Component) -> "FusedExpression":
        """Fuse two adjacent Expression / FusedExpression components
        (``a`` upstream of ``b``), combining their provenance."""
        def parts(c):
            return c.exprs if isinstance(c, FusedExpression) \
                else [(c.out_col, c.fn)]
        reads = None
        ra, rb = a.consumed_columns(), b.consumed_columns()
        if ra is not None and rb is not None:
            # b's reads of a's outputs are internal to the fused activity
            reads = ra | (rb - a.produced_columns())
        return cls(f"fused({a.name}+{b.name})", parts(a) + parts(b),
                   reads=reads)

    def produced_columns(self) -> frozenset:
        return frozenset(out for out, _ in self.exprs)

    def consumed_columns(self) -> Optional[frozenset]:
        return self.reads

    def segment_ops(self) -> list:
        # DSL sub-expressions carry their exact per-op read sets; legacy
        # callables fall back to the combined external read set (self.reads,
        # None => unknown), which over-approximates each of them
        return [("expr", out_col, fn,
                 fn.columns() if isinstance(fn, Expr) else self.reads)
                for out_col, fn in self.exprs]

    def output_schema(self, incols: FrozenSet[str]) -> FrozenSet[str]:
        return incols | self.produced_columns()

    def _run(self, cache: SharedCache) -> List[SharedCache]:
        bk = self.get_backend()
        for out_col, fn in self.exprs:
            cache.add_column(out_col,
                             bk.eval_expression(fn, cache, slice(0, cache.n)))
        return [cache]


def segment_fallback_allowed(backend) -> bool:
    """Whether a ``FusedSegment`` whose runner fails may step onto the host
    reference pass: on a host backend (``numpy``, ``torch_cpu``) yes, where
    that pass is what the runner computes anyway; on a backend whose device
    is a CUDA card never, since the host pass would hide a device failure
    behind a slower route."""
    device = getattr(backend, "device", None)
    return getattr(device, "type", "cpu") != "cuda"


class FusedSegment(Component):
    """A maximal row-synchronized chain (Filter / Expression / Lookup /
    Project / Converter and fused combinations) collapsed into ONE pipeline
    activity by segment fusion (core/planner.discover_segments +
    core/optimizer.fuse_segments_flow).

    The whole segment executes as a SINGLE backend dispatch per chunk via
    ``Backend.compile_segment``: the numpy backend composes the ops into one
    vectorized host pass (bit-identical to the unfused chain), the torch
    backend runs the segment over device columns (one h2d in, one d2h out
    per chunk, Lookups through the hash-probe kernel).  Ops are declarative
    tuples (see each component's ``segment_ops``):

        ("filter",  predicate, reads_or_None)
        ("expr",    out_col, fn, reads_or_None)
        ("lookup",  dim, key_col, return_cols, default, matched_flag)
        ("project", keep_tuple)
        ("convert", conversions_dict)

    CONTRACT: members must be row-local (each output row a function of its
    own input row only) — exactly the paper's §3 row-synchronized
    classification.  The compiled runner is cached per backend on the
    component, so tracing/composition happens once per run."""

    def __init__(self, name: str, ops: Sequence[tuple],
                 members: Optional[Sequence[str]] = None,
                 produced: Optional[frozenset] = None,
                 consumed: Optional[frozenset] = None,
                 row_pres: bool = False):
        super().__init__(name)
        self.ops = list(ops)
        self.members = list(members or [])
        self._produced = produced
        self._consumed = consumed
        self.row_preserving = row_pres
        self._compiled: Dict[str, Callable] = {}
        #: mask deferral (set by the optimizer's fuse-segment-aggregate
        #: rewrite): columns the terminal Aggregate consumes / its name.
        #: Backends with ``supports_segment_defer`` then skip the per-chunk
        #: compact and emit the keep-mask as a SEGMENT_KEEP_MASK column.
        self.defer_cols: Optional[frozenset] = None
        self.defer_to: Optional[str] = None

    # compiled runners are per-process (process shard route); rebuilt lazily
    _UNPICKLABLE = Component._UNPICKLABLE + ("_compiled",)

    def __setstate__(self, state):
        super().__setstate__(state)
        self._compiled = {}

    @classmethod
    def from_components(cls, comps: Sequence[Component]) -> "FusedSegment":
        """Fuse an ordered chain of fusable components, combining their ops
        and provenance.  Raises ``ValueError`` on a non-fusable member."""
        ops: List[tuple] = []
        produced: Optional[set] = set()
        consumed: Optional[set] = set()
        for c in comps:
            sub = c.segment_ops()
            if sub is None:
                raise ValueError(f"component {c.name!r} ({type(c).__name__}) "
                                 f"cannot join a fused segment")
            ops.extend(sub)
            r = c.consumed_columns()
            p = c.produced_columns()
            if consumed is not None:
                # reads of columns produced EARLIER in the segment are
                # internal; unknown reads (or unknown prior writes) poison
                # the whole declared set
                consumed = (None if r is None or produced is None
                            else consumed | (r - produced))
            if produced is not None:
                produced = None if p is None else produced | p
        name = f"fusedseg({'+'.join(c.name for c in comps)})"
        return cls(name, ops, members=[c.name for c in comps],
                   produced=None if produced is None else frozenset(produced),
                   consumed=None if consumed is None else frozenset(consumed),
                   row_pres=all(c.row_preserving for c in comps))

    def produced_columns(self) -> Optional[frozenset]:
        return self._produced

    def consumed_columns(self) -> Optional[frozenset]:
        return self._consumed

    def output_schema(self, incols: FrozenSet[str]) -> FrozenSet[str]:
        from ..core.backend.base import segment_final_live
        return frozenset(segment_final_live(self.ops, incols))

    def kernel_input_columns(self) -> Optional[frozenset]:
        """External columns the segment's compute ops read (the upload set
        for device backends); ``None`` when some op's read set is undeclared
        — the backend then feeds every cache column to the kernel."""
        needed: set = set()
        produced: set = set()
        for op in self.ops:
            kind = op[0]
            if kind == "filter":
                if op[2] is None:
                    return None
                needed |= op[2] - produced
            elif kind == "expr":
                if op[3] is None:
                    return None
                needed |= op[3] - produced
                produced.add(op[1])
            elif kind == "lookup":
                needed |= {op[2]} - produced
                produced.update(op[3])
                if op[5]:
                    produced.add(op[5])
            elif kind == "convert":
                needed |= set(op[1]) - produced
                produced.update(op[1])
            # project: metadata-only, nothing to upload
        return frozenset(needed)

    def defer_mask_to(self, agg: "Aggregate") -> None:
        """Mark this segment as fused through its terminal ``Aggregate``:
        deferral-capable backends keep the chunk uncompacted (device-resident,
        no per-chunk d2h mask sync) and ``agg.finish`` applies the combined
        keep-mask once after the merge.  Host backends ignore the marking —
        their eager compact is free and byte-identical."""
        self.defer_cols = frozenset(agg.consumed_columns())
        self.defer_to = agg.name
        self._compiled.clear()        # runners bake in the deferral mode

    def spec(self) -> Dict[str, str]:
        out = super().spec()
        out["members"] = ",".join(self.members)
        if self.defer_to:
            out["defer_mask_to"] = self.defer_to
        return out

    def _dispatch(self, bk, cache: SharedCache) -> None:
        """One compiled-segment dispatch with the segment's degradation
        rung: on a host backend (``segment_fallback_allowed``) a
        non-transient, non-injected failure of the compiled runner falls
        back to the backend-agnostic host reference pass
        (``Backend.compile_segment`` base implementation, bit-identical to
        the unfused chain) and the fallback sticks for the rest of the
        component's life — later chunks skip the broken runner.  On the
        card every failure of the runner propagates: the card never falls
        back to the host pass.  A failure
        that ``faults.may_degrade`` refuses propagates too (a transient one
        to chunk-level replay).

        The pre-dispatch snapshot is taken only under active fault
        injection: real kernel failures surface before the runner's
        write-back mutates the cache."""
        runner = self._compiled.get(bk.name)
        if runner is None:
            runner = self._compiled[bk.name] = bk.compile_segment(self)
        snap = faults.snapshot_cache(cache) if faults.active() else None
        try:
            if snap is not None:
                faults.inject("kernel", component=self.name,
                              split=cache.split_index)
            runner(cache)
            return
        except BaseException as e:
            if (not faults.may_degrade(e)
                    or not segment_fallback_allowed(bk)
                    or getattr(runner, "_is_reference", False)):
                raise
            from ..core.backend.base import Backend as _Base
            faults.record_degradation(
                "kernel", src=f"segment[{bk.name}]", dst="reference",
                component=self.name, error=repr(e))
            ref = _Base.compile_segment(bk, self)
            ref._is_reference = True
            self._compiled[bk.name] = ref
            if snap is not None:
                faults.restore_cache(cache, snap)
            ref(cache)

    def _run(self, cache: SharedCache) -> List[SharedCache]:
        bk = self.get_backend()
        if obs_trace.ACTIVE.get():
            n_in = cache.n
            t0 = time.perf_counter()
            self._dispatch(bk, cache)
            obs_trace.on_kernel(self.name, bk.name, t0, time.perf_counter(),
                                n_in)
        else:
            self._dispatch(bk, cache)
        return [cache]


class Project(Component):
    """Keep a subset of columns.  With the shared caching scheme this is a
    metadata-only operation (no rows move)."""

    row_preserving = True

    def __init__(self, name: str, keep: Sequence[ColumnRef]):
        super().__init__(name)
        self.keep = [_col_name(k) for k in keep]

    def produced_columns(self) -> frozenset:
        return frozenset()           # only removes columns

    def output_schema(self, incols: FrozenSet[str]) -> FrozenSet[str]:
        return incols & frozenset(self.keep)

    def consumed_columns(self) -> frozenset:
        return frozenset(self.keep)

    def segment_ops(self) -> list:
        return [("project", tuple(self.keep))]

    def _run(self, cache: SharedCache) -> List[SharedCache]:
        cache.keep_columns(self.keep)
        return [cache]


class Converter(Component):
    """Data format converter (row-synchronized)."""

    row_preserving = True

    def __init__(self, name: str, conversions: Dict[str, np.dtype]):
        super().__init__(name)
        self.conversions = conversions

    def produced_columns(self) -> frozenset:
        # overwrites the converted columns: a filter reading them must NOT
        # hop this component (it would see the pre-conversion dtype)
        return frozenset(self.conversions)

    def consumed_columns(self) -> frozenset:
        return frozenset(self.conversions)

    def segment_ops(self) -> list:
        return [("convert", dict(self.conversions))]

    def output_schema(self, incols: FrozenSet[str]) -> FrozenSet[str]:
        return incols

    def _run(self, cache: SharedCache) -> List[SharedCache]:
        for col, dt in self.conversions.items():
            # add_column (not a raw columns[] write) bumps cache.version so
            # backends drop any cached device view of the old column
            cache.add_column(col, cast(cache.col(col), dt))
        return [cache]


class Splitter(Component):
    """Route rows to two output ports by predicate (row-synchronized)."""

    def __init__(self, name: str,
                 predicate: Callable[[SharedCache, slice], np.ndarray]):
        super().__init__(name)
        self.predicate = predicate

    def output_schema(self, incols: FrozenSet[str]) -> FrozenSet[str]:
        return incols            # routes rows; column set unchanged

    def _run(self, cache: SharedCache) -> List[SharedCache]:
        mask = np.asarray(self.predicate(cache, slice(0, cache.n)), dtype=bool)
        hi = SharedCache({k: cache.col(k)[mask] for k in cache.names},
                         int(mask.sum()), cache.split_index)
        lo = SharedCache({k: cache.col(k)[~mask] for k in cache.names},
                         int((~mask).sum()), cache.split_index)
        return [hi, lo]


# ---------------------------------------------------------------------------
#  Block components
# ---------------------------------------------------------------------------
class _AggServeState:
    """Cross-tick partial store for a serving-mode ``Aggregate``: per-group
    MERGEABLE partials (sum/min/max/count — ``avg`` is decomposed into a sum
    and a count and divided only at emit) kept as host scalars in their
    backend dtype, so merging a tick is the same dtype-preserving arithmetic
    the backend's one-shot reduce performs."""

    __slots__ = ("index", "keys", "partials")

    def __init__(self, partial_names: Sequence[str]):
        self.index: Dict[tuple, int] = {}      # group key tuple -> position
        self.keys: List[tuple] = []            # group key tuples, insertion order
        self.partials: Dict[str, list] = {p: [] for p in partial_names}


#: internal partial-name separator — ``\x00`` cannot appear in a user column
_PARTIAL_SEP = "\x00"


class Aggregate(BlockComponent):
    """Group-by aggregation — the paper's canonical block component
    (sum/avg/min/max).  Accumulates all input caches, then reduces.

    Serving mode (``begin_serving``/``end_serving``): ``finish`` becomes an
    incremental upsert instead of a one-shot block reduce — the tick's rows
    are reduced with the normal backend kernel, merged into a persistent
    per-group partial store, and the emitted cache is the DELTA: every group
    touched this tick with its current merged value (an upsert row retracts
    the group's previously emitted value)."""

    #: segment fusion may extend a row-sync chain through this component:
    #: the fused segment defers its keep-mask (no per-chunk d2h) and finish()
    #: applies it once to the merged cache before reducing
    segment_terminal_aggregate = True

    def __init__(self, name: str, group_by: Sequence[ColumnRef],
                 aggs: Dict[str, Tuple[ColumnRef, str]]):
        """``aggs``: out_col -> (in_col, op) with op in sum/avg/min/max/count.
        Column arguments accept plain names or DSL ``col()`` references."""
        super().__init__(name)
        self.group_by = [_col_name(g) for g in group_by]
        for out, (col, op) in aggs.items():
            if op not in AGG_OPS:     # same set every backend validates
                raise ValueError(f"unknown agg op {op!r}")
        self.aggs = {out: (_col_name(col), op)
                     for out, (col, op) in aggs.items()}
        self._serving: Optional[_AggServeState] = None

    def produced_columns(self) -> frozenset:
        return frozenset(self.group_by) | frozenset(self.aggs)

    def consumed_columns(self) -> frozenset:
        return frozenset(self.group_by) | frozenset(
            col for col, _ in self.aggs.values())

    def output_schema(self, incols: FrozenSet[str]) -> FrozenSet[str]:
        # aggregation REPLACES the schema: group keys + aggregate outputs
        return self.produced_columns()

    def _empty_output(self) -> SharedCache:
        """The output of no rows: int64 keys and float64 aggregates, the
        reference backends' empty convention."""
        cols = {g: np.array([], dtype=np.int64) for g in self.group_by}
        for out in self.aggs:
            cols[out] = np.array([], dtype=np.float64)
        return SharedCache(cols, 0)

    # ------------------------------------------------------------ serving
    def _partial_plan(self) -> Dict[str, Tuple[str, str]]:
        """Mergeable-partial spec for the serving tick reduce: partial name
        -> (input column, op).  ``avg`` is not mergeable and decomposes into
        a sum partial and a count partial (divided at emit); every other op
        merges with itself."""
        plan: Dict[str, Tuple[str, str]] = {}
        for out, (col, op) in self.aggs.items():
            if op == "avg":
                plan[out + _PARTIAL_SEP + "sum"] = (col, "sum")
                plan[out + _PARTIAL_SEP + "count"] = (col, "count")
            else:
                plan[out] = (col, op)
        return plan

    def begin_serving(self) -> None:
        """Enter serving mode with a fresh cross-tick partial store."""
        self._serving = _AggServeState(list(self._partial_plan()))

    def end_serving(self) -> None:
        """Leave serving mode and drop the partial store — the component is
        immediately reusable for ordinary batch runs."""
        self._serving = None

    def serving_snapshot(self):
        """Copy of the cross-tick partial store, taken before a tick
        attempt so a retried tick merges its rows exactly once (replaying
        into already-merged partials would double-count).  ``None`` outside
        serving mode."""
        st = self._serving
        if st is None:
            return None
        return (dict(st.index), list(st.keys),
                {p: list(v) for p, v in st.partials.items()})

    def serving_restore(self, snap) -> None:
        """Rewind the partial store to a ``serving_snapshot`` (no-op for
        ``None`` / outside serving mode)."""
        if self._serving is None or snap is None:
            return
        st = self._serving
        st.index = dict(snap[0])
        st.keys = list(snap[1])
        st.partials = {p: list(v) for p, v in snap[2].items()}

    def _serving_finish(self, merged: SharedCache) -> SharedCache:
        st = self._serving
        plan = self._partial_plan()
        n = merged.n
        if n == 0:
            # empty tick: nothing merges, the delta is the batch empty output
            return self._empty_output()
        bk = self.get_backend()
        group_cols, part_cols = bk.groupby_reduce(
            [merged.col(g) for g in self.group_by],
            {p: (merged.col(col), op) for p, (col, op) in plan.items()},
            n)
        # to_host copies (shared_cache.tensor_to_host), so neither the
        # emitted delta nor the stored partials view a buffer that the
        # recycle below hands to the next tick
        group_h = [np.asarray(bk.to_host(c)) for c in group_cols]
        part_h = {p: np.asarray(bk.to_host(c)) for p, c in part_cols.items()}
        merged.recycle()            # tick-loop steady state: buffers pool
        n_groups = len(group_h[0]) if group_h else 1
        # upsert the tick's reduced groups into the persistent store — the
        # merge arithmetic stays in each partial's own dtype (numpy scalar
        # ops of one dtype never promote), so merged partials are the same
        # values the one-shot reduce computes on exactly-representable data
        for r in range(n_groups):
            key = tuple(c[r] for c in group_h)
            pos = st.index.get(key)
            if pos is None:
                st.index[key] = len(st.keys)
                st.keys.append(key)
                for p in plan:
                    st.partials[p].append(part_h[p][r])
            else:
                for p, (_, op) in plan.items():
                    cur, new = st.partials[p][pos], part_h[p][r]
                    if op == "min":
                        st.partials[p][pos] = np.minimum(cur, new)
                    elif op == "max":
                        st.partials[p][pos] = np.maximum(cur, new)
                    else:            # sum / count partials merge additively
                        st.partials[p][pos] = cur + new
        # the delta: every group touched this tick (already in the backend's
        # lexicographic group order) with its current MERGED value — an
        # upsert row supersedes the group's previously emitted value
        cols = dict(zip(self.group_by, group_h))
        rows = [st.index[tuple(c[r] for c in group_h)]
                for r in range(n_groups)]
        for out, (col, op) in self.aggs.items():
            if op == "avg":
                s = st.partials[out + _PARTIAL_SEP + "sum"]
                cnt = st.partials[out + _PARTIAL_SEP + "count"]
                # divide in the sum's dtype — the same single-rounding
                # division the one-shot kernel performs
                vals = [s[i] / s[i].dtype.type(cnt[i]) for i in rows]
            else:
                vals = [st.partials[out][i] for i in rows]
            cols[out] = np.array(vals, dtype=vals[0].dtype)
        self.rows_out += n_groups
        return SharedCache(cols, n_groups)

    # ------------------------------------------------------------ batch
    def finish(self, state: List[SharedCache]) -> SharedCache:
        merged = concat_caches(state, ordered=True, recycle_inputs=True)
        if SEGMENT_KEEP_MASK in merged.names:
            # an upstream fused segment deferred its keep-mask: drop the
            # sentinel and compact the MERGED cache once — on device backends
            # this is the single d2h mask sync that replaced one per chunk
            mask = merged.col(SEGMENT_KEEP_MASK)
            merged.keep_columns(
                [c for c in merged.names if c != SEGMENT_KEEP_MASK])
            merged.compact(mask)
        if self._serving is not None:
            return self._serving_finish(merged)
        n = merged.n
        if n == 0:
            return self._empty_output()
        # groupby_reduce is the backend's block kernel: the torch backend
        # routes sum/avg through the radix-groupby / segment-sum kernels
        group_cols, agg_cols = self.get_backend().groupby_reduce(
            [merged.col(g) for g in self.group_by],
            {out: (merged.col(col), op) for out, (col, op) in self.aggs.items()},
            n)
        cols = dict(zip(self.group_by, group_cols))
        cols.update(agg_cols)
        # degenerate global aggregation with no agg columns: one empty row
        n_groups = len(next(iter(cols.values()))) if cols else 1
        self.rows_out += n_groups
        return SharedCache(cols, n_groups)

    # ------------------------------------------------------------ sharded
    # The shard runtime's partial→shuffle→merge decomposition reuses the
    # serving partial plan: each shard reduces its rows to per-group
    # MERGEABLE partials (avg → sum+count), the coordinator second-stage
    # reduces the stashed partial tables (value partials with their own op,
    # count partials by summing) in each partial's stage-1 dtype, and avg
    # divides once at emit — the identical single-rounding arithmetic the
    # serial one-shot reduce performs on exactly-representable data.

    def shard_partial(self, state: List[SharedCache]) -> Optional[dict]:
        """Reduce one shard pass's accumulated input to a host partial
        table ``{group col / partial name: np.ndarray}``; ``None`` when the
        shard delivered no rows (nothing to merge)."""
        merged = concat_caches(state, ordered=True, recycle_inputs=True)
        if SEGMENT_KEEP_MASK in merged.names:
            # same deferred-keep-mask compaction as finish(): one d2h sync
            mask = merged.col(SEGMENT_KEEP_MASK)
            merged.keep_columns(
                [c for c in merged.names if c != SEGMENT_KEEP_MASK])
            merged.compact(mask)
        n = merged.n
        if n == 0:
            merged.recycle()
            return None
        plan = self._partial_plan()
        bk = self.get_backend()
        group_cols, part_cols = bk.groupby_reduce(
            [merged.col(g) for g in self.group_by],
            {p: (merged.col(col), op) for p, (col, op) in plan.items()},
            n)
        table = {g: np.asarray(bk.to_host(c))
                 for g, c in zip(self.group_by, group_cols)}
        for p, c in part_cols.items():
            table[p] = np.asarray(bk.to_host(c))
        merged.recycle()
        return table

    def shard_empty(self) -> SharedCache:
        """Schema-shaped empty output a shard pass emits downstream — the
        batch empty output."""
        return self._empty_output()

    def shard_merge(self, state: List[SharedCache], partials: Sequence[dict],
                    combiner=None) -> SharedCache:
        """Coordinator merge: second-stage reduce the stashed per-shard
        partial tables (plus a partial of any rows the merge pass itself
        delivered — a cut-ancestored aggregate's real input arrives then)
        into the exact serial result.  ``combiner`` is the optional mesh
        route reducer (on the backend's device); the host
        ``reduce_partials`` is the reference."""
        from ..core.shard.merge import reduce_partials
        own = self.shard_partial(state)
        tables = list(partials)
        if own is not None:
            tables.append(own)
        if not tables:
            return self.shard_empty()
        plan = self._partial_plan()
        second = {p: ("sum" if op == "count" else op)
                  for p, (_, op) in plan.items()}
        cat = {c: np.concatenate([np.asarray(t[c]) for t in tables])
               for c in (*self.group_by, *plan)}
        merged = combiner(cat, self.group_by, second) \
            if combiner is not None else None
        if merged is None:
            merged = reduce_partials(cat, self.group_by, second)
        group_cols, part_cols = merged
        cols = dict(zip(self.group_by, group_cols))
        for out, (col, op) in self.aggs.items():
            if op == "avg":
                s = part_cols[out + _PARTIAL_SEP + "sum"]
                cnt = part_cols[out + _PARTIAL_SEP + "count"]
                # divide in the sum's dtype — same single rounding as the
                # one-shot kernel (and as _serving_finish's emit)
                vals = [s[i] / s[i].dtype.type(cnt[i]) for i in range(len(s))]
                cols[out] = (np.array(vals, dtype=vals[0].dtype) if vals
                             else np.array([], dtype=np.float64))
            else:
                cols[out] = part_cols[out]
        n_groups = len(next(iter(cols.values()))) if cols else 1
        self.rows_out += n_groups
        return SharedCache(cols, n_groups)


class Sort(BlockComponent):
    """Total sort — block component (needs all rows)."""

    def __init__(self, name: str, by: Sequence[ColumnRef],
                 ascending: bool = True):
        super().__init__(name)
        self.by = [_col_name(b) for b in by]
        self.ascending = ascending

    def consumed_columns(self) -> frozenset:
        return frozenset(self.by)

    def output_schema(self, incols: FrozenSet[str]) -> FrozenSet[str]:
        return incols

    def finish(self, state: List[SharedCache]) -> SharedCache:
        merged = concat_caches(state, ordered=True, recycle_inputs=True)
        order = self.get_backend().sort_rows(
            [merged.col(b) for b in self.by], ascending=self.ascending)
        merged.take(order)
        self.rows_out += merged.n
        return merged


# ---------------------------------------------------------------------------
#  Semi-block components
# ---------------------------------------------------------------------------
class Union(SemiBlockComponent):
    """Concatenate rows from multiple upstreams (bag union)."""

    def __init__(self, name: str):
        super().__init__(name)

    def output_schema(self, incols: FrozenSet[str]) -> FrozenSet[str]:
        # concat requires identical branch schemas; incols is already the
        # intersection across the fan-in branches
        return incols

    def finish(self, state: List[SharedCache]) -> SharedCache:
        out = concat_caches(state, ordered=False, recycle_inputs=True)
        self.rows_out += out.n
        return out


class Merge(SemiBlockComponent):
    """Sorted merge of multiple upstreams by key columns."""

    def __init__(self, name: str, by: Sequence[ColumnRef]):
        super().__init__(name)
        self.by = [_col_name(b) for b in by]

    def consumed_columns(self) -> frozenset:
        return frozenset(self.by)

    def output_schema(self, incols: FrozenSet[str]) -> FrozenSet[str]:
        return incols

    def finish(self, state: List[SharedCache]) -> SharedCache:
        merged = concat_caches(state, ordered=False, recycle_inputs=True)
        merged.take(self.get_backend().sort_rows(
            [merged.col(b) for b in self.by]))
        self.rows_out += merged.n
        return merged


# ---------------------------------------------------------------------------
#  Sinks
# ---------------------------------------------------------------------------
class CollectSink(SinkComponent):
    """Buffers result caches; exposes the final table (split-ordered)."""

    def __init__(self, name: str):
        super().__init__(name)
        self._lock = threading.Lock()
        self._buf: List[SharedCache] = []

    def write(self, cache: SharedCache) -> None:
        snap = SharedCache(cache.to_dict(), cache.n, cache.split_index)
        with self._lock:
            self._buf.append(snap)

    def result(self) -> Dict[str, np.ndarray]:
        with self._lock:
            caches = sorted(self._buf, key=lambda c: c.split_index)
            out = concat_caches(caches, ordered=False)
            table = out.to_dict()        # to_dict copies: recycling is safe
            # return the concat's arena buffers instead of dropping them —
            # a per-tick result() in a resident serving session would
            # otherwise miss-allocate fresh buffers on every single tick
            out.recycle()
            return table

    def clear(self) -> None:
        with self._lock:
            self._buf.clear()

    # ------------------------------------------------------------ sharded
    def drain(self) -> List[SharedCache]:
        """Take the buffered caches (the shard runtime harvests each shard
        pass's writes, then reassembles the serial buffer via reinject)."""
        with self._lock:
            buf, self._buf = self._buf, []
            return buf

    def reinject(self, caches: List[SharedCache]) -> None:
        with self._lock:
            self._buf.extend(caches)

    # locks don't pickle (process shard route); rebuilt on load
    _UNPICKLABLE = SinkComponent._UNPICKLABLE + ("_lock",)

    def __setstate__(self, state):
        super().__setstate__(state)
        self._lock = threading.Lock()


class FileSink(CollectSink):
    """Writes the final result to a text file (paper: 'writes the final
    results into a text file')."""

    def __init__(self, name: str, path: str, sep: str = "|"):
        super().__init__(name)
        self.path = path
        self.sep = sep

    def close(self) -> None:
        cols = self.result()
        names = list(cols.keys())
        with open(self.path, "w") as f:
            f.write(self.sep.join(names) + "\n")
            if names:
                n = len(cols[names[0]])
                for i in range(n):
                    f.write(self.sep.join(str(cols[c][i]) for c in names) + "\n")
