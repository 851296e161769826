"""Accelerated operator backend: device-resident torch columns and the
hand-written CUDA kernels.

Kernels (``repro_torch/kernels``, built from ``csrc/*.cu``):
  - ``searchsorted_probe`` / ``lookup_gather`` — probe over a
    device-cached dimension table (keys/qualifies/payload uploaded once per
    table and reused across every chunk).  The default route is the
    ``kernels/hash_join`` open-addressing table (host-built once per
    DimTable, probed by the CUDA hash-probe kernel); ``REPRO_JOIN_IMPL=
    searchsorted`` selects the legacy binary search over the sorted keys.
    Both return the same (index, matched) pair bit-for-bit: the hash build
    keeps the FIRST occurrence of a duplicate key, which over the
    DimTable's sorted keys is exactly ``searchsorted``'s leftmost index.
  - ``groupby_reduce`` — dense integer key spaces route through
    ``kernels/radix_groupby``; keyless sum/avg and the sort route (sparse /
    non-integer / huge key spaces, or ``REPRO_GROUPBY_IMPL=sort``) through
    ``kernels/segment_sum``.  Sums accumulate in float32, so engine-vs-
    oracle checks use ``oracle_rtol``.  min/max use ``scatter_reduce``.
  - ``filter_mask`` / ``eval_expression`` — predicates and expressions
    evaluated over a device view of the shared cache.
  - ``sort_rows`` — stable sorts from the last key to the first.

The backend named ``torch`` runs on CUDA and raises when there is none; it
never moves to the CPU by itself.  ``torch_cpu`` is the same class pinned
to the CPU, where every kernel wrapper runs its plain torch version.

Degradation ladders (``torch_cpu`` only): a kernel route that fails with a
non-transient error steps ONE rung down and stays there for the backend
instance's lifetime, recorded as a ``kernel`` ``Degradation``: join
``reference -> searchsorted``, groupby ``reference -> sort``.  On the card a
kernel failure raises: no CUDA tensor is ever moved onto another route.  A
kernel library that cannot be built or loaded
(``kernels._cuda.KernelLibraryError``) never steps.

Every host->device / device->host crossing is recorded in ``CacheStats``
(scoped ``record_transfer``) at the same places as in the reference's jax
backend, so the transfer counters of a flow agree between the two.

Device columns are 32-bit: 64-bit host columns narrow on upload and
``dtype_width`` reports the device width, so planner channel sizing matches
what actually crosses an edge.
"""
from __future__ import annotations

import threading
import time
import weakref
from typing import Callable, Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from ...kernels.hash_join import hash_build, hash_probe, pack_table
from ...kernels.radix_groupby import radix_groupby
from ...kernels.segment_sum import segment_sum
from ...obs import trace as obs_trace
from .. import config, faults
from ..expr import ColumnsView, Expr, cast, torch_dtype
from ..shared_cache import (GLOBAL_ARENA, device_dtype, host_to_device,
                            is_host_column, record_dim_upload,
                            record_segment_compile, record_transfer,
                            tensor_to_host)
from .base import (AGG_OPS, SEGMENT_KEEP_MASK, Backend, SegmentEnv,
                   segment_final_live, segment_written_columns)

_INT_DTYPES = (torch.int8, torch.int16, torch.int32, torch.int64,
               torch.uint8)


class _DeviceCacheView:
    """Read-only view of a SharedCache whose ``col`` returns device tensors
    (uploaded and cached on first touch), so user predicates/expressions
    written against the cache API compute on device.  One view is shared
    across a component's §4.3 row-range calls (see ``TorchBackend._view``),
    so each column is uploaded once per cache version, not once per
    range."""

    __slots__ = ("_backend", "_cache", "_cols", "_lock")

    def __init__(self, backend: "TorchBackend", cache):
        self._backend = backend
        self._cache = cache
        self._cols: Dict[str, torch.Tensor] = {}
        self._lock = threading.Lock()

    @property
    def n(self) -> int:
        return self._cache.n

    @property
    def names(self):
        return self._cache.names

    def col(self, name: str):
        got = self._cols.get(name)
        if got is None:
            with self._lock:       # concurrent row ranges: upload once
                got = self._cols.get(name)
                if got is None:
                    got = self._cols[name] = self._backend.asarray(
                        self._cache.col(name))
        return got

    def __getattr__(self, name):
        # API parity with SharedCache: anything beyond col/n/names falls
        # back to the underlying cache (host compute)
        return getattr(self._cache, name)


class TorchBackend(Backend):
    #: align chunks so the fused-segment staging layouts see few distinct
    #: sizes (bounds ``segment_compiles``, as in the reference)
    batch_align = 512
    #: float32 accumulation vs the float64 oracles
    oracle_rtol = 1e-3
    #: fused row-sync chains may defer their combined keep-mask through a
    #: terminal Aggregate (the per-chunk d2h sync disappears; Aggregate.finish
    #: applies the mask once after the device-side concat)
    supports_segment_defer = True
    #: dense-groupby guards: past either, fall back to the sort route
    #: (float32 counts are exact below 2^24; the dense cell count bounds the
    #: group-id space the radix kernel partitions)
    _DENSE_MAX_ROWS = 1 << 24
    _DENSE_MAX_CELLS = 1 << 20
    #: kernel degradation ladders of ``torch_cpu`` (left = fastest, right =
    #: safest): on a non-transient kernel failure the route walks ONE rung
    #: right and stays there for this backend instance's lifetime.  ``auto``
    #: is rung 0.  The card has no ladder: a kernel that fails on CUDA
    #: tensors raises, since any other route would hide it.
    _LADDERS = {"join": ("reference", "searchsorted"),
                "groupby": ("reference", "sort")}

    def __init__(self, device: str = "cuda") -> None:
        dev = torch.device(device)
        if dev.type == "cuda":
            if not torch.cuda.is_available():
                raise RuntimeError(
                    "backend 'torch' runs on CUDA and this machine has no "
                    "CUDA device; the CPU version is backend 'torch_cpu'")
            if dev.index is None:
                dev = torch.device("cuda", torch.cuda.current_device())
        self.device = dev
        self.name = "torch" if dev.type == "cuda" else "torch_" + dev.type
        self._segsum_impl = config.segsum_impl()
        # device views keyed by cache, invalidated by cache.version — a
        # stale view (pre-compact/add_column) is never reused
        self._views: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()
        self._views_lock = threading.Lock()
        self._dims_lock = threading.Lock()
        # sticky degradation-ladder routes; None => follow the env config
        self._join_route: Optional[str] = None
        self._groupby_route: Optional[str] = None
        # one step at a time: pipeline threads failing on the same rung
        # step it once and record one Degradation
        self._route_lock = threading.Lock()

    def _degraded_impl(self, kind: str, impl: str, exc: BaseException):
        """Next rung of the ``kind`` kernel ladder after ``impl`` failed with
        ``exc``, or ``None`` when the failure must propagate instead: always
        on the card, and otherwise for a failure that ``faults.may_degrade``
        refuses or one on the ladder's floor.  A chosen rung is recorded as a ``Degradation`` and
        sticks on this backend instance — later chunks skip the broken
        kernel."""
        if self.device.type == "cuda" or not faults.may_degrade(exc):
            return None
        ladder = self._LADDERS[kind]
        i = ladder.index(impl) if impl in ladder else 0   # "auto" => rung 0
        if i + 1 >= len(ladder):
            return None
        attr = "_join_route" if kind == "join" else "_groupby_route"
        with self._route_lock:
            cur = getattr(self, attr)
            if cur in ladder and ladder.index(cur) > i:
                return cur          # another thread already stepped past
            nxt = ladder[i + 1]
            src = ladder[0] if impl == "auto" else impl
            faults.record_degradation("kernel", src=f"{kind}[{src}]",
                                      dst=nxt, component=kind,
                                      error=repr(exc))
            setattr(self, attr, nxt)
        return nxt

    def _view(self, cache) -> _DeviceCacheView:
        with self._views_lock:
            got = self._views.get(cache)
            if got is not None and got[0] == cache.version:
                return got[1]
            view = _DeviceCacheView(self, cache)
            self._views[cache] = (cache.version, view)
            return view

    def _dev(self, x) -> torch.Tensor:
        """``x`` as a tensor on this device, without recording a transfer —
        the counterpart of the reference's implicit ``jnp.asarray`` of small
        host index arrays and python values."""
        if isinstance(x, torch.Tensor):
            return x if x.device == self.device else x.to(self.device)
        return host_to_device(np.asarray(x), self.device)

    # ------------------------------------------------------------ array ops
    def asarray(self, x):
        if isinstance(x, np.ndarray):
            # host_to_device always copies: on the CPU a tensor made from a
            # numpy array aliases it, and the CacheArena recycles host
            # buffers — an aliased device column would silently observe the
            # next borrower's bytes
            t0 = time.perf_counter() if obs_trace.ACTIVE.get() else 0.0
            out = host_to_device(x, self.device)
            record_transfer("h2d", x.nbytes,
                            seconds=(time.perf_counter() - t0) if t0 else 0.0)
            return out
        return self._dev(x)

    def to_host(self, x) -> np.ndarray:
        if isinstance(x, np.ndarray):
            return x
        t0 = time.perf_counter() if obs_trace.ACTIVE.get() else 0.0
        out = tensor_to_host(x)
        record_transfer("d2h", out.nbytes,
                        seconds=(time.perf_counter() - t0) if t0 else 0.0)
        return out

    def concat(self, parts: Sequence):
        parts = list(parts)
        if len(parts) == 1:
            return self.asarray(parts[0])
        return torch.cat([self.asarray(p) for p in parts])

    # --------------------------------------------------------------- sizing
    def dtype_width(self, dtype) -> int:
        # 64-bit host columns live as 4-byte device columns
        return int(device_dtype(dtype).itemsize)

    def bucket_rows(self, n: int) -> int:
        """Pad target for a data-dependent row count: ``batch_align`` times
        the next power of two of the needed alignment units — the fused
        segment's staging layout, whose count stays logarithmic in the
        row-count range."""
        align = max(1, self.batch_align)
        units = max(1, -(-int(n) // align))
        return align * (1 << (units - 1).bit_length())

    # ------------------------------------------------------- dim-table cache
    def _dim_device(self, dim) -> Dict[str, object]:
        """Device mirror of a DimTable, uploaded once per table and device
        (payload columns lazily) and cached on the table itself.  Locked:
        concurrent §4.3 probes of one table must not duplicate uploads (or
        double-count h2d bytes)."""
        key = str(self.device)
        cache = dim.__dict__.setdefault("_torch_device_cache", {})
        dev = cache.get(key)
        if dev is None:
            with self._dims_lock:
                dev = cache.get(key)
                if dev is None:
                    record_dim_upload(dim.keys.nbytes)
                    record_dim_upload(dim.qualifies.nbytes)
                    dev = cache[key] = {
                        "keys": self.asarray(dim.keys),
                        "qualifies": self.asarray(dim.qualifies),
                        "payload": {},
                    }
        return dev

    def _dim_payload(self, dim, col: str):
        dev = self._dim_device(dim)
        got = dev["payload"].get(col)
        if got is None:
            with self._dims_lock:
                got = dev["payload"].get(col)
                if got is None:
                    record_dim_upload(dim.payload[col].nbytes)
                    got = dev["payload"][col] = self.asarray(dim.payload[col])
        return got

    def _dim_hash(self, dim) -> Dict[str, object]:
        """Open-addressing hash table over the DimTable's keys: built once on
        host (``kernels/hash_join.hash_build``), its slot arrays uploaded
        once and packed on the device (``kernels/hash_join.pack_table``),
        and only the packed table kept, cached on the table itself like
        ``_dim_device``."""
        key = str(self.device)
        cache = dim.__dict__.setdefault("_torch_hash_cache", {})
        ht = cache.get(key)
        if ht is None:
            with self._dims_lock:
                ht = cache.get(key)
                if ht is None:
                    built = hash_build((np.asarray(dim.keys),))
                    for k in built["slot_keys"]:
                        record_dim_upload(np.asarray(k).nbytes)
                    record_dim_upload(np.asarray(built["slot_idx"]).nbytes)
                    ht = cache[key] = {
                        # packed on the device from the uploaded arrays,
                        # which are then dropped
                        "packed": pack_table(
                            tuple(self.asarray(k)
                                  for k in built["slot_keys"]),
                            self.asarray(built["slot_idx"])),
                        "max_probes": int(built["max_probes"]),
                    }
        return ht

    # ------------------------------------------------------------ expressions
    def _eval_expr(self, expr: Expr, cache, rows: slice):
        """Evaluate a DSL expression over exactly ``expr.columns()`` device
        columns of the requested row range."""
        view = self._view(cache)
        cols = {name: view.col(name)[rows] for name in expr.columns()}
        return expr.evaluate(ColumnsView(cols), slice(None))

    def _as_result(self, out, dtype=None):
        """A predicate/expression result as a tensor on this device (host
        results of opaque callables stay host, as in the reference)."""
        if isinstance(out, np.ndarray):
            return out.astype(bool) if dtype is torch.bool else out
        out = self._dev(out)
        return out.to(dtype) if dtype is not None else out

    # ------------------------------------------------------- operator kernels
    def filter_mask(self, predicate: Callable, cache, rows: slice):
        if isinstance(predicate, Expr) and predicate.columns():
            return self._eval_expr(predicate, cache, rows).to(torch.bool)
        return self._as_result(predicate(self._view(cache), rows), torch.bool)

    def eval_expression(self, fn: Callable, cache, rows: slice):
        if isinstance(fn, Expr) and fn.columns():
            return self._eval_expr(fn, cache, rows)
        return self._as_result(fn(self._view(cache), rows))

    def _probe(self, dim, vals: torch.Tensor, impl: str
               ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(idx, matched) of ``vals`` against a non-empty DimTable."""
        dev = self._dim_device(dim)
        if impl == "searchsorted":
            keys = dev["keys"]
            idx = torch.searchsorted(keys, vals.to(keys.dtype)).clamp_(
                0, keys.shape[0] - 1)
            matched = (keys[idx] == vals) & dev["qualifies"][idx]
            return idx, matched
        ht = self._dim_hash(dim)
        idx, found = hash_probe(ht["packed"],
                                (vals.to(torch.int32).contiguous(),),
                                ht["max_probes"], impl=impl)
        return idx, found & dev["qualifies"][idx.long()]

    def _probe_laddered(self, dim, vals: torch.Tensor, inject: bool
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
        """``_probe`` on the join route, down the join ladder on failure.
        ``inject``: the ``kernel`` fault site of an unfused Lookup (a fused
        segment's lookups are under its own dispatch's site)."""
        impl = self._join_route or config.join_impl()
        while True:
            try:
                if inject and faults.active():
                    faults.inject("kernel", component=f"join[{impl}]")
                return self._probe(dim, vals, impl)
            except BaseException as e:
                nxt = self._degraded_impl("join", impl, e)
                if nxt is None:
                    raise
                impl = nxt

    def searchsorted_probe(self, dim, vals):
        if len(dim.keys) == 0:
            n = len(vals)
            return (np.zeros(n, dtype=np.int64), np.zeros(n, dtype=bool))
        return self._probe_laddered(dim, self.asarray(vals), inject=True)

    def lookup_gather(self, dim, dim_col: str, idx, matched, default):
        payload = self._dim_payload(dim, dim_col)
        matched = self._dev(matched)
        fill = torch.tensor(default, dtype=payload.dtype, device=self.device)
        if payload.shape[0] == 0:
            return fill.expand(matched.shape[0]).clone()
        return torch.where(matched, payload[self._dev(idx).long()], fill)

    def groupby_reduce(self, keys: Sequence, values: Mapping[str, Tuple[object, str]],
                       n_rows: int) -> Tuple[List[object], Dict[str, object]]:
        for out, (col, op) in values.items():
            if op not in AGG_OPS:
                raise ValueError(f"unknown agg op {op!r} for {out!r}")
        n = int(n_rows)
        if not keys:
            aggs: Dict[str, object] = {}
            zeros = torch.zeros(n, dtype=torch.int32, device=self.device)
            for out, (col, op) in values.items():
                if op == "count":
                    aggs[out] = np.array([n], dtype=np.int64)
                    continue
                vals = self.asarray(col)
                if op in ("sum", "avg"):
                    s = segment_sum(
                        zeros, vals.to(torch.float32)[:, None].contiguous(),
                        1, impl=self._segsum_impl)[:, 0]
                    aggs[out] = s / n if op == "avg" else s
                elif op == "min":
                    aggs[out] = vals.min()[None]
                elif op == "max":
                    aggs[out] = vals.max()[None]
            return [], aggs
        keys_d = [self.asarray(k) for k in keys]
        impl = self._groupby_route or config.groupby_impl()
        while impl != "sort":
            try:
                if faults.active():
                    faults.inject("kernel", component=f"groupby[{impl}]")
                dense = self._groupby_dense(keys_d, values, n, impl)
            except BaseException as e:
                nxt = self._degraded_impl("groupby", impl, e)
                if nxt is None:
                    raise
                impl = nxt
                continue
            if dense is not None:
                return dense
            break          # key space disqualified: the sort route
        # sort route (its sums through the segment-sum kernel)
        order = self._lexsort(keys_d)
        sk = [k[order] for k in keys_d]
        boundary = torch.zeros(n, dtype=torch.bool, device=self.device)
        boundary[:1] = True
        for k in sk:
            boundary[1:] |= k[1:] != k[:-1]
        seg = (torch.cumsum(boundary, 0) - 1).to(torch.int32)
        starts_h = np.flatnonzero(self.to_host(boundary))
        n_groups = len(starts_h)
        counts_h = np.diff(np.append(starts_h, n))
        starts = self._dev(starts_h).long()
        group_cols = [k[starts] for k in sk]
        counts_d = self._dev(counts_h)
        aggs = {}
        for out, (col, op) in values.items():
            if op == "count":
                aggs[out] = counts_h.astype(np.int64)
                continue
            vals = self.asarray(col)[order]
            if op in ("sum", "avg"):
                s = segment_sum(seg, vals.to(torch.float32)[:, None].contiguous(),
                                n_groups, impl=self._segsum_impl)[:, 0]
                aggs[out] = s / counts_d if op == "avg" else s
            else:
                aggs[out] = self._segment_extreme(vals, seg, n_groups, op)
        return group_cols, aggs

    def _segment_extreme(self, vals: torch.Tensor, seg: torch.Tensor,
                         n_groups: int, op: str) -> torch.Tensor:
        """Per-group min or max; every group read must hold >= 1 row."""
        out = torch.zeros(n_groups, dtype=vals.dtype, device=self.device)
        return out.scatter_reduce_(0, seg.long(), vals,
                                   reduce="amin" if op == "min" else "amax",
                                   include_self=False)

    def _groupby_dense(self, keys_d: List, values: Mapping[str, Tuple[object, str]],
                       n: int, impl: str):
        """Radix-partitioned groupby over a dense composite key id — no sort.

        Each key column is offset to zero and the tuple is flattened into one
        dense int32 id (FIRST key column most significant, so ascending id
        order IS the lexicographic group order the sort route emits).  All
        sum/avg inputs stack into one [N, C] matrix and reduce in a single
        ``kernels/radix_groupby`` pass that also yields per-group counts;
        occupied cells are recovered from the counts (the only extra d2h) and
        group key columns are reconstructed arithmetically from the cell ids —
        the row data is never sorted and never leaves the device.

        Returns ``None`` when the key space doesn't qualify (empty input,
        non-integer keys, cell count past the kernel's bound, row count past
        float32-count exactness) — the caller falls back to the sort route.
        """
        if n == 0 or n >= self._DENSE_MAX_ROWS:
            return None
        if any(k.dtype not in _INT_DTYPES for k in keys_d):
            return None
        # one d2h for every column's min/max (stacked into a single transfer)
        dt = keys_d[0].dtype
        for k in keys_d[1:]:
            dt = torch.promote_types(dt, k.dtype)
        lo_hi = self.to_host(torch.stack(
            [torch.stack([k.min(), k.max()]).to(dt) for k in keys_d]))
        mins = [int(v) for v in lo_hi[:, 0]]
        ranges = [int(hi) - int(lo) + 1 for lo, hi in lo_hi]
        cells = 1
        for r in ranges:
            cells *= r
            if cells > self._DENSE_MAX_CELLS:
                return None
        strides = [1] * len(keys_d)
        for i in range(len(keys_d) - 2, -1, -1):
            strides[i] = strides[i + 1] * ranges[i + 1]
        ids = torch.zeros(n, dtype=torch.int32, device=self.device)
        for k, mn, st in zip(keys_d, mins, strides):
            ids = ids + (k.to(torch.int32) - mn) * st

        sum_outs = [out for out, (_, op) in values.items()
                    if op in ("sum", "avg")]
        mat = [self.asarray(values[out][0]).to(torch.float32)
               for out in sum_outs]
        vmat = (torch.stack(mat, dim=1) if mat
                else torch.zeros((n, 0), dtype=torch.float32,
                                 device=self.device))
        sums, counts = radix_groupby(ids, vmat.contiguous(), cells, impl=impl)
        counts_h = np.rint(self.to_host(counts)).astype(np.int64)  # one d2h
        occ = np.flatnonzero(counts_h)
        occ_d = self._dev(occ.astype(np.int32))
        group_cols = [((occ_d // st) % rg + mn).to(k.dtype)
                      for k, mn, st, rg in zip(keys_d, mins, strides, ranges)]
        counts_d = self._dev(counts_h[occ])
        aggs: Dict[str, object] = {}
        for out, (col, op) in values.items():
            if op == "count":
                aggs[out] = counts_h[occ]
            elif op in ("sum", "avg"):
                s = sums[occ_d.long(), sum_outs.index(out)]
                aggs[out] = s / counts_d if op == "avg" else s
            else:  # min / max: one segment reduce over the dense ids
                aggs[out] = self._segment_extreme(
                    self.asarray(col), ids, cells, op)[occ_d.long()]
        return group_cols, aggs

    def _lexsort(self, keys: Sequence[torch.Tensor]) -> torch.Tensor:
        """Stable order with ``keys[0]`` most significant: stable sorts
        from the last key to the first (torch has no lexsort)."""
        n = keys[0].shape[0]
        order = torch.arange(n, device=self.device)
        for k in reversed(list(keys)):
            order = order[torch.sort(k[order], stable=True).indices]
        return order

    def sort_rows(self, keys: Sequence, ascending: bool = True):
        # int32 like the reference's device order, so its d2h bytes agree
        order = self._lexsort([self.asarray(k) for k in keys]).to(torch.int32)
        return order if ascending else order.flip(0)

    # ------------------------------------------------------- segment fusion
    def compile_segment(self, segment) -> Callable:
        """One runner for the whole row-synchronized segment: the needed
        host input columns are packed into a single staging buffer (ONE h2d
        per chunk), every fused op runs on device with Lookups through the
        hash-probe kernel and the filter masks combined into one keep-mask
        (the only d2h per chunk), and the produced columns stay
        device-resident for downstream consumers."""
        return _TorchSegmentRunner(self, segment)


class _TorchSegmentRunner:
    """Eager executor for one FusedSegment on the torch backend.

    Deferred-mask semantics: row-synchronized ops are row-local by the
    paper's §3 classification (each output row depends only on its own input
    row), so filters are evaluated as masks over the full padded chunk, ANDed
    into one keep-mask, and applied once at write-back — values of surviving
    rows are identical to the eagerly-compacted unfused chain.

    The reference compiles one XLA program per staging layout; this runner
    keeps the same layout set and records ``segment_compiles`` exactly when
    the reference traces a new layout, so the counters of both agree."""

    def __init__(self, backend: TorchBackend, segment):
        self._bk = backend
        self.ops = list(segment.ops)
        #: external columns the kernel needs uploaded; None => every cache
        #: column (some op has an undeclared read set)
        self.inputs = segment.kernel_input_columns()
        self._written = segment_written_columns(self.ops)
        #: mask deferral: when the optimizer fused this chain through its
        #: terminal Aggregate, skip the per-chunk compact (the chunk's only
        #: d2h) and hand the keep-mask downstream as a sentinel column
        self.defer_mask = bool(getattr(segment, "defer_cols", None))
        self._layouts: set = set()
        self.kernel_calls = 0

    # ------------------------------------------------------------ the body
    def _lookup(self, dim, vals: torch.Tensor, return_cols: Dict[str, str],
                default, env) -> torch.Tensor:
        """The backend's probe and gather over the dim table's device
        mirror (uploaded once per table, cached on it).  The probe reads
        the backend's sticky join route on every call; on ``torch_cpu`` it
        steps down the join ladder on failure and the segment carries on in
        its runner (nothing is written back before the runner's end, so a
        step retries against unchanged state); on the card it raises."""
        bk = self._bk
        if len(dim.keys) == 0:               # degenerate dim table
            idx = torch.zeros(vals.shape[0], dtype=torch.int32,
                              device=bk.device)
            matched = torch.zeros(vals.shape[0], dtype=torch.bool,
                                  device=bk.device)
        else:
            idx, matched = bk._probe_laddered(dim, vals, inject=False)
        for out_name, dim_col in return_cols.items():
            env[out_name] = bk.lookup_gather(dim, dim_col, idx, matched,
                                             default)
        return matched

    def _run_ops(self, bucket: int, env: Dict[str, torch.Tensor]):
        bk = self._bk
        masks = []
        rows = slice(None)
        for op in self.ops:
            view = SegmentEnv(env.__getitem__, set(env), bucket)
            kind = op[0]
            if kind == "filter":
                masks.append(bk._as_result(op[1](view, rows), torch.bool))
            elif kind == "expr":
                env[op[1]] = bk._dev(op[2](view, rows))
            elif kind == "lookup":
                _, dim, key_col, return_cols, default, matched_flag = op
                matched = self._lookup(dim, env[key_col], return_cols,
                                       default, env)
                if matched_flag:
                    env[matched_flag] = matched
            elif kind == "project":
                keep = set(op[1])
                for k in list(env):
                    if k not in keep:
                        del env[k]
            elif kind == "convert":
                for col, dt in op[1].items():
                    env[col] = cast(env[col], dt)
            else:  # pragma: no cover
                raise ValueError(f"unknown segment op kind {kind!r}")
        keep_mask = None
        for m in masks:
            m = bk._dev(m)
            keep_mask = m if keep_mask is None else (keep_mask & m)
        out = {name: env[name] for name in self._written if name in env}
        return out, keep_mask

    # ------------------------------------------------------------ execution
    def __call__(self, cache) -> None:
        bk = self._bk
        n = cache.n
        bucket = bk.bucket_rows(n)

        names = (sorted(self.inputs) if self.inputs is not None
                 else sorted(cache.names))
        packable = []              # 1-D host columns -> one staging buffer
        env: Dict[str, torch.Tensor] = {}
        for name in names:
            v = cache.col(name)
            if is_host_column(v) and v.ndim == 1:
                packable.append((name, v))
            else:
                # device-resident (or multi-dim host) input: pad to the
                # bucket on device so every op sees the layout's row count
                dev = bk.asarray(np.ascontiguousarray(v)
                                 if is_host_column(v) else v)
                pad = bucket - n
                if pad:
                    dev = torch.cat([dev, dev.new_zeros((pad,) + dev.shape[1:])])
                env[name] = dev

        # pack every 1-D host input into ONE staging buffer (device dtypes,
        # zeroed pad tail) and upload it with a single h2d
        entries = []
        off = 0
        for name, v in packable:
            cd = device_dtype(v.dtype)
            entries.append((name, cd.str, off))
            off += bucket * cd.itemsize
        total = off
        if total:
            staging, root = GLOBAL_ARENA.acquire(np.uint8, (total,))
            for (name, v), (_, dtype_str, off) in zip(packable, entries):
                cd = np.dtype(dtype_str)
                dst = staging[off:off + bucket * cd.itemsize].view(cd)
                np.copyto(dst[:n], v, casting="same_kind")
                dst[n:] = 0
            # a blocking copy: the device buffer must not alias the staging
            # memory, which goes straight back to the arena
            t0 = time.perf_counter() if obs_trace.ACTIVE.get() else 0.0
            packed = torch.from_numpy(staging).to(bk.device, copy=True)
            record_transfer("h2d", total,
                            seconds=(time.perf_counter() - t0) if t0 else 0.0)
            GLOBAL_ARENA.release(root)
            # typed columns are views of the packed bytes (every region
            # starts at a multiple of 512 bytes, so each view is aligned)
            for name, dtype_str, off in entries:
                dt = np.dtype(dtype_str)
                raw = packed[off:off + bucket * dt.itemsize]
                env[name] = (raw != 0 if dt == np.bool_
                             else raw.view(torch_dtype(dt)))

        layout = (bucket, tuple(entries))
        if layout not in self._layouts:
            # the reference traces and compiles a fresh program for a layout
            # it has not seen: count it the same way
            self._layouts.add(layout)
            record_segment_compile()
        out_cols, keep_mask = self._run_ops(bucket, env)
        self.kernel_calls += 1

        final_live = segment_final_live(self.ops, cache.names)
        for name in self._written:
            if name in out_cols and name in final_live:
                cache.add_column(name, out_cols[name][:n])
        if self.defer_mask:
            # fused-through-Aggregate: the per-chunk compact (this chunk's
            # ONLY d2h) is deferred — the keep-mask rides along as a device
            # sentinel column and Aggregate.finish applies it once to the
            # merged cache
            if keep_mask is not None:
                cache.add_column(SEGMENT_KEEP_MASK, keep_mask[:n])
                final_live = final_live | {SEGMENT_KEEP_MASK}
            if final_live != set(cache.names):
                cache.keep_columns(
                    [k for k in cache.names if k in final_live])
            return
        if keep_mask is not None:
            cache.compact(keep_mask[:n])
        if final_live != set(cache.names):
            cache.keep_columns([k for k in cache.names if k in final_live])

    def stats(self) -> Dict[str, int]:
        return {"kernel_calls": self.kernel_calls,
                "layouts": len(self._layouts)}
