"""Reference operator backend: plain numpy, bit-identical to the component
code it replaced (the inlined Filter/Lookup/Expression/Aggregate/Sort
bodies).  Every accelerated backend is property-tested against this one.

Segment fusion (``compile_segment``) uses the base class's composed host
runner unchanged: one vectorized pass over the fused op list with filter
masks applied eagerly, so a ``FusedSegment`` on this backend is the
loop-free reference the torch segment runner is checked against."""
from __future__ import annotations

from typing import Callable, Dict, List, Mapping, Sequence, Tuple

import numpy as np

from .base import AGG_OPS, Backend


class NumpyBackend(Backend):
    name = "numpy"
    batch_align = 1
    oracle_rtol = 1e-9
    #: host compaction is a free boolean index — nothing to defer, so the
    #: composed host runner keeps applying the keep-mask eagerly per chunk
    #: even when the optimizer marked the segment for mask deferral (output
    #: is byte-identical either way; only transfer counts differ on device
    #: backends)
    supports_segment_defer = False

    # ------------------------------------------------------------ array ops
    def asarray(self, x) -> np.ndarray:
        return np.asarray(x)

    def to_host(self, x) -> np.ndarray:
        return np.asarray(x)

    def concat(self, parts: Sequence) -> np.ndarray:
        return np.concatenate([np.asarray(p) for p in parts])

    # ------------------------------------------------------- operator kernels
    def filter_mask(self, predicate: Callable, cache, rows: slice) -> np.ndarray:
        return np.asarray(predicate(cache, rows), dtype=bool)

    def eval_expression(self, fn: Callable, cache, rows: slice) -> np.ndarray:
        return np.asarray(fn(cache, rows))

    def searchsorted_probe(self, dim, vals) -> Tuple[np.ndarray, np.ndarray]:
        return dim.probe(np.asarray(vals))

    def lookup_gather(self, dim, dim_col: str, idx, matched, default):
        got = dim.payload[dim_col][np.asarray(idx)]
        return np.where(np.asarray(matched), got, np.asarray(default, got.dtype))

    def groupby_reduce(self, keys: Sequence, values: Mapping[str, Tuple[object, str]],
                       n_rows: int) -> Tuple[List[np.ndarray], Dict[str, np.ndarray]]:
        for out, (col, op) in values.items():
            if op not in AGG_OPS:
                raise ValueError(f"unknown agg op {op!r} for {out!r}")
        n = int(n_rows)
        if not keys:
            # global aggregation: one group over all rows
            aggs: Dict[str, np.ndarray] = {}
            for out, (col, op) in values.items():
                vals = np.asarray(col)
                if op == "count":
                    aggs[out] = np.array([n], dtype=np.int64)
                elif op == "sum":
                    aggs[out] = np.array([vals.astype(np.float64).sum()])
                elif op == "avg":
                    aggs[out] = np.array([vals.astype(np.float64).mean()])
                elif op == "min":
                    aggs[out] = np.array([vals.min()])
                elif op == "max":
                    aggs[out] = np.array([vals.max()])
            return [], aggs
        keys = [np.asarray(k) for k in keys]
        order = np.lexsort(keys[::-1])
        sk = [k[order] for k in keys]
        boundary = np.zeros(n, dtype=bool)
        boundary[0] = True
        for k in sk:
            boundary[1:] |= k[1:] != k[:-1]
        starts = np.flatnonzero(boundary)
        counts = np.diff(np.append(starts, n))
        group_cols = [k[starts] for k in sk]
        aggs = {}
        for out, (col, op) in values.items():
            if op == "count":
                aggs[out] = counts.astype(np.int64)
                continue
            vals = np.asarray(col)[order]
            if op in ("sum", "avg"):
                acc = np.add.reduceat(vals.astype(np.float64), starts)
                aggs[out] = acc / counts if op == "avg" else acc
            elif op == "min":
                aggs[out] = np.minimum.reduceat(vals, starts)
            elif op == "max":
                aggs[out] = np.maximum.reduceat(vals, starts)
        return group_cols, aggs

    def sort_rows(self, keys: Sequence, ascending: bool = True) -> np.ndarray:
        order = np.lexsort([np.asarray(k) for k in keys][::-1])
        return order if ascending else order[::-1]
