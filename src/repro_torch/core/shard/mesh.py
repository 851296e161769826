"""Mesh route: Aggregate second-stage merges on the backend's device.

``make_combiner(backend)`` builds the reducer the merge pass hands to
``Aggregate.shard_merge``.  The reference scatters the concatenated
per-shard partial rows over a device mesh and combines them with
collectives; the port runs on one device, so its combiner is a partial
reduction on the backend's own device:

- group ids come from ``np.unique`` over the key tuple on the host
  (lexicographic, matching the backend's group order);
- float sums go through ``kernels.segment_sum`` — on a CUDA device the
  hand-written ``csrc/segment_sum.cu``, which adds in a fixed order, so a
  repeated sharded run is bit-identical (``index_add_`` on CUDA float
  tensors adds with atomics, in an order that changes from run to run);
- integer sums are exact int64 sums;
- min and max use ``scatter_reduce`` (``amin`` / ``amax``).

Exactness contract (the reference's, with x64 off): outputs are cast back
to the stage-1 partial dtypes, and the combiner refuses (returns ``None``
— the caller falls back to the host ``reduce_partials``) any input whose
values would not round-trip through the 32-bit dtypes a device column
holds (``shared_cache.device_dtype``).

Counting: like the reference's combiner, its copies to and from the device
are not recorded in ``CacheStats``, so a sharded run's transfer counters
agree between the two packages.  The combiner counts them itself
(``copies``) and the shard runtime reports them on the ``shard-merge``
span.
"""
from __future__ import annotations

import threading
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from ...kernels.segment_sum import segment_sum
from .. import config
from ..shared_cache import device_dtype, host_to_device, tensor_to_host


def _round_trips(v: np.ndarray, cd: np.dtype) -> bool:
    if cd == v.dtype or v.size == 0:
        return True
    return bool(np.array_equal(v.astype(cd).astype(v.dtype), v))


class Combiner:
    """``combine(cat, group_names, ops)`` with the contract of
    ``merge.reduce_partials``, except that a call may return ``None``
    (unsafe dtypes) and the caller then uses the host reduce."""

    def __init__(self, device: torch.device):
        self.device = device
        self._lock = threading.Lock()
        #: copies made by this combiner (not in CacheStats, see above)
        self.copies = {"h2d": 0, "h2d_bytes": 0, "d2h": 0, "d2h_bytes": 0}

    def _count(self, direction: str, nbytes: int) -> None:
        with self._lock:
            self.copies[direction] += 1
            self.copies[direction + "_bytes"] += int(nbytes)

    def _up(self, a: np.ndarray) -> torch.Tensor:
        self._count("h2d", a.nbytes)
        return host_to_device(a, self.device)

    def _down(self, t: torch.Tensor) -> np.ndarray:
        out = tensor_to_host(t)
        self._count("d2h", out.nbytes)
        return out

    def _extreme(self, x: torch.Tensor, ids: torch.Tensor, n_groups: int,
                 op: str) -> torch.Tensor:
        """Per-group min or max; every group holds >= 1 row."""
        out = torch.zeros(n_groups, dtype=x.dtype, device=self.device)
        return out.scatter_reduce_(0, ids, x,
                                   reduce="amin" if op == "min" else "amax",
                                   include_self=False)

    def __call__(self, cat: Dict[str, np.ndarray], group_names: Sequence[str],
                 ops: Dict[str, str]
                 ) -> Optional[Tuple[list, Dict[str, np.ndarray]]]:
        keys = [np.asarray(cat[g]) for g in group_names]
        vals = {p: np.asarray(cat[p]) for p in ops}
        n = len(next(iter(vals.values()))) if vals else 0
        if n == 0:
            return None
        for arr in (*keys, *vals.values()):
            if arr.dtype.kind not in "iufb":
                return None
            if not _round_trips(arr, device_dtype(arr.dtype)):
                return None
        if keys:
            uniq, inv = np.unique(np.stack(keys, axis=1), axis=0,
                                  return_inverse=True)
            n_groups = len(uniq)
            group_cols = [uniq[:, j].astype(k.dtype, copy=False)
                          for j, k in enumerate(keys)]
        else:
            inv, n_groups, group_cols = np.zeros(n, np.int64), 1, []
        ids = self._up(inv.reshape(-1).astype(np.int32))
        part_cols: Dict[str, np.ndarray] = {}
        # float sums: one segment-sum launch over all their columns
        fsum = [p for p, op in ops.items()
                if op == "sum" and vals[p].dtype.kind == "f"]
        if fsum:
            mat = self._up(np.stack([vals[p].astype(np.float32, copy=False)
                                     for p in fsum], axis=1))
            sums = self._down(segment_sum(ids, mat, n_groups,
                                          impl=config.segsum_impl()))
            for j, p in enumerate(fsum):
                part_cols[p] = sums[:, j].astype(vals[p].dtype, copy=False)
        ids_l = ids.long()
        for p, op in ops.items():
            if p in part_cols:
                continue
            v = vals[p]
            x = self._up(v)
            if op == "sum":
                out = torch.zeros(n_groups, dtype=torch.int64,
                                  device=self.device).index_add_(
                                      0, ids_l, x.to(torch.int64))
            elif op in ("min", "max"):
                out = self._extreme(x, ids_l, n_groups, op)
            else:
                raise ValueError(f"unmergeable second-stage op {op!r}")
            part_cols[p] = self._down(out).astype(v.dtype, copy=False)
        return group_cols, {p: part_cols[p] for p in ops}


def make_combiner(backend) -> Optional[Combiner]:
    """The combiner on ``backend``'s device (the CPU for a backend without
    one), or ``None`` when that device is CUDA and no card is present."""
    device = torch.device(getattr(backend, "device", None) or "cpu")
    if device.type == "cuda" and not torch.cuda.is_available():
        return None
    return Combiner(device)
