"""Public radix-groupby op: the CUDA kernel ``csrc/radix_groupby.cu`` on a
CUDA tensor, the plain torch version on a CPU tensor.

It replaces the TPU kernel ``repro/kernels/radix_groupby/kernel.py``:
``_radix_groupby_kernel`` / ``radix_groupby_pallas``.  Bound on the card:
bytes (ids and values read once, sums and counts written once).  The
design moves rows into 256-id partitions with a stable counting sort and
reduces each partition in row order, so sums are bit-identical from run to
run (``csrc/grouped_sum.cuh``).  Its time, launches and bound on the H100
are in PERF.md."""
from __future__ import annotations

from typing import Tuple

import torch

from .. import _cuda, _grouped_sum
from .ref import radix_groupby_ref


def radix_groupby(ids: torch.Tensor, values: torch.Tensor, n_groups: int,
                  impl: str = "auto") -> Tuple[torch.Tensor, torch.Tensor]:
    """Grouped float32 sums + counts over dense group ids: out rows are the
    dense id cells (ascending), ``counts[g]`` tallies rows with
    ``ids == g`` (an id outside ``[0, n_groups)`` is padding).

    impl: 'auto' (the kernel for CUDA tensors, the plain version for CPU
    tensors), 'cuda' (the kernel; anything else raises) or 'reference' (the
    plain version on any device)."""
    if impl == "reference" or (impl == "auto" and not ids.is_cuda):
        return radix_groupby_ref(ids, values, n_groups)
    if impl not in ("auto", "cuda"):
        raise ValueError(f"unknown radix_groupby impl {impl!r}")
    return radix_groupby_cuda(ids, values, n_groups)


def radix_groupby_cuda(ids: torch.Tensor, values: torch.Tensor, n_groups: int
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch ``csrc/radix_groupby.cu``: ids int32 [N], values float32
    [N, C], both contiguous CUDA tensors."""
    device = ids.device
    _cuda.require(ids, "ids", torch.int32, 1, device)
    _cuda.require(values, "values", torch.float32, 2, device)
    n, c = values.shape
    if ids.shape[0] != n:
        raise ValueError(f"ids has {ids.shape[0]} rows, values {n}")
    n_groups = int(n_groups)
    sums = torch.empty((n_groups, c), dtype=torch.float32, device=device)
    counts = torch.empty(n_groups, dtype=torch.float32, device=device)
    if n_groups == 0:
        return sums, counts
    p = _grouped_sum.plan(n, n_groups, c + 1)
    iws, fws = _grouped_sum.workspace(p, device)
    lib = _cuda.library()
    with torch.cuda.device(device):
        _cuda.count_launch("radix_groupby")
        rc = lib.repro_radix_groupby(ids.data_ptr(), values.data_ptr(), n, c,
                                     n_groups, p.rows_per_block, p.n_slices,
                                     iws.data_ptr(), fws.data_ptr(),
                                     sums.data_ptr(), counts.data_ptr(),
                                     _cuda.stream_ptr(ids))
    _cuda.check(rc, "radix_groupby")
    return sums, counts
