"""Public segment-sum op: the CUDA kernel ``csrc/segment_sum.cu`` on a CUDA
tensor, the plain torch version on a CPU tensor.

It replaces the TPU kernel ``repro/kernels/segment_sum/kernel.py``:
``_segment_sum_kernel`` / ``segment_sum_pallas``, which reduced each row
tile with a one-hot matmul.  Bound on the card: bytes (ids and values read
once, sums written once), below one launch's cost at the SSB shapes.  It
runs the radix groupby's deterministic grouped sum without the counts
column (``csrc/grouped_sum.cuh``): the direct route, one launch, for a
small id space (Q1.1's global sum, G = 1: each warp sums its 32-row
batches over the lanes), the partitioned route for a large one (the sort
route's segments).  No float atomics, so sums are bit-identical from run
to run.  Its time, launches and bound on the H100 are in PERF.md."""
from __future__ import annotations

import torch

from .. import _grouped_sum
from .ref import segment_sum_ref


def segment_sum(seg_ids: torch.Tensor, values: torch.Tensor, n_groups: int,
                impl: str = "auto") -> torch.Tensor:
    """Grouped sum: ``out[g] = sum of values rows whose seg_id == g``.

    impl: 'auto' (the kernel for CUDA tensors, the plain version for CPU
    tensors), 'cuda' (the kernel; anything else raises) or 'reference' (the
    plain version on any device)."""
    if impl == "reference" or (impl == "auto" and not seg_ids.is_cuda):
        return segment_sum_ref(seg_ids, values, n_groups)
    if impl not in ("auto", "cuda"):
        raise ValueError(f"unknown segment_sum impl {impl!r}")
    return segment_sum_cuda(seg_ids, values, n_groups)


def segment_sum_cuda(seg_ids: torch.Tensor, values: torch.Tensor,
                     n_groups: int) -> torch.Tensor:
    """Launch ``csrc/segment_sum.cu``: seg_ids int32 [N], values float32
    [N, C], both contiguous CUDA tensors."""
    return _grouped_sum.launch("segment_sum", seg_ids, values, n_groups,
                               False)[0]
