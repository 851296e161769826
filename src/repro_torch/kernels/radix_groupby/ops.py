"""Public radix-groupby op: the CUDA kernel ``csrc/radix_groupby.cu`` on a
CUDA tensor, the plain torch version on a CPU tensor.

It replaces the TPU kernel ``repro/kernels/radix_groupby/kernel.py``:
``_radix_groupby_kernel`` / ``radix_groupby_pallas``, which reduced each
row tile with a one-hot matmul.  Bound on the card: bytes (ids and values
read once, sums and counts written once), below one launch's cost at the
SSB shapes.  A small id space (Q4.1: 147 cells) takes the direct route:
one cooperative launch in which warps add their rows into shared partials
and the block partials are summed in a fixed order after a grid-wide
barrier.  A large one takes the partitioned route: a stable counting sort
into 256-id partitions, then each partition's rows in row order.  No float
atomics, so sums are bit-identical from run to run
(``csrc/grouped_sum.cuh``, ``kernels/_grouped_sum.py``).  Its time,
launches and bound on the H100 are in PERF.md."""
from __future__ import annotations

from typing import Tuple

import torch

from .. import _grouped_sum
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
    return _grouped_sum.launch("radix_groupby", ids, values, n_groups, True)
