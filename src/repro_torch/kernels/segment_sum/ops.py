"""Public segment-sum op: the CUDA kernel ``csrc/segment_sum.cu`` on a CUDA
tensor, the plain torch version on a CPU tensor.

It replaces the TPU kernel ``repro/kernels/segment_sum/kernel.py``:
``_segment_sum_kernel`` / ``segment_sum_pallas``.  Bound on the card:
bytes (ids and values read once, sums written once).  It runs the radix
groupby's deterministic partitioned reduction without the counts column
(``csrc/grouped_sum.cuh``), so sums are bit-identical from run to run.  Its
time, launches and bound on the H100 are in PERF.md."""
from __future__ import annotations

import torch

from .. import _cuda, _grouped_sum
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
    device = seg_ids.device
    _cuda.require(seg_ids, "seg_ids", torch.int32, 1, device)
    _cuda.require(values, "values", torch.float32, 2, device)
    n, c = values.shape
    if seg_ids.shape[0] != n:
        raise ValueError(f"seg_ids has {seg_ids.shape[0]} rows, values {n}")
    n_groups = int(n_groups)
    out = torch.empty((n_groups, c), dtype=torch.float32, device=device)
    if n_groups == 0 or c == 0:
        return out.zero_()
    p = _grouped_sum.plan(n, n_groups, c)
    iws, fws = _grouped_sum.workspace(p, device)
    lib = _cuda.library()
    with torch.cuda.device(device):
        _cuda.count_launch("segment_sum")
        rc = lib.repro_segment_sum(seg_ids.data_ptr(), values.data_ptr(), n,
                                   c, n_groups, p.rows_per_block, p.n_slices,
                                   iws.data_ptr(), fws.data_ptr(),
                                   out.data_ptr(), _cuda.stream_ptr(seg_ids))
    _cuda.check(rc, "segment_sum")
    return out
