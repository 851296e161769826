"""Public selective-scan op: the CUDA kernel ``csrc/mamba_scan.cu`` on a
CUDA tensor, the plain torch version on a CPU tensor.

It replaces the TPU kernel ``repro/kernels/mamba_scan/kernel.py``:
``_mamba_scan_kernel`` / ``mamba_scan_pallas``.  Bound on the card: bytes
(delta, x and y stream through once; the [d, N] outer products stay in
registers); its time, launches and bound on the H100 are in PERF.md."""
from __future__ import annotations

from typing import Tuple

import torch

from .. import _cuda
from .ref import mamba_scan_ref

#: most state values a thread keeps in registers (csrc/mamba_scan.cu)
MAX_STATE = 32


def mamba_scan(delta: torch.Tensor, x: torch.Tensor, B: torch.Tensor,
               C: torch.Tensor, A: torch.Tensor, h0: torch.Tensor,
               impl: str = "auto") -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused selective scan.  delta, x: [Bt, T, d]; B, C: [Bt, T, N];
    A: [d, N]; h0: [Bt, d, N] -> (y [Bt, T, d], hT [Bt, d, N]), fp32.

    impl: 'auto' (the kernel for CUDA tensors, the plain version for CPU
    tensors), 'cuda' (the kernel; anything else raises) or 'reference' (the
    plain version on any device)."""
    if impl == "reference" or (impl == "auto" and not delta.is_cuda):
        return mamba_scan_ref(delta, x, B, C, A, h0)
    if impl not in ("auto", "cuda"):
        raise ValueError(f"unknown mamba_scan impl {impl!r}")
    return mamba_scan_cuda(delta, x, B, C, A, h0)


def mamba_scan_cuda(delta: torch.Tensor, x: torch.Tensor, B: torch.Tensor,
                    C: torch.Tensor, A: torch.Tensor, h0: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch ``csrc/mamba_scan.cu`` on contiguous float32 CUDA tensors."""
    Bt, T, d = delta.shape
    N = B.shape[-1]
    if not 1 <= N <= MAX_STATE:
        raise ValueError(f"mamba_scan: state size {N} is outside 1..{MAX_STATE}"
                         f" (the states of a channel live in registers)")
    f32 = torch.float32
    dev = delta.device
    _cuda.require(delta, "delta", f32, 3)
    want = {"x": (x, (Bt, T, d)), "B": (B, (Bt, T, N)), "C": (C, (Bt, T, N)),
            "A": (A, (d, N)), "h0": (h0, (Bt, d, N))}
    for name, (t, shape) in want.items():
        _cuda.require(t, name, f32, len(shape), dev)
        if tuple(t.shape) != shape:
            raise ValueError(f"mamba_scan: {name} has shape "
                             f"{tuple(t.shape)}, expected {shape}")
    y = torch.empty((Bt, T, d), dtype=f32, device=dev)
    hT = torch.empty((Bt, d, N), dtype=f32, device=dev)
    if Bt * d == 0:
        return y, hT
    lib = _cuda.library()
    with _cuda.device_guard(y):
        _cuda.count_launch("mamba_scan")
        rc = lib.repro_mamba_scan(
            delta.data_ptr(), x.data_ptr(), B.data_ptr(), C.data_ptr(),
            A.data_ptr(), h0.data_ptr(), y.data_ptr(), hT.data_ptr(), Bt, T,
            d, N, _cuda.stream_ptr(y))
    _cuda.check(rc, "mamba_scan")
    return y, hT
