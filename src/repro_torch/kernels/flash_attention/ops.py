"""Public flash-attention op: the CUDA kernel ``csrc/flash_attention.cu`` on
a CUDA tensor, the plain torch version on a CPU tensor.

It replaces the TPU kernel ``repro/kernels/flash_attention/kernel.py``:
``_flash_kernel`` / ``flash_attention_pallas``.  On the card the first
kernel does its products as fp32 FMAs, so operations, not bytes, bound it;
its time, launches and bound on the H100 are in PERF.md."""
from __future__ import annotations

import math

import torch

from .. import _cuda
from .ref import flash_attention_ref

#: head dims the kernel is compiled for (csrc/flash_attention.cu)
HEAD_DIMS = (8, 16, 32, 64, 80, 96, 128, 256)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, window: int = 0,
                    softcap: float = 0.0, impl: str = "auto") -> torch.Tensor:
    """GQA flash attention.  q: [B, Sq, Kh, G, hd]; k, v: [B, Skv, Kh, hd].
    Returns [B, Sq, Kh, G, hd] in q's dtype.

    impl: 'auto' (the kernel for CUDA tensors, the plain version for CPU
    tensors), 'cuda' (the kernel; anything else raises) or 'reference' (the
    plain version on any device)."""
    if impl == "reference" or (impl == "auto" and not q.is_cuda):
        return flash_attention_ref(q, k, v, causal=causal, window=window,
                                   softcap=softcap)
    if impl not in ("auto", "cuda"):
        raise ValueError(f"unknown flash_attention impl {impl!r}")
    return flash_attention_cuda(q, k, v, causal=causal, window=window,
                                softcap=softcap)


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         causal: bool = True, window: int = 0,
                         softcap: float = 0.0) -> torch.Tensor:
    """Launch ``csrc/flash_attention.cu`` (bf16 or fp32, contiguous)."""
    if q.dtype not in _DTYPES:
        raise TypeError(f"flash_attention takes bfloat16 or float32, got "
                        f"{q.dtype}")
    B, Sq, Kh, G, hd = q.shape
    Skv = k.shape[1]
    if hd not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head dim {hd} is not one of "
                         f"{HEAD_DIMS}")
    _cuda.require(q, "q", q.dtype, 5)
    for name, t in (("k", k), ("v", v)):
        _cuda.require(t, name, q.dtype, 4, q.device)
        if tuple(t.shape) != (B, Skv, Kh, hd):
            raise ValueError(f"flash_attention: {name} has shape "
                             f"{tuple(t.shape)}, expected {(B, Skv, Kh, hd)}")
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    lib = _cuda.library()
    with torch.cuda.device(q.device):
        _cuda.count_launch("flash_attention")
        rc = lib.repro_flash_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, Sq,
            Skv, Kh, G, hd, int(bool(causal)), int(window or 0),
            float(softcap or 0.0), 1.0 / math.sqrt(hd), _DTYPES[q.dtype],
            _cuda.stream_ptr(out))
    _cuda.check(rc, "flash_attention")
    return out
