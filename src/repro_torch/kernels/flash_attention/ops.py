"""Public flash-attention op: a CUDA kernel on a CUDA tensor, the plain
torch version on a CPU tensor.

It replaces the TPU kernel ``repro/kernels/flash_attention/kernel.py``:
``_flash_kernel`` / ``flash_attention_pallas``.  On the card the dtype
chooses the kernel: bf16 (the models' compute dtype) runs
``csrc/flash_attention_mma.cu``, whose two products are bf16 ``wgmma`` on
the tensor cores with fp32 accumulation; fp32 runs
``csrc/flash_attention.cu``, fp32 FMAs that keep the fp32 tolerance, laid
out as a register-tiled SIMT GEMM fed by a ``cp.async`` ring.
Operations, not bytes, bound both; their times, launches and bounds on the
H100 are in PERF.md."""
from __future__ import annotations

import math

import torch

from .. import _cuda
from .ref import flash_attention_ref

#: head dims both kernels are compiled for
HEAD_DIMS = (8, 16, 32, 64, 80, 96, 128, 256)
#: the C entry point for each dtype
_ENTRY = {torch.float32: "repro_flash_attention_fp32",
          torch.bfloat16: "repro_flash_attention_bf16"}


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
    """Launch the kernel for q's dtype (bf16 or fp32, contiguous, 16-byte
    aligned: both kernels copy rows in 16-byte pieces with cp.async)."""
    if q.dtype not in _ENTRY:
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
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.data_ptr() % 16:
            raise ValueError(f"flash_attention: {name} must start on a "
                             f"16-byte boundary")
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    lib = _cuda.library()
    with _cuda.device_guard(q):
        _cuda.count_launch("flash_attention")
        rc = getattr(lib, _ENTRY[q.dtype])(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, Sq,
            Skv, Kh, G, hd, int(bool(causal)), int(window or 0),
            float(softcap or 0.0), 1.0 / math.sqrt(hd),
            _cuda.stream_ptr(out))
    _cuda.check(rc, "flash_attention")
    return out
