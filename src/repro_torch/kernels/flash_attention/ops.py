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
H100 are in PERF.md.

Gradients.  The reference has no backward kernel and cannot differentiate
through its Pallas kernel: its trainer takes ``jax.grad`` of the plain
attention.  Here a CUDA tensor that needs a gradient goes through
``FlashAttentionFunction``: the forward is the kernel, and the backward
recomputes the plain version (``flash_attention_ref``) under autograd and
returns its gradients, which is the reference's gradient by design.  On
the card that backward and the tests are the only callers of the plain
version (``chip_smoke.py`` times it beside the kernel).

The forward is the op ``torch.ops.repro_torch.flash_attention``: on the
card its implementation is ``flash_attention_cuda``; on meta tensors a fake
implementation gives the output's shape and dtype, so a trace
(``launch/dryrun.py``) never runs the plain version's full score matrix;
its FLOP formula (``torch.utils.flop_counter``) is the work the kernel
does, 4·hd a (q, k) pair the mask allows, a query head."""
from __future__ import annotations

import math

import numpy as np
import torch
from torch.utils.flop_counter import register_flop_formula

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

    impl: 'auto' (the kernel for CUDA tensors, its fake implementation
    for meta tensors, the plain version for CPU tensors), 'cuda' (the
    kernel or its fake; anything else raises) or 'reference' (the plain
    version on any device)."""
    if impl == "reference" or (impl == "auto"
                               and q.device.type == "cpu"):
        return flash_attention_ref(q, k, v, causal=causal, window=window,
                                   softcap=softcap)
    if impl not in ("auto", "cuda"):
        raise ValueError(f"unknown flash_attention impl {impl!r}")
    # the op on the card and on meta tensors; elsewhere the launch itself,
    # which raises on a CPU tensor
    fwd = (_flash_op if q.device.type in ("cuda", "meta")
           else flash_attention_cuda)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return FlashAttentionFunction.apply(q, k, v, causal, window, softcap,
                                            fwd)
    return fwd(q, k, v, causal=causal, window=window, softcap=softcap)


class FlashAttentionFunction(torch.autograd.Function):
    """``forward_fn``'s attention with the plain version's gradient.

    ``apply(q, k, v, causal, window, softcap, forward_fn)``: the forward
    calls ``forward_fn(q, k, v, causal=, window=, softcap=)`` (the kernel,
    ``flash_attention_cuda``; the CPU tests pass the plain version) and
    saves q, k and v with ``save_for_backward``, so that
    ``torch.utils.checkpoint`` drops them and recomputes the forward (the
    kernel again) in the backward.  The backward recomputes
    ``flash_attention_ref`` on them under autograd: the scores
    [B, Kh, G, Sq, Skv] in fp32 exist for one layer at a time."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, softcap, forward_fn):
        ctx.save_for_backward(q, k, v)
        ctx.options = dict(causal=causal, window=window, softcap=softcap)
        return forward_fn(q, k, v, **ctx.options)

    @staticmethod
    def backward(ctx, grad_out):
        needs = ctx.needs_input_grad[:3]
        with torch.enable_grad():
            qkv = [t.detach().requires_grad_(need)
                   for t, need in zip(ctx.saved_tensors, needs)]
            out = flash_attention_ref(*qkv, **ctx.options)
            grads = iter(torch.autograd.grad(
                out, [t for t in qkv if t.requires_grad], grad_out))
        return tuple(next(grads) if need else None for need in needs) + (
            None,) * 4


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         causal: bool = True, window: int = 0,
                         softcap: float = 0.0) -> torch.Tensor:
    """Launch the kernel for q's dtype (bf16 or fp32, contiguous, 16-byte
    aligned: both kernels copy rows in 16-byte pieces with cp.async)."""
    _check_shapes(q, k, v)
    B, Sq, Kh, G, hd = q.shape
    Skv = k.shape[1]
    _cuda.require(q, "q", q.dtype, 5)
    for name, t in (("k", k), ("v", v)):
        _cuda.require(t, name, q.dtype, 4, q.device)
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


def _check_shapes(q, k, v) -> None:
    """What both the kernel and its fake implementation refuse."""
    if q.dtype not in _ENTRY:
        raise TypeError(f"flash_attention takes bfloat16 or float32, got "
                        f"{q.dtype}")
    B, Sq, Kh, G, hd = q.shape
    Skv = k.shape[1]
    if hd not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head dim {hd} is not one of "
                         f"{HEAD_DIMS}")
    for name, t in (("k", k), ("v", v)):
        if tuple(t.shape) != (B, Skv, Kh, hd):
            raise ValueError(f"flash_attention: {name} has shape "
                             f"{tuple(t.shape)}, expected {(B, Skv, Kh, hd)}")


# the op, defined with torch.library's low-level API: a Python kernel on
# the card and a fake one on meta tensors (``torch.library.custom_op``
# wraps each call in an autograd kernel and an aliasing check of its own,
# Python a launch that showed in the card's timings)
_LIB = torch.library.Library("repro_torch", "FRAGMENT")
_LIB.define("flash_attention(Tensor q, Tensor k, Tensor v, bool causal, "
            "int window, float softcap) -> Tensor")
_LIB.impl("flash_attention",
          lambda q, k, v, causal, window, softcap: flash_attention_cuda(
              q, k, v, causal=causal, window=window, softcap=softcap),
          "CUDA")


@torch.library.register_fake("repro_torch::flash_attention", lib=_LIB)
def _flash_attention_fake(q, k, v, causal, window, softcap):
    _check_shapes(q, k, v)
    return torch.empty_like(q)


def _flash_op(q, k, v, causal=True, window=0, softcap=0.0):
    return torch.ops.repro_torch.flash_attention.default(
        q, k, v, bool(causal), int(window or 0), float(softcap or 0.0))


def allowed_pairs(Sq: int, Skv: int, causal: bool, window: int) -> int:
    """(q, k) pairs the mask allows (query i, key j: j <= i when causal,
    j > i - window with a window): the blocks the kernel computes."""
    q = np.arange(Sq, dtype=np.int64)
    hi = np.minimum(Skv - 1, q) if causal else np.full(Sq, Skv - 1)
    lo = np.maximum(0, q - window + 1) if window > 0 else np.zeros(Sq,
                                                                  np.int64)
    return int(np.maximum(0, hi - lo + 1).sum())


@register_flop_formula(torch.ops.repro_torch.flash_attention)
def _flash_attention_flops(q_shape, k_shape, v_shape, causal, window,
                           softcap, out_shape=None, **kwargs) -> int:
    """Both products, 2·hd each, on every allowed pair of every query head
    (the softmax's elementwise work is not counted, as FlopCounterMode
    counts no elementwise op)."""
    B, Sq, Kh, G, hd = q_shape
    return 4 * B * Kh * G * hd * allowed_pairs(Sq, k_shape[1], causal,
                                               window)
