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
attention, whose gradient is the target.  Here a CUDA tensor that needs a
gradient goes through ``FlashAttentionFunction``: the forward kernel also
writes each row's base-2 log-sum-exp, and the backward is the kernel
``csrc/flash_attention_bwd.cu`` (``flash_attention_backward_cuda``:
FlashAttention-2's backward with P rebuilt from the log-sum-exp, bf16
products on the tensor cores, every sum in a fixed order).  The plain
versions (``flash_attention_ref``, ``flash_attention_backward_ref``) are
the oracles: on the card only the tests and ``chip_smoke.py`` call them.

Both directions are ops (``torch.ops.repro_torch.flash_attention``,
``flash_attention_with_lse``, ``flash_attention_backward``): on the card
their implementations are the kernels; on meta tensors fake
implementations give the outputs' shapes and dtypes, so a trace
(``launch/dryrun.py``) never runs a plain version's full score matrix;
their FLOP formulas (``torch.utils.flop_counter``) are the work the
kernels do: forward 4·hd a (q, k) pair the mask allows, a query head;
backward 14·hd (its two kernels rebuild S, and dP, each) plus 2·hd a
query row for D = rowsum(dO·O)."""
from __future__ import annotations

import math

import numpy as np
import torch
from torch.utils.flop_counter import register_flop_formula

from .. import _cuda
from .ref import flash_attention_ref

#: head dims both kernels are compiled for
HEAD_DIMS = (8, 16, 32, 64, 80, 96, 128, 256)
#: the C entry points for each dtype: forward, backward
_ENTRY = {torch.float32: "repro_flash_attention_fp32",
          torch.bfloat16: "repro_flash_attention_bf16"}
_BWD_ENTRY = {torch.float32: "repro_flash_attention_backward_fp32",
              torch.bfloat16: "repro_flash_attention_backward_bf16"}


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
    # the ops on the card and on meta tensors; elsewhere the launches
    # themselves, which raise on a CPU tensor
    on_op = q.device.type in ("cuda", "meta")
    fwd = _flash_op if on_op else flash_attention_cuda
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        bwd = _flash_backward_op if on_op else flash_attention_backward_cuda
        return FlashAttentionFunction.apply(q, k, v, causal, window, softcap,
                                            fwd, bwd)
    return fwd(q, k, v, causal=causal, window=window, softcap=softcap)


class FlashAttentionFunction(torch.autograd.Function):
    """``forward_fn``'s attention with ``backward_fn``'s gradient.

    ``apply(q, k, v, causal, window, softcap, forward_fn, backward_fn)``:
    the forward calls ``forward_fn(q, k, v, causal=, window=, softcap=,
    return_lse=True)`` -> (out, lse) (the kernel, ``flash_attention_cuda``;
    the CPU tests pass ``flash_attention_ref``) and saves q, k, v, out and
    lse with ``save_for_backward``, so that ``torch.utils.checkpoint``
    drops them and recomputes the forward (the kernel again) in the
    backward.  The backward calls ``backward_fn(q, k, v, out, lse, dout,
    causal=, window=, softcap=)`` -> (dq, dk, dv) (the kernel,
    ``flash_attention_backward_cuda``; the CPU tests pass
    ``flash_attention_backward_ref``), once, whichever inputs need a
    gradient."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, softcap, forward_fn,
                backward_fn):
        ctx.options = dict(causal=causal, window=window, softcap=softcap)
        ctx.backward_fn = backward_fn
        out, lse = forward_fn(q, k, v, return_lse=True, **ctx.options)
        ctx.save_for_backward(q, k, v, out, lse)
        return out

    @staticmethod
    def backward(ctx, grad_out):
        grads = ctx.backward_fn(*ctx.saved_tensors, grad_out.contiguous(),
                                **ctx.options)
        return tuple(g if need else None for g, need in zip(
            grads, ctx.needs_input_grad[:3])) + (None,) * 5


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         causal: bool = True, window: int = 0,
                         softcap: float = 0.0, return_lse: bool = False):
    """Launch the kernel for q's dtype (bf16 or fp32, contiguous, 16-byte
    aligned: both kernels copy rows in 16-byte pieces with cp.async).
    ``return_lse``: also have it write each row's base-2 log-sum-exp
    [B, Kh, G, Sq] fp32 (+inf for a row with no allowed key) and return
    (out, lse); the output's bits do not change."""
    _check_shapes(q, k, v)
    B, Sq, Kh, G, hd = q.shape
    Skv = k.shape[1]
    _check_operands(("q", q), ("k", k), ("v", v))
    out = torch.empty_like(q)
    lse = (torch.empty((B, Kh, G, Sq), dtype=torch.float32,
                       device=q.device) if return_lse else None)
    if out.numel():
        lib = _cuda.library()
        with _cuda.device_guard(q):
            _cuda.count_launch("flash_attention")
            rc = getattr(lib, _ENTRY[q.dtype])(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                lse.data_ptr() if return_lse else None, B, Sq, Skv, Kh, G,
                hd, int(bool(causal)), int(window or 0),
                float(softcap or 0.0), 1.0 / math.sqrt(hd),
                _cuda.stream_ptr(out))
        _cuda.check(rc, "flash_attention")
    return (out, lse) if return_lse else out


def flash_attention_backward_cuda(q, k, v, out, lse, dout, causal=True,
                                  window=0, softcap=0.0):
    """Launch ``csrc/flash_attention_bwd.cu`` for q's dtype: (dq, dk, dv)
    in the inputs' dtype from the forward's ``out`` and ``lse`` (as
    ``flash_attention_cuda(..., return_lse=True)`` gives them) and the
    output's gradient ``dout``, all contiguous CUDA tensors on q's
    device."""
    _check_shapes(q, k, v)
    B, Sq, Kh, G, hd = q.shape
    Skv = k.shape[1]
    _check_operands(("q", q), ("k", k), ("v", v), ("out", out),
                    ("dout", dout))
    for name, t in (("out", out), ("dout", dout)):
        if t.shape != q.shape:
            raise ValueError(f"flash_attention_backward: {name} has shape "
                             f"{tuple(t.shape)}, expected {tuple(q.shape)}")
    _cuda.require(lse, "lse", torch.float32, 4, q.device)
    if tuple(lse.shape) != (B, Kh, G, Sq):
        raise ValueError(f"flash_attention_backward: lse has shape "
                         f"{tuple(lse.shape)}, expected {(B, Kh, G, Sq)}")
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    if q.numel() == 0:
        return dq, dk.zero_(), dv.zero_()
    # D = rowsum(dout * out), fp32, one a query row
    d_row = torch.empty_like(lse)
    lib = _cuda.library()
    with _cuda.device_guard(q):
        _cuda.count_launch("flash_attention_backward")
        rc = getattr(lib, _BWD_ENTRY[q.dtype])(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr(), dout.data_ptr(), d_row.data_ptr(),
            dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), B, Sq, Skv, Kh, G,
            hd, int(bool(causal)), int(window or 0), float(softcap or 0.0),
            1.0 / math.sqrt(hd), _cuda.stream_ptr(dq))
    _cuda.check(rc, "flash_attention_backward")
    return dq, dk, dv


def _check_operands(*named) -> None:
    """Contiguous CUDA tensors of q's dtype on q's device, each starting
    on a 16-byte boundary (the kernels copy rows in 16-byte pieces)."""
    q = named[0][1]
    for name, t in named:
        _cuda.require(t, name, q.dtype, t.dim(), q.device)
        if t.data_ptr() % 16:
            raise ValueError(f"flash_attention: {name} must start on a "
                             f"16-byte boundary")


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


# the ops, defined with torch.library's low-level API: a Python kernel on
# the card and a fake one on meta tensors (``torch.library.custom_op``
# wraps each call in an autograd kernel and an aliasing check of its own,
# Python a launch that showed in the card's timings)
_LIB = torch.library.Library("repro_torch", "FRAGMENT")
_LIB.define("flash_attention(Tensor q, Tensor k, Tensor v, bool causal, "
            "int window, float softcap) -> Tensor")
_LIB.define("flash_attention_with_lse(Tensor q, Tensor k, Tensor v, "
            "bool causal, int window, float softcap) -> (Tensor, Tensor)")
_LIB.define("flash_attention_backward(Tensor q, Tensor k, Tensor v, "
            "Tensor out, Tensor lse, Tensor dout, bool causal, int window, "
            "float softcap) -> (Tensor, Tensor, Tensor)")
_LIB.impl("flash_attention",
          lambda q, k, v, causal, window, softcap: flash_attention_cuda(
              q, k, v, causal=causal, window=window, softcap=softcap),
          "CUDA")
_LIB.impl("flash_attention_with_lse",
          lambda q, k, v, causal, window, softcap: flash_attention_cuda(
              q, k, v, causal=causal, window=window, softcap=softcap,
              return_lse=True),
          "CUDA")
_LIB.impl("flash_attention_backward",
          lambda q, k, v, out, lse, dout, causal, window, softcap:
          flash_attention_backward_cuda(q, k, v, out, lse, dout,
                                        causal=causal, window=window,
                                        softcap=softcap),
          "CUDA")


@torch.library.register_fake("repro_torch::flash_attention", lib=_LIB)
def _flash_attention_fake(q, k, v, causal, window, softcap):
    _check_shapes(q, k, v)
    return torch.empty_like(q)


@torch.library.register_fake("repro_torch::flash_attention_with_lse",
                             lib=_LIB)
def _flash_attention_with_lse_fake(q, k, v, causal, window, softcap):
    _check_shapes(q, k, v)
    B, Sq, Kh, G, _ = q.shape
    return torch.empty_like(q), q.new_empty((B, Kh, G, Sq),
                                            dtype=torch.float32)


@torch.library.register_fake("repro_torch::flash_attention_backward",
                             lib=_LIB)
def _flash_attention_backward_fake(q, k, v, out, lse, dout, causal, window,
                                   softcap):
    _check_shapes(q, k, v)
    return torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)


def _flash_op(q, k, v, causal=True, window=0, softcap=0.0,
              return_lse=False):
    op = (torch.ops.repro_torch.flash_attention_with_lse if return_lse
          else torch.ops.repro_torch.flash_attention)
    return op.default(q, k, v, bool(causal), int(window or 0),
                      float(softcap or 0.0))


def _flash_backward_op(q, k, v, out, lse, dout, causal=True, window=0,
                       softcap=0.0):
    return torch.ops.repro_torch.flash_attention_backward.default(
        q, k, v, out, lse, dout, bool(causal), int(window or 0),
        float(softcap or 0.0))


def allowed_pairs(Sq: int, Skv: int, causal: bool, window: int) -> int:
    """(q, k) pairs the mask allows (query i, key j: j <= i when causal,
    j > i - window with a window): the blocks the kernel computes."""
    q = np.arange(Sq, dtype=np.int64)
    hi = np.minimum(Skv - 1, q) if causal else np.full(Sq, Skv - 1)
    lo = np.maximum(0, q - window + 1) if window > 0 else np.zeros(Sq,
                                                                  np.int64)
    return int(np.maximum(0, hi - lo + 1).sum())


@register_flop_formula([torch.ops.repro_torch.flash_attention,
                        torch.ops.repro_torch.flash_attention_with_lse])
def _flash_attention_flops(q_shape, k_shape, v_shape, causal, window,
                           softcap, out_shape=None, **kwargs) -> int:
    """Both products, 2·hd each, on every allowed pair of every query head
    (the softmax's elementwise work is not counted, as FlopCounterMode
    counts no elementwise op)."""
    B, Sq, Kh, G, hd = q_shape
    return 4 * B * Kh * G * hd * allowed_pairs(Sq, k_shape[1], causal,
                                               window)


@register_flop_formula(torch.ops.repro_torch.flash_attention_backward)
def _flash_attention_backward_flops(q_shape, k_shape, v_shape, o_shape,
                                    lse_shape, dout_shape, causal, window,
                                    softcap, out_shape=None, **kwargs) -> int:
    """The backward kernel's products, 2·hd each: on every allowed pair of
    every query head, S = QK^T and dP = dO V^T in both the dK/dV kernel and
    the dQ kernel, dV += P^T dO, dK += dS^T Q and dQ += dS K (14·hd); and
    D = rowsum(dO·O) on every query row (2·hd)."""
    B, Sq, Kh, G, hd = q_shape
    rows = B * Kh * G
    return rows * hd * (14 * allowed_pairs(Sq, k_shape[1], causal, window)
                        + 2 * Sq)
