"""Public selective-scan op: the CUDA kernel ``csrc/mamba_scan.cu`` on a
CUDA tensor, the plain torch version on a CPU tensor.

It replaces the TPU kernel ``repro/kernels/mamba_scan/kernel.py``:
``_mamba_scan_kernel`` / ``mamba_scan_pallas``.  Bound on the card: one
exp per (b, t, c, n) on the special-function units, above the bytes of
delta, x and y (the [d, N] outer products stay in registers); its time,
launches and bound on the H100 are in PERF.md.

Gradients.  The reference has no backward kernel: its trainer takes
``jax.grad`` of the plain chunked scan.  Here a CUDA tensor that needs a
gradient goes through ``MambaScanFunction``: the forward is the kernel,
and the backward recomputes the plain chunked scan
(``mamba_scan_chunked``, a ``torch.utils.checkpoint`` a chunk) under
autograd and returns its gradients for delta, x, B, C, A and h0, which is
the reference's gradient by design.  That backward is a Python loop over
time steps and is slow on the card; PERF.md has its share of a training
step.  On the card it and the tests are the only callers of the plain
versions (``chip_smoke.py`` times ``mamba_scan_ref`` beside the kernel).

The forward is the op ``torch.ops.repro_torch.mamba_scan``: on the card
its implementation is ``mamba_scan_cuda``; on meta tensors a fake
implementation gives (y, hT), so a trace (``launch/dryrun.py``) never runs
the plain version's loop over time steps.  On meta tensors the backward is
the fake op ``torch.ops.repro_torch.mamba_scan_backward``, whose gradients
are shaped as the inputs.  Both count FLOPs as ``FlopCounterMode`` counts
the plain versions: the contraction y_t = h_t·C_t, 2·d·N a step a
sequence (no elementwise op is counted, in the scan or elsewhere)."""
from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch.utils.flop_counter import register_flop_formula

from .. import _cuda
from .ref import mamba_scan_chunked, mamba_scan_ref

#: most state values a channel keeps in registers (csrc/mamba_scan.cu)
MAX_STATE = 32
#: threads a channel's states can be split over
LANES = (1, 2, 4)
#: channels (Bt * d) from which one lane a channel keeps the H100 busy: at
#: falcon-mamba-7b's width, 1 lane was fastest from Bt 4 (32,768 channels)
#: up, 2 at Bt 2 and 4 at Bt 1 (PERF.md)
FILL_CHANNELS = 32768


def default_lanes(Bt: int, d: int) -> int:
    """The fewest lanes a channel that give the card FILL_CHANNELS
    threads, at most 4."""
    for lanes in LANES[:-1]:
        if Bt * d * lanes >= FILL_CHANNELS:
            return lanes
    return LANES[-1]


def mamba_scan(delta: torch.Tensor, x: torch.Tensor, B: torch.Tensor,
               C: torch.Tensor, A: torch.Tensor, h0: torch.Tensor,
               impl: str = "auto", chunk: int = 128
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused selective scan.  delta, x: [Bt, T, d], both float32 or both
    bfloat16 (widened to float32, which is exact); B, C: [Bt, T, N];
    A: [d, N]; h0: [Bt, d, N], float32 -> (y [Bt, T, d], hT [Bt, d, N]),
    float32.

    impl: 'auto' (the kernel for CUDA tensors, its fake implementation
    for meta tensors, the plain version for CPU tensors), 'cuda' (the
    kernel or its fake; anything else raises) or 'reference' (the plain
    version on any device).  ``chunk``: the steps a chunk of the
    backward's recompute (``MambaScanFunction``)."""
    if impl == "reference" or (impl == "auto"
                               and delta.device.type == "cpu"):
        return mamba_scan_ref(delta, x, B, C, A, h0)
    if impl not in ("auto", "cuda"):
        raise ValueError(f"unknown mamba_scan impl {impl!r}")
    # the op on the card and on meta tensors; elsewhere the launch itself,
    # which raises on a CPU tensor
    fwd = (_mamba_scan_op if delta.device.type in ("cuda", "meta")
           else mamba_scan_cuda)
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (delta, x, B, C, A, h0)):
        return MambaScanFunction.apply(delta, x, B, C, A, h0, chunk, fwd)
    return fwd(delta, x, B, C, A, h0)


class MambaScanFunction(torch.autograd.Function):
    """``forward_fn``'s scan with the plain chunked scan's gradient.

    ``apply(delta, x, B, C, A, h0, chunk, forward_fn)`` -> (y, hT): the
    forward calls ``forward_fn(delta, x, B, C, A, h0)`` (the kernel,
    ``mamba_scan_cuda``; the CPU tests pass the plain version) and saves
    its six inputs with ``save_for_backward``, so that
    ``torch.utils.checkpoint`` drops them and recomputes the forward (the
    kernel again) in the backward.  The backward runs
    ``mamba_scan_chunked(..., chunk)`` on them under autograd, widening
    bf16 delta/x to fp32 as the kernel does; their gradients come back in
    the inputs' dtypes."""

    @staticmethod
    def forward(ctx, delta, x, B, C, A, h0, chunk, forward_fn):
        ctx.save_for_backward(delta, x, B, C, A, h0)
        ctx.chunk = chunk
        return forward_fn(delta, x, B, C, A, h0)

    @staticmethod
    def backward(ctx, grad_y, grad_hT):
        needs = ctx.needs_input_grad[:6]
        if grad_y.device.type == "meta":
            grads = torch.ops.repro_torch.mamba_scan_backward.default(
                *ctx.saved_tensors, grad_y, grad_hT, list(needs), ctx.chunk)
            return tuple(g if need else None
                         for g, need in zip(grads, needs)) + (None, None)
        with torch.enable_grad():
            inputs = [t.detach().requires_grad_(need)
                      for t, need in zip(ctx.saved_tensors, needs)]
            y, hT = mamba_scan_chunked(*inputs, chunk=ctx.chunk)
            grads = iter(torch.autograd.grad(
                (y, hT), [t for t in inputs if t.requires_grad],
                (grad_y, grad_hT)))
        return tuple(next(grads) if need else None for need in needs) + (
            None, None)


def mamba_scan_cuda(delta: torch.Tensor, x: torch.Tensor, B: torch.Tensor,
                    C: torch.Tensor, A: torch.Tensor, h0: torch.Tensor,
                    lanes: Optional[int] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch ``csrc/mamba_scan.cu`` on contiguous CUDA tensors: delta and
    x float32 or bfloat16, the rest float32.  ``lanes``: threads a
    channel's states are split over (``LANES``; by default
    ``default_lanes``)."""
    Bt, T, d = delta.shape
    N = B.shape[-1]
    if not 1 <= N <= MAX_STATE:
        raise ValueError(f"mamba_scan: state size {N} is outside 1..{MAX_STATE}"
                         f" (the states of a channel live in registers)")
    if lanes is None:
        lanes = default_lanes(Bt, d)
    if lanes not in LANES:
        raise ValueError(f"mamba_scan: lanes {lanes} is not one of {LANES}")
    f32 = torch.float32
    dev = delta.device
    if delta.dtype not in (f32, torch.bfloat16):
        raise TypeError(f"mamba_scan: delta must be float32 or bfloat16, got "
                        f"{delta.dtype}")
    _cuda.require(delta, "delta", delta.dtype, 3)
    want = {"x": (x, (Bt, T, d), delta.dtype), "B": (B, (Bt, T, N), f32),
            "C": (C, (Bt, T, N), f32), "A": (A, (d, N), f32),
            "h0": (h0, (Bt, d, N), f32)}
    for name, (t, shape, dtype) in want.items():
        _cuda.require(t, name, dtype, len(shape), dev)
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
            d, N, int(delta.dtype == torch.bfloat16), lanes,
            _cuda.stream_ptr(y))
    _cuda.check(rc, "mamba_scan")
    return y, hT


# the ops, defined with torch.library's low-level API (as the flash
# attention op): the forward a Python kernel on the card and a fake one on
# meta tensors; the backward a fake one only (off meta tensors the
# backward is the plain chunked scan's)
_LIB = torch.library.Library("repro_torch", "FRAGMENT")
_LIB.define("mamba_scan(Tensor delta, Tensor x, Tensor B, Tensor C, "
            "Tensor A, Tensor h0) -> (Tensor, Tensor)")
_LIB.define("mamba_scan_backward(Tensor delta, Tensor x, Tensor B, "
            "Tensor C, Tensor A, Tensor h0, Tensor grad_y, Tensor grad_hT, "
            "bool[] needs, int chunk) -> Tensor[]")
_LIB.impl("mamba_scan", lambda *args: mamba_scan_cuda(*args), "CUDA")


@torch.library.register_fake("repro_torch::mamba_scan", lib=_LIB)
def _mamba_scan_fake(delta, x, B, C, A, h0):
    Bt, T, d = delta.shape
    N = B.shape[-1]
    if tuple(h0.shape) != (Bt, d, N) or not 1 <= N <= MAX_STATE:
        raise ValueError(f"mamba_scan: h0 {tuple(h0.shape)} and N {N} do "
                         f"not fit delta {tuple(delta.shape)}")
    f32 = torch.float32
    return (delta.new_empty((Bt, T, d), dtype=f32),
            delta.new_empty((Bt, d, N), dtype=f32))


@torch.library.register_fake("repro_torch::mamba_scan_backward", lib=_LIB)
def _mamba_scan_backward_fake(delta, x, B, C, A, h0, grad_y, grad_hT,
                              needs, chunk):
    """``MambaScanFunction.backward`` on meta tensors: the six inputs'
    gradients, shaped and typed as the inputs (``needs`` and ``chunk``
    only enter the FLOP formula)."""
    return [torch.empty_like(t) for t in (delta, x, B, C, A, h0)]


def _mamba_scan_op(delta, x, B, C, A, h0):
    return torch.ops.repro_torch.mamba_scan.default(delta, x, B, C, A, h0)


@register_flop_formula(torch.ops.repro_torch.mamba_scan)
def _mamba_scan_flops(delta_shape, x_shape, B_shape, C_shape, A_shape,
                      h0_shape, out_shape=None, **kwargs) -> int:
    Bt, T, d = delta_shape
    return 2 * Bt * T * d * B_shape[-1]


@register_flop_formula(torch.ops.repro_torch.mamba_scan_backward)
def _mamba_scan_backward_flops(delta_shape, x_shape, B_shape, C_shape,
                               A_shape, h0_shape, grad_y_shape,
                               grad_hT_shape, needs, chunk, out_shape=None,
                               **kwargs) -> int:
    """The plain chunked backward's count in closed form, in contractions
    of 2·d·N a sequence: the forward of ``mamba_scan_chunked`` (T), each
    chunk's recompute, which stops once it has rebuilt what the backward
    saved, before the chunk's last contraction (T less one a chunk), then
    the contraction's backward, one product for h_t when any of delta, x,
    B, A or h0 needs a gradient and one for C_t when C does (T each)."""
    Bt, T, d = delta_shape
    dlt, dx, dB, dC, dA, dh0 = needs
    ch = min(chunk, T) or 1
    steps = T + (T - -(-T // ch)) + T * (int(any((dlt, dx, dB, dA, dh0)))
                                         + int(dC))
    return 2 * Bt * d * B_shape[-1] * steps
