"""Public selective-scan op: the CUDA kernel ``csrc/mamba_scan.cu`` on a
CUDA tensor, the plain torch version on a CPU tensor.

It replaces the TPU kernel ``repro/kernels/mamba_scan/kernel.py``:
``_mamba_scan_kernel`` / ``mamba_scan_pallas``.  Bound on the card: one
exp per (b, t, c, n) on the special-function units, above the bytes of
delta, x and y (the [d, N] outer products stay in registers); its time,
launches and bound on the H100 are in PERF.md.

Gradients.  The reference has no backward kernel: its trainer takes
``jax.grad`` of the plain chunked scan, whose gradient is the target.
Here a CUDA tensor that needs a gradient goes through
``MambaScanFunction``: the forward kernel also writes the state at every
``carry_steps(N)``-th step, and the backward is the kernels of
``csrc/mamba_scan_bwd.cu`` (``mamba_scan_backward_cuda``), which cut T
into time chunks of ``TIME_CHUNK`` steps: each chunk's gradient at its
start from a zero one at its end, the chunks' ends chained last to first,
then every chunk's walk from its own end in parallel (rebuilding its
states from the carries), every gradient summed in a fixed order.  The
plain versions (``mamba_scan_ref``, ``mamba_scan_backward_ref``) are the
oracles: on the card only the tests and ``chip_smoke.py`` call them.

Both directions are ops (``torch.ops.repro_torch.mamba_scan``,
``mamba_scan_with_carries``, ``mamba_scan_backward``): on the card their
implementations are the kernels; on meta tensors fake implementations give
the outputs, so a trace (``launch/dryrun.py``) never runs a plain
version's loop over time steps.  Their FLOP formulas count the
contractions the kernels do, as ``FlopCounterMode`` counts the plain
versions: forward y_t = h_t·C_t, 2·d·N a step a sequence; backward four,
8·d·N a step a sequence (no elementwise op is counted, in the scan or
elsewhere)."""
from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch.utils.flop_counter import register_flop_formula

from .. import _cuda
from .ref import carry_steps, mamba_scan_ref

#: most state values a channel keeps in registers (csrc/mamba_scan.cu)
MAX_STATE = 32
#: threads a channel's states can be split over
LANES = (1, 2, 4)
#: channels (Bt * d) from which one lane a channel keeps the H100 busy: at
#: falcon-mamba-7b's width, 1 lane was fastest from Bt 4 (32,768 channels)
#: up, 2 at Bt 2 and 4 at Bt 1 (PERF.md)
FILL_CHANNELS = 32768
#: channels a block of either kernel scans (its grid: (d / 64, Bt), the
#: backward's (d / 64, time chunks, Bt))
BLOCK_CHANNELS = 64
#: steps a time chunk of the backward (kTimeChunk): a whole number of carry
#: intervals for every state bucket
TIME_CHUNK = 128


def default_lanes(Bt: int, d: int) -> int:
    """The fewest lanes a channel that give the card FILL_CHANNELS
    threads, at most 4."""
    for lanes in LANES[:-1]:
        if Bt * d * lanes >= FILL_CHANNELS:
            return lanes
    return LANES[-1]


def mamba_scan(delta: torch.Tensor, x: torch.Tensor, B: torch.Tensor,
               C: torch.Tensor, A: torch.Tensor, h0: torch.Tensor,
               impl: str = "auto") -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused selective scan.  delta, x: [Bt, T, d], both float32 or both
    bfloat16 (widened to float32, which is exact); B, C: [Bt, T, N];
    A: [d, N]; h0: [Bt, d, N], float32 -> (y [Bt, T, d], hT [Bt, d, N]),
    float32.

    impl: 'auto' (the kernel for CUDA tensors, its fake implementation
    for meta tensors, the plain version for CPU tensors), 'cuda' (the
    kernel or its fake; anything else raises) or 'reference' (the plain
    version on any device)."""
    if impl == "reference" or (impl == "auto"
                               and delta.device.type == "cpu"):
        return mamba_scan_ref(delta, x, B, C, A, h0)
    if impl not in ("auto", "cuda"):
        raise ValueError(f"unknown mamba_scan impl {impl!r}")
    # the ops on the card and on meta tensors; elsewhere the launches
    # themselves, which raise on a CPU tensor
    on_op = delta.device.type in ("cuda", "meta")
    fwd = _mamba_scan_op if on_op else mamba_scan_cuda
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (delta, x, B, C, A, h0)):
        bwd = _mamba_scan_backward_op if on_op else mamba_scan_backward_cuda
        return MambaScanFunction.apply(delta, x, B, C, A, h0, fwd, bwd)
    return fwd(delta, x, B, C, A, h0)


class MambaScanFunction(torch.autograd.Function):
    """``forward_fn``'s scan with ``backward_fn``'s gradient.

    ``apply(delta, x, B, C, A, h0, forward_fn, backward_fn)`` -> (y, hT):
    the forward calls ``forward_fn(delta, x, B, C, A, h0, carries=True)``
    -> (y, hT, carries) (the kernel, ``mamba_scan_cuda``; the CPU tests
    pass ``mamba_scan_ref``) and saves its inputs and the carries with
    ``save_for_backward``, so that
    ``torch.utils.checkpoint`` drops them and recomputes the forward (the
    kernel again) in the backward.  The backward calls
    ``backward_fn(delta, x, B, C, A, h0, carries, grad_y, grad_hT)`` ->
    the six inputs' gradients in their dtypes (the kernel,
    ``mamba_scan_backward_cuda``; the CPU tests pass
    ``mamba_scan_backward_ref``), once, whichever inputs need one."""

    @staticmethod
    def forward(ctx, delta, x, B, C, A, h0, forward_fn, backward_fn):
        ctx.backward_fn = backward_fn
        y, hT, carries = forward_fn(delta, x, B, C, A, h0, carries=True)
        ctx.save_for_backward(delta, x, B, C, A, h0, carries)
        return y, hT

    @staticmethod
    def backward(ctx, grad_y, grad_hT):
        grads = ctx.backward_fn(*ctx.saved_tensors, grad_y.contiguous(),
                                grad_hT.contiguous())
        return tuple(g if need else None for g, need in zip(
            grads, ctx.needs_input_grad[:6])) + (None, None)


def _check_inputs(name, delta, x, B, C, A, h0, lanes):
    """What both kernels take: contiguous CUDA tensors, delta and x float32
    or bfloat16, the rest float32, N within MAX_STATE; returns
    (Bt, T, d, N, lanes)."""
    Bt, T, d = delta.shape
    N = B.shape[-1]
    if not 1 <= N <= MAX_STATE:
        raise ValueError(f"{name}: state size {N} is outside 1..{MAX_STATE}"
                         f" (the states of a channel live in registers)")
    if lanes is None:
        lanes = default_lanes(Bt, d)
    if lanes not in LANES:
        raise ValueError(f"{name}: lanes {lanes} is not one of {LANES}")
    f32 = torch.float32
    if delta.dtype not in (f32, torch.bfloat16):
        raise TypeError(f"{name}: delta must be float32 or bfloat16, got "
                        f"{delta.dtype}")
    _cuda.require(delta, "delta", delta.dtype, 3)
    _check_shapes(name, delta.device, x=(x, (Bt, T, d), delta.dtype),
                  B=(B, (Bt, T, N), f32), C=(C, (Bt, T, N), f32),
                  A=(A, (d, N), f32), h0=(h0, (Bt, d, N), f32))
    return Bt, T, d, N, lanes


def _check_shapes(name, dev, **want):
    for arg, (t, shape, dtype) in want.items():
        _cuda.require(t, arg, dtype, len(shape), dev)
        if tuple(t.shape) != shape:
            raise ValueError(f"{name}: {arg} has shape {tuple(t.shape)}, "
                             f"expected {shape}")


def _n_carries(T: int, N: int) -> int:
    return -(-T // carry_steps(N))


def mamba_scan_cuda(delta: torch.Tensor, x: torch.Tensor, B: torch.Tensor,
                    C: torch.Tensor, A: torch.Tensor, h0: torch.Tensor,
                    lanes: Optional[int] = None, carries: bool = False):
    """Launch ``csrc/mamba_scan.cu`` on contiguous CUDA tensors: delta and
    x float32 or bfloat16, the rest float32.  ``lanes``: threads a
    channel's states are split over (``LANES``; by default
    ``default_lanes``).  ``carries``: also have it write the state before
    every ``carry_steps(N)``-th step, [Bt, ceil(T / carry_steps(N)), d, N]
    fp32, and return (y, hT, carries); y and hT keep their bits."""
    Bt, T, d, N, lanes = _check_inputs("mamba_scan", delta, x, B, C, A, h0,
                                       lanes)
    f32, dev = torch.float32, delta.device
    y = torch.empty((Bt, T, d), dtype=f32, device=dev)
    hT = torch.empty((Bt, d, N), dtype=f32, device=dev)
    saved = (torch.empty((Bt, _n_carries(T, N), d, N), dtype=f32,
                         device=dev) if carries else None)
    if Bt * d:
        lib = _cuda.library()
        with _cuda.device_guard(y):
            _cuda.count_launch("mamba_scan")
            rc = lib.repro_mamba_scan(
                delta.data_ptr(), x.data_ptr(), B.data_ptr(), C.data_ptr(),
                A.data_ptr(), h0.data_ptr(), y.data_ptr(), hT.data_ptr(),
                saved.data_ptr() if carries else None, Bt, T, d, N,
                int(delta.dtype == torch.bfloat16), lanes,
                _cuda.stream_ptr(y))
        _cuda.check(rc, "mamba_scan")
    return (y, hT, saved) if carries else (y, hT)


def backward_workspace_floats(Bt: int, T: int, d: int, N: int) -> int:
    """fp32 words of the backward kernels' workspace: u (then each time
    chunk's end gradient), the decays and the dA partials, each
    [Bt, time chunks, d, N]; the dB and dC partials of each 64-channel
    block, each [Bt, d / 64, T, N] (summed in a fixed order by the last
    launch)."""
    chunks = -(-T // TIME_CHUNK)
    blocks = -(-d // BLOCK_CHANNELS)
    return 3 * Bt * chunks * d * N + 2 * Bt * blocks * T * N


def mamba_scan_backward_cuda(delta, x, B, C, A, h0, carries, grad_y,
                             grad_hT):
    """Launch ``csrc/mamba_scan_bwd.cu``: the six inputs' gradients (delta
    and x in their dtype, bf16 ones rounded from fp32; B, C, A, h0 fp32)
    from the forward's ``carries`` (as ``mamba_scan_cuda(...,
    carries=True)`` gives them, under any lane split) and the gradients of
    y and hT, all contiguous CUDA tensors.  Its own split of a channel's
    states is 4 lanes."""
    Bt, T, d, N, _ = _check_inputs("mamba_scan_backward", delta, x, B, C, A,
                                   h0, LANES[-1])
    f32, dev = torch.float32, delta.device
    _check_shapes("mamba_scan_backward", dev,
                  carries=(carries, (Bt, _n_carries(T, N), d, N), f32),
                  grad_y=(grad_y, (Bt, T, d), f32),
                  grad_hT=(grad_hT, (Bt, d, N), f32))
    ddelta, dx = torch.empty_like(delta), torch.empty_like(x)
    dB, dC = torch.empty_like(B), torch.empty_like(C)
    dA, dh0 = torch.empty_like(A), torch.empty_like(h0)
    if Bt * d == 0:
        return ddelta, dx, dB.zero_(), dC.zero_(), dA.zero_(), dh0
    lib = _cuda.library()
    ws = torch.empty(backward_workspace_floats(Bt, T, d, N), dtype=f32,
                     device=dev)
    with _cuda.device_guard(dB):
        _cuda.count_launch("mamba_scan_backward")
        rc = lib.repro_mamba_scan_backward(
            delta.data_ptr(), x.data_ptr(), B.data_ptr(), C.data_ptr(),
            A.data_ptr(), carries.data_ptr(), grad_y.data_ptr(),
            grad_hT.data_ptr(), ddelta.data_ptr(), dx.data_ptr(),
            dB.data_ptr(), dC.data_ptr(), dA.data_ptr(), dh0.data_ptr(),
            ws.data_ptr(), Bt, T, d, N, int(delta.dtype == torch.bfloat16),
            _cuda.stream_ptr(dB))
    _cuda.check(rc, "mamba_scan_backward")
    return ddelta, dx, dB, dC, dA, dh0


# the ops, defined with torch.library's low-level API (as the flash
# attention ops): Python kernels on the card, fake ones on meta tensors
_LIB = torch.library.Library("repro_torch", "FRAGMENT")
_LIB.define("mamba_scan(Tensor delta, Tensor x, Tensor B, Tensor C, "
            "Tensor A, Tensor h0) -> (Tensor, Tensor)")
_LIB.define("mamba_scan_with_carries(Tensor delta, Tensor x, Tensor B, "
            "Tensor C, Tensor A, Tensor h0) -> (Tensor, Tensor, Tensor)")
_LIB.define("mamba_scan_backward(Tensor delta, Tensor x, Tensor B, "
            "Tensor C, Tensor A, Tensor h0, Tensor carries, Tensor grad_y, "
            "Tensor grad_hT) -> Tensor[]")
_LIB.impl("mamba_scan", lambda *args: mamba_scan_cuda(*args), "CUDA")
_LIB.impl("mamba_scan_with_carries",
          lambda *args: mamba_scan_cuda(*args, carries=True), "CUDA")
_LIB.impl("mamba_scan_backward",
          lambda *args: list(mamba_scan_backward_cuda(*args)), "CUDA")


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


@torch.library.register_fake("repro_torch::mamba_scan_with_carries",
                             lib=_LIB)
def _mamba_scan_with_carries_fake(delta, x, B, C, A, h0):
    y, hT = _mamba_scan_fake(delta, x, B, C, A, h0)
    Bt, T, d = delta.shape
    N = B.shape[-1]
    return y, hT, hT.new_empty((Bt, _n_carries(T, N), d, N))


@torch.library.register_fake("repro_torch::mamba_scan_backward", lib=_LIB)
def _mamba_scan_backward_fake(delta, x, B, C, A, h0, carries, grad_y,
                              grad_hT):
    """The six inputs' gradients, shaped and typed as the inputs."""
    return [torch.empty_like(t) for t in (delta, x, B, C, A, h0)]


def _mamba_scan_op(delta, x, B, C, A, h0, carries=False):
    op = (torch.ops.repro_torch.mamba_scan_with_carries if carries
          else torch.ops.repro_torch.mamba_scan)
    return op.default(delta, x, B, C, A, h0)


def _mamba_scan_backward_op(*args):
    return torch.ops.repro_torch.mamba_scan_backward.default(*args)


@register_flop_formula([torch.ops.repro_torch.mamba_scan,
                        torch.ops.repro_torch.mamba_scan_with_carries])
def _mamba_scan_flops(delta_shape, x_shape, B_shape, C_shape, A_shape,
                      h0_shape, out_shape=None, **kwargs) -> int:
    Bt, T, d = delta_shape
    return 2 * Bt * T * d * B_shape[-1]


@register_flop_formula(torch.ops.repro_torch.mamba_scan_backward)
def _mamba_scan_backward_flops(delta_shape, x_shape, B_shape, C_shape,
                               A_shape, h0_shape, carries_shape,
                               grad_y_shape, grad_hT_shape, out_shape=None,
                               **kwargs) -> int:
    """The backward kernel's four contractions a step, 2·d·N each a
    sequence, as ``mamba_scan_backward_ref`` writes them: dC_t over the
    channels, sum_n g B_t (for dx and d delta), the rest of d delta over
    the states, dB_t over the channels.  The states' recompute from the
    carries and the dA, g and h updates are elementwise."""
    Bt, T, d = delta_shape
    return 8 * Bt * T * d * B_shape[-1]
