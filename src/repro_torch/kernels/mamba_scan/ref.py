"""Plain torch versions of the selective scan: ``mamba_scan_ref``, a loop
over time steps (the oracle the kernel is held against),
``mamba_scan_backward_ref``, its gradient by the backward kernels'
reverse-time walk, and ``mamba_scan_chunked``, the reference model's
two-level chunked scan, which the model's plain route runs."""
from __future__ import annotations

from typing import Optional, Tuple, Union

import torch
from torch.utils.checkpoint import checkpoint


def carry_steps(N: int) -> int:
    """Steps between the chunk carries the forward saves for the backward
    (``csrc/mamba_scan_bwd.cu`` keeps a chunk's states and exps for 64
    channels in 128 KB of shared memory): 32 for N <= 8, 16 for N <= 16,
    8 for N <= 32 (the kernel's state buckets 4, 8, 16, 32)."""
    bucket = 4 if N <= 4 else 8 if N <= 8 else 16 if N <= 16 else 32
    return min(32, 256 // bucket)


def _steps(*seqs: torch.Tensor):
    """Per-step slices along dim 1.  One ``unbind`` a tensor: its backward
    stacks the steps' gradients once, where indexing step by step would
    add a zero gradient of the whole tensor a step (quadratic in T)."""
    return zip(*(t.unbind(1) for t in seqs))


def mamba_scan_ref(delta: torch.Tensor, x: torch.Tensor, B: torch.Tensor,
                   C: torch.Tensor, A: torch.Tensor, h0: torch.Tensor,
                   carries: bool = False, chunk: Optional[int] = None
                   ) -> Union[Tuple[torch.Tensor, torch.Tensor],
                              Tuple[torch.Tensor, torch.Tensor,
                                    torch.Tensor]]:
    """delta, x: [Bt, T, d]; B, C: [Bt, T, N]; A: [d, N]; h0: [Bt, d, N].
    Returns (y [Bt, T, d], hT [Bt, d, N]), all fp32.

    ``carries``: also return the state before every ``chunk``-th step
    (``carry_steps(N)`` by default, as the kernel saves them),
    [Bt, ceil(T / chunk), d, N] fp32, its first entry h0."""
    delta, x, B, C, A, h = (t.float() for t in (delta, x, B, C, A, h0))
    ch = chunk or carry_steps(B.shape[-1])
    ys, saved = [], []
    for t, (d_t, x_t, B_t, C_t) in enumerate(_steps(delta, x, B, C)):
        if carries and t % ch == 0:
            saved.append(h)
        d_t = d_t[:, :, None]                            # [Bt, d, 1]
        dA = torch.exp(d_t * A)                          # [Bt, d, N]
        dBx = d_t * B_t[:, None, :] * x_t[:, :, None]
        h = dA * h + dBx
        ys.append(torch.einsum("bdn,bn->bd", h, C_t))
    y = (torch.stack(ys, dim=1) if ys
         else delta.new_zeros(delta.shape))
    if not carries:
        return y, h
    return y, h, (torch.stack(saved, dim=1) if saved
                  else h.new_zeros((h.shape[0], 0) + h.shape[1:]))


def mamba_scan_backward_ref(delta: torch.Tensor, x: torch.Tensor,
                            B: torch.Tensor, C: torch.Tensor,
                            A: torch.Tensor, h0: torch.Tensor,
                            carries: torch.Tensor, dy: torch.Tensor,
                            dhT: torch.Tensor, chunk: Optional[int] = None,
                            time_chunk: Optional[int] = None
                            ) -> Tuple[torch.Tensor, ...]:
    """Gradients (d delta, dx, dB, dC, dA, dh0) of ``mamba_scan_ref``'s
    (y, hT) from their gradients ``dy`` [Bt, T, d] and ``dhT`` [Bt, d, N],
    by the backward kernel's walk: chunks of ``chunk`` steps last to first
    (``carry_steps(N)`` by default: the interval of ``carries``, the
    forward's states before each chunk), each one's states recomputed from
    its carry with a_t = exp(delta_t A), then back in time with g the
    gradient of the state after step t:

        g += C_t dy_t;  dC_t = sum_c h_t dy_t;  dB_t = sum_c g delta_t x_t
        dx_t = delta_t sum_n g B_t
        d delta_t = sum_n g (A a_t h_{t-1} + B_t x_t)
        dA += g delta_t a_t h_{t-1};  g = a_t g

    and dh0 = g at the end; dA, summed over time per batch row, is summed
    over the rows last.

    ``time_chunk`` (a multiple of ``chunk``): the kernels' time-parallel
    decomposition instead of one walk.  g is linear in the gradient at a
    time chunk's end, g_start = u + P g_end, so (1) each time chunk's sweep
    back from g = 0 gives u and the decay P = prod a_t, (2) the chunks'
    ends chain last to first from dhT, g_end(k) = u(k + 1) + P(k + 1)
    g_end(k + 1), and dh0 comes out there, (3) each time chunk walks as
    above from its own g_end; dA is summed over (batch row, time chunk).

    The four contractions are einsums, so ``FlopCounterMode`` counts what
    the kernel contracts: 2 Bt d N each a step (the rest is elementwise,
    which it does not count).  fp32; each gradient comes back in its
    input's dtype (bf16 delta and x: their fp32 gradients rounded)."""
    dts = [t.dtype for t in (delta, x, B, C, A, h0)]
    delta, x, B, C, A, dy, g = (t.float() for t in (delta, x, B, C, A, dy,
                                                    dhT))
    T = delta.shape[1]
    ch = chunk or carry_steps(B.shape[-1])
    grads = (torch.empty_like(delta), torch.empty_like(x),
             torch.empty_like(B), torch.empty_like(C))
    walk = (delta, x, B, C, A, carries, dy, ch, grads)
    n_carries = carries.shape[1]
    if time_chunk is None:
        g, dA = _walk(*walk, range(n_carries), g)
        dA = dA.sum(0)
    else:
        if time_chunk % ch:
            raise ValueError(f"time chunk {time_chunk} is not a whole "
                             f"number of carry intervals of {ch}")
        bounds = [(t0, min(T, t0 + time_chunk))
                  for t0 in range(0, T, time_chunk)]
        # 1. each time chunk's sweep from g = 0: u and the decay P
        sweeps = []
        for t0, t1 in bounds:
            u, p = torch.zeros_like(g), torch.ones_like(g)
            for t in reversed(range(t0, t1)):
                a = torch.exp(delta[:, t, :, None] * A)
                u = a * (u + C[:, t, None, :] * dy[:, t, :, None])
                p = p * a
            sweeps.append((u, p))
        # 2. the chunks' ends, last to first from dhT
        ends = [g] * len(bounds)
        for k in reversed(range(len(bounds))):
            ends[k] = g
            u, p = sweeps[k]
            g = u + p * g
        # 3. each time chunk's walk from its own end
        per = time_chunk // ch
        dA = torch.zeros_like(g[0])
        parts = [_walk(*walk, range(k * per, min(n_carries, (k + 1) * per)),
                       ends[k])[1] for k in range(len(bounds))]
        for b in range(g.shape[0]):
            for part in parts:
                dA = dA + part[b]
    return tuple(t.to(dt) for t, dt in zip(grads + (dA, g), dts))


def _walk(delta, x, B, C, A, carries, dy, ch, grads, intervals, g):
    """The walk back through carry ``intervals`` (last to first) from g,
    the gradient of the state after the last one's last step, writing
    d delta, dx, dB and dC of their steps into ``grads``.  Returns g before
    the first one and dA [Bt, d, N] over their steps, per batch row."""
    ddelta, dx, dB, dC = grads
    T = delta.shape[1]
    dA = torch.zeros_like(g)
    for k in reversed(intervals):
        t0, t1 = k * ch, min(T, (k + 1) * ch)
        h = carries[:, k].float()
        states = []
        for t in range(t0, t1):
            a = torch.exp(delta[:, t, :, None] * A)          # [Bt, d, N]
            states.append((h, a))
            h = a * h + (delta[:, t, :, None] * B[:, t, None, :]
                         * x[:, t, :, None])
        for t in reversed(range(t0, t1)):
            h_prev, a = states[t - t0]
            d_t, x_t, B_t, dy_t = delta[:, t], x[:, t], B[:, t], dy[:, t]
            g = g + C[:, t, None, :] * dy_t[:, :, None]
            dC[:, t] = torch.einsum("bdn,bd->bn", h, dy_t)
            g_b = torch.einsum("bdn,bn->bd", g, B_t)
            dx[:, t] = g_b * d_t
            ah = a * h_prev
            ddelta[:, t] = torch.einsum("bdn,bdn->bd", g, A * ah) + g_b * x_t
            dB[:, t] = torch.einsum("bdn,bd->bn", g, d_t * x_t)
            dA = dA + g * ah * d_t[:, :, None]
            h, g = h_prev, a * g
    return g, dA


def ssm_chunk_scan(h0: torch.Tensor, dA: torch.Tensor, dBx: torch.Tensor,
                   C: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Scan one chunk.  h0: [B, di, N]; dA, dBx: [B, T, di, N]; C: [B, T, N].
    Returns (h_T, y [B, T, di])."""
    h = h0
    ys = []
    for dA_t, dBx_t, C_t in _steps(dA, dBx, C):
        h = dA_t * h + dBx_t
        ys.append(torch.einsum("bdn,bn->bd", h, C_t))
    return h, torch.stack(ys, dim=1)


def ssm_chunk_scan_fused(h0: torch.Tensor, delta: torch.Tensor,
                         x: torch.Tensor, Bm: torch.Tensor, C: torch.Tensor,
                         A: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The same scan with the [B, di, N] outer products formed inside each
    step from the per-step slices (delta/x [B, di], B/C [B, N])."""
    h = h0
    ys = []
    for d_t, x_t, B_t, C_t in _steps(delta, x, Bm, C):
        d_t = d_t[:, :, None]
        dA_t = torch.exp(d_t * A)
        dBx_t = d_t * B_t[:, None, :] * x_t[:, :, None]
        h = dA_t * h + dBx_t
        ys.append(torch.einsum("bdn,bn->bd", h, C_t))
    return h, torch.stack(ys, dim=1)


def _scan_chunk(h, delta, x, B, C, A, fused: bool):
    if fused:
        return ssm_chunk_scan_fused(h, delta, x, B, C, A)
    dA = torch.exp(delta[..., None] * A)              # [B, ch, di, N]
    dBx = delta[..., None] * B[:, :, None, :] * x[..., None]
    return ssm_chunk_scan(h, dA, dBx, C)


def mamba_scan_chunked(delta: torch.Tensor, x: torch.Tensor, B: torch.Tensor,
                       C: torch.Tensor, A: torch.Tensor, h0: torch.Tensor,
                       chunk: int, fused: bool = False
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The reference model's chunked two-level scan
    (``repro/models/mamba.py``), on the arguments of ``mamba_scan_ref``:
    chunks of ``chunk`` steps, each scanned step by step (``fused``: with
    the outer products formed per step).  A short last chunk is scanned as
    it is (the reference pads it, and then fails).

    Under autograd each chunk runs under ``torch.utils.checkpoint``, the
    counterpart of the reference's ``jax.checkpoint`` of its chunk body:
    the backward keeps the chunk carries and recomputes one chunk's steps
    at a time, so a long sequence never holds every per-step state."""
    delta, x, B, C, A, h = (t.float() for t in (delta, x, B, C, A, h0))
    T = delta.shape[1]
    ch = min(chunk, T) or 1
    remat = torch.is_grad_enabled() and any(
        t.requires_grad for t in (delta, x, B, C, A, h))
    ys = []
    for t0 in range(0, T, ch):
        sl = slice(t0, t0 + ch)
        args = (h, delta[:, sl], x[:, sl], B[:, sl], C[:, sl], A, fused)
        if remat:
            h, yc = checkpoint(_scan_chunk, *args, use_reentrant=False)
        else:
            h, yc = _scan_chunk(*args)
        ys.append(yc)
    y = torch.cat(ys, dim=1) if ys else delta.new_zeros(delta.shape)
    return y, h
