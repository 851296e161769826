"""Plain torch versions of the selective scan: ``mamba_scan_ref``, a loop
over time steps (the oracle the kernel is held against), and
``mamba_scan_chunked``, the reference model's two-level chunked scan, which
the model's plain route and the scan's gradient run."""
from __future__ import annotations

from typing import Tuple

import torch
from torch.utils.checkpoint import checkpoint


def _steps(*seqs: torch.Tensor):
    """Per-step slices along dim 1.  One ``unbind`` a tensor: its backward
    stacks the steps' gradients once, where indexing step by step would
    add a zero gradient of the whole tensor a step (quadratic in T)."""
    return zip(*(t.unbind(1) for t in seqs))


def mamba_scan_ref(delta: torch.Tensor, x: torch.Tensor, B: torch.Tensor,
                   C: torch.Tensor, A: torch.Tensor, h0: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """delta, x: [Bt, T, d]; B, C: [Bt, T, N]; A: [d, N]; h0: [Bt, d, N].
    Returns (y [Bt, T, d], hT [Bt, d, N]), all fp32."""
    delta, x, B, C, A, h = (t.float() for t in (delta, x, B, C, A, h0))
    ys = []
    for d_t, x_t, B_t, C_t in _steps(delta, x, B, C):
        d_t = d_t[:, :, None]                            # [Bt, d, 1]
        dA = torch.exp(d_t * A)                          # [Bt, d, N]
        dBx = d_t * B_t[:, None, :] * x_t[:, :, None]
        h = dA * h + dBx
        ys.append(torch.einsum("bdn,bn->bd", h, C_t))
    y = (torch.stack(ys, dim=1) if ys
         else delta.new_zeros(delta.shape))
    return y, h


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
