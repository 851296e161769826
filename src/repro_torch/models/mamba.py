"""Mamba-1 (selective SSM) block, in torch.

Recurrence (per channel c, state n):
    h_t = exp(dt_t * A) * h_{t-1} + dt_t * B_t * x_t
    y_t = C_t . h_t + D * x_t
with input-dependent dt (softplus), B, C from x_proj.

Prefill and training (T > 1) run the selective-scan kernel
(``kernels/mamba_scan``) unless ``ssm_impl == "reference"``, which takes
the reference's chunked two-level scan in plain torch
(``mamba_scan_chunked``, each chunk rematerialised under autograd, as the
reference's ``jax.checkpoint`` of its chunk body).  With gradients the
kernel route goes through ``MambaScanFunction``: the kernel's forward, the
plain chunked scan's backward.  Decode is a single recurrence step on the
carried (conv_state, h).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..kernels.mamba_scan import mamba_scan, mamba_scan_chunked
from .layers import Rules, dt


def _causal_conv(x: torch.Tensor, w: torch.Tensor,
                 state: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Depthwise causal conv1d (cross-correlation, no flip).  x: [B, T, di];
    w: [K, di].  ``state``: [B, K-1, di] carried inputs for decode; without
    it the input is left-padded with K-1 zeros."""
    K = w.shape[0]
    if state is not None:
        x = torch.cat([state.to(x.dtype), x], dim=1)
    else:
        x = F.pad(x, (0, 0, K - 1, 0))
    out = F.conv1d(x.transpose(1, 2), w.t()[:, None, :], groups=w.shape[1])
    return out.transpose(1, 2)


def mamba_block(x: torch.Tensor, p: Dict[str, torch.Tensor], cfg,
                rules: Rules,
                state: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
                ) -> Tuple[torch.Tensor,
                           Optional[Tuple[torch.Tensor, torch.Tensor]]]:
    """x: [B, T, d].  ``state`` = (conv_state [B, K-1, di], h [B, di, N]) for
    decode (T == 1); None for prefill.  Returns (out, new_state)."""
    B, T, d = x.shape
    di, N, dtr, K = cfg.d_inner, cfg.ssm_state, cfg.dt_rank, cfg.d_conv
    cdt = dt(cfg.compute_dtype)
    xc = x.to(cdt)

    xz = xc @ p["in_proj"].to(cdt)
    xin, z = xz.chunk(2, dim=-1)                      # [B, T, di] each

    conv_w = p["conv_w"].to(cdt)                      # [K, di]
    if state is not None:
        conv_state, h0 = state
        xconv = _causal_conv(xin, conv_w, state=conv_state)
        new_conv_state = torch.cat([conv_state[:, 1:],
                                    xin.to(conv_state.dtype)], dim=1)
    else:
        xconv = _causal_conv(xin, conv_w)
        h0 = torch.zeros((B, di, N), dtype=torch.float32, device=x.device)
        new_conv_state = xin[:, -(K - 1):]            # for prefill -> decode
    xconv = F.silu(xconv + p["conv_b"].to(cdt))

    # input-dependent dt, B, C
    dbc = xconv @ p["x_proj"].to(cdt)
    dt_in, B_in, C_in = torch.split(dbc, [dtr, N, N], dim=-1)
    delta = F.softplus(dt_in @ p["dt_proj"].to(cdt) + p["dt_bias"].to(cdt))
    A = -torch.exp(p["A_log"].float())                # [di, N]
    B32 = B_in.float()
    C32 = C_in.float()

    if T == 1:
        delta32, x32 = delta.float(), xconv.float()
        dA = torch.exp(delta32[:, 0, :, None] * A)    # [B, di, N]
        dBx = (delta32[:, 0, :, None] * B32[:, 0, None, :]
               * x32[:, 0, :, None])
        h = dA * h0 + dBx
        y = torch.einsum("bdn,bn->bd", h, C32[:, 0])[:, None]
        hT = h
    elif cfg.ssm_impl in ("auto", "cuda"):
        # delta and x go in bf16 when that is the compute dtype: the kernel
        # widens them in registers, bit for bit what widening first gives
        kdt = cdt if cdt == torch.bfloat16 else torch.float32
        y, hT = mamba_scan(delta.to(kdt).contiguous(),
                           xconv.to(kdt).contiguous(),
                           B32.contiguous(), C32.contiguous(), A.contiguous(),
                           h0, impl=cfg.ssm_impl, chunk=cfg.ssm_chunk)
    elif cfg.ssm_impl != "reference":
        raise ValueError(f"unknown ssm_impl {cfg.ssm_impl!r}")
    else:
        # chunked two-level scan, each chunk rematerialised under autograd
        y, hT = mamba_scan_chunked(delta, xconv, B32, C32, A, h0,
                                   chunk=cfg.ssm_chunk,
                                   fused=cfg.ssm_fused_ref)

    # xconv is already in the compute dtype (the reference rounds x32 back)
    y = y.to(cdt) + xconv * p["D"].to(cdt)
    y = y * F.silu(z)
    out = y @ p["out_proj"].to(cdt)
    new_state = (new_conv_state, hT) if (state is not None or T > 1) else None
    return out, new_state
