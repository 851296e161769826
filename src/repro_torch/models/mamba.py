"""Mamba-1 (selective SSM) block, in torch.

Recurrence (per channel c, state n):
    h_t = exp(dt_t * A) * h_{t-1} + dt_t * B_t * x_t
    y_t = C_t . h_t + D * x_t
with input-dependent dt (softplus), B, C from x_proj.  With
``cfg.mixer_norms`` (Jamba's mixer) x_proj's three outputs each pass a
weighted RMSNorm (``dt_norm``, ``b_norm``, ``c_norm``; eps ``norm_eps``)
before ``dt_proj`` and the scan.

Prefill and training (T > 1) run the selective-scan kernel
(``kernels/mamba_scan``) unless ``ssm_impl == "reference"``, which takes
the reference's chunked two-level scan in plain torch
(``mamba_scan_chunked``, each chunk rematerialised under autograd, as the
reference's ``jax.checkpoint`` of its chunk body).  With gradients the
kernel route goes through ``MambaScanFunction``: the kernel's forward,
which also saves the state every few steps, and the backward kernel, which
rebuilds the states from those carries.  Decode is a single recurrence
step on the carried (conv_state, h).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import functools

import torch
import torch.nn.functional as F
from torch.distributed.tensor import Partial, Shard

from ..kernels.mamba_scan import mamba_scan, mamba_scan_chunked
from .layers import Rules, dt, on_shards, rms_norm


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
    N, dtr, K = cfg.ssm_state, cfg.dt_rank, cfg.d_conv
    cdt = dt(cfg.compute_dtype)
    xc = x.to(cdt)

    xz = xc @ p["in_proj"].to(cdt)
    xin, z = xz.chunk(2, dim=-1)                      # [B, T, di] each
    xin = rules.cons(xin, "batch", None, "d_inner")
    # channel-local work on each rank's channels (on_shards; None on plain
    # tensors): batch over the data axes, d_inner over 'model'
    chan = rules.placements(xin, "batch", None, "d_inner")

    conv_w = p["conv_w"].to(cdt)                      # [K, di]
    w_pl = rules.placements(conv_w, None, "d_inner")
    if state is not None:
        conv_state, h0 = state
        xconv = on_shards(_causal_conv, (xin, conv_w, conv_state),
                          (chan, w_pl, chan), chan)
        new_conv_state = torch.cat([conv_state[:, 1:],
                                    xin.to(conv_state.dtype)], dim=1)
    else:
        xconv = on_shards(_causal_conv, (xin, conv_w), (chan, w_pl), chan)
        h0 = None                                     # zeros on each rank
        # for prefill -> decode; a copy: a view would hold the whole
        # sequence's xin until the sharded prefill stacks its caches
        new_conv_state = xin[:, -(K - 1):].clone()
    xconv = F.silu(xconv + p["conv_b"].to(cdt))

    # input-dependent dt, B, C
    # the channels' parts summed here: delta, B and C need the whole sums.
    # Each rank's part is its own local product: DTensor's rule for it
    # splits the rows of its backward over the data axes, which a
    # microbatch smaller than them (16 sequences over 32 ranks) cannot
    # take back to [B, S, .]
    xp = p["x_proj"].to(cdt)
    part = (None if chan is None else
            tuple(Partial() if isinstance(pl, Shard) and pl.dim == 2 else pl
                  for pl in chan))
    dbc = on_shards(torch.matmul, (xconv, xp),
                    (chan, rules.placements(xp, "d_inner", None)), part)
    dbc = rules.cons(dbc, "batch", None, None)
    dt_in, B_in, C_in = torch.split(dbc, [dtr, N, N], dim=-1)
    if cfg.mixer_norms:
        dt_in = rms_norm(dt_in, p["dt_norm"], cfg.norm_eps)
        B_in = rms_norm(B_in, p["b_norm"], cfg.norm_eps)
        C_in = rms_norm(C_in, p["c_norm"], cfg.norm_eps)
    delta = F.softplus(dt_in @ p["dt_proj"].to(cdt) + p["dt_bias"].to(cdt))
    A = -torch.exp(p["A_log"].float())                # [di, N]
    B32 = B_in.float()
    C32 = C_in.float()

    # the recurrence on each rank's channels: delta, x, y over d_inner;
    # B and C replicated over 'model'; A and the states over d_inner
    bc = rules.placements(B32, "batch", None, None)
    a_pl = rules.placements(A, "d_inner", None)
    st = rules.placements(delta.transpose(1, 2), "batch", "d_inner", None)
    rec_pl = (chan, chan, bc, bc, a_pl, None if h0 is None else st)
    if T == 1:
        y, hT = on_shards(_decode_step, (delta, xconv, B32, C32, A, h0),
                          rec_pl, (chan, st))
    elif cfg.ssm_impl not in ("auto", "cuda", "reference"):
        raise ValueError(f"unknown ssm_impl {cfg.ssm_impl!r}")
    else:
        dx = (delta, xconv)
        if cfg.ssm_impl != "reference":
            # delta and x go in bf16 when that is the compute dtype: the
            # kernel widens them in registers, bit for bit what widening
            # first gives
            kdt = cdt if cdt == torch.bfloat16 else torch.float32
            dx = (delta.to(kdt), xconv.to(kdt))
        y, hT = on_shards(functools.partial(_scan_local, cfg=cfg),
                          dx + (B32, C32, A, h0), rec_pl, (chan, st))

    # xconv is already in the compute dtype (the reference rounds x32 back)
    y = y.to(cdt) + xconv * p["D"].to(cdt)
    y = y * F.silu(z)
    out = rules.cons(y @ p["out_proj"].to(cdt), "batch", None, None)
    new_state = (new_conv_state, hT) if (state is not None or T > 1) else None
    return out, new_state


def _zeros_state(delta, N):
    """The initial state h0 [B, di, N] of a prefill: fp32 zeros."""
    return torch.zeros((delta.shape[0], delta.shape[2], N),
                       dtype=torch.float32, device=delta.device)


def _decode_step(delta, x, B32, C32, A, h0):
    """One recurrence step (T == 1) -> (y [B, 1, di], h [B, di, N]);
    ``h0`` None: zeros (a 1-token prefill)."""
    if h0 is None:
        h0 = _zeros_state(delta, B32.shape[-1])
    delta32, x32 = delta.float(), x.float()
    dA = torch.exp(delta32[:, 0, :, None] * A)        # [B, di, N]
    dBx = delta32[:, 0, :, None] * B32[:, 0, None, :] * x32[:, 0, :, None]
    h = dA * h0 + dBx
    return torch.einsum("bdn,bn->bd", h, C32[:, 0])[:, None], h


def _scan_local(delta, x, B, C, A, h0, *, cfg):
    """The scan (T > 1): the chunked plain scan under ``ssm_impl``
    'reference', else the kernel; ``h0`` None: zeros (a prefill)."""
    if h0 is None:
        h0 = _zeros_state(delta, B.shape[-1])
    if cfg.ssm_impl == "reference":
        return mamba_scan_chunked(delta, x, B, C, A, h0, chunk=cfg.ssm_chunk,
                                  fused=cfg.ssm_fused_ref)
    return mamba_scan(delta.contiguous(), x.contiguous(), B.contiguous(),
                      C.contiguous(), A.contiguous(), h0, impl=cfg.ssm_impl)
