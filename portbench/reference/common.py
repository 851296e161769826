"""Pieces the reference's model files share: the products in the
precision asked for, RMSNorm, the next-token loss, the linear recurrence
of a selective scan, and AdamW.

Precisions: ``"fp32"`` is float32 with TF32 off (``follow`` switches it
off); ``"fp8"`` rounds both operands of every product to float8 e4m3
(their gradients to e5m2) with a scale a tensor, and multiplies the
rounded values in float32: the control, a step below the bfloat16 the
configurations compute in.  A model file may take further values of
``prec`` of its own (``mamba_lm``'s scan variants) and compute its
products in float32 for them.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

_FMAX = {torch.float8_e4m3fn: 448.0, torch.float8_e5m2: 57344.0}


def _round(x: torch.Tensor, dtype) -> torch.Tensor:
    scale = _FMAX[dtype] / x.detach().abs().amax().clamp(min=1e-30)
    return (x * scale).to(dtype).to(torch.float32) / scale


class _Fp8Matmul(torch.autograd.Function):
    """``a @ b`` on operands rounded to e4m3; the incoming gradient
    rounded to e5m2 for both of its products."""

    @staticmethod
    def forward(ctx, a, b):
        qa = _round(a, torch.float8_e4m3fn)
        qb = _round(b, torch.float8_e4m3fn)
        ctx.save_for_backward(qa, qb)
        return qa @ qb

    @staticmethod
    def backward(ctx, g):
        qa, qb = ctx.saved_tensors
        qg = _round(g, torch.float8_e5m2)
        return qg @ qb.transpose(-1, -2), qa.transpose(-1, -2) @ qg


def matmul(a: torch.Tensor, b: torch.Tensor, prec: str) -> torch.Tensor:
    """``a @ b``: a 2-D ``b`` takes ``a`` of any rank; else both share
    their leading dims."""
    if prec == "fp32":
        return a @ b
    if prec != "fp8":
        raise ValueError(f"unknown precision {prec!r}")
    if b.dim() == 2:
        return _Fp8Matmul.apply(a.reshape(-1, a.shape[-1]), b).reshape(
            *a.shape[:-1], b.shape[-1])
    return _Fp8Matmul.apply(a, b)


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps) * w


def next_token_loss(logits: torch.Tensor, tokens: torch.Tensor
                    ) -> torch.Tensor:
    """Mean over every position but the last of logsumexp minus the logit
    of the next token."""
    lg = logits[:, :-1]
    tgt = tokens[:, 1:]
    nll = torch.logsumexp(lg, dim=-1) - lg.gather(-1, tgt[..., None])[..., 0]
    return nll.mean()


def _chunk(T: int) -> int:
    return next(c for c in (32, 16, 8, 4, 2, 1) if T % c == 0)


def _recurrence(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """H_t = a_t * H_{t-1} + b_t along dim 1 from H_{-1} = 0: inside
    chunks of C steps for all chunks at once, then the chunks' starts
    chained, then each chunk's start carried through it."""
    Bt, T = a.shape[:2]
    C = _chunk(T)
    rest = a.shape[2:]
    a_ = a.reshape(Bt, T // C, C, *rest)
    b_ = b.reshape(Bt, T // C, C, *rest)
    P = torch.empty_like(b_)
    Acum = torch.empty_like(a_)
    P[:, :, 0] = b_[:, :, 0]
    Acum[:, :, 0] = a_[:, :, 0]
    for j in range(1, C):
        torch.addcmul(b_[:, :, j], a_[:, :, j], P[:, :, j - 1],
                      out=P[:, :, j])
        torch.mul(Acum[:, :, j - 1], a_[:, :, j], out=Acum[:, :, j])
    starts = torch.zeros((Bt, T // C) + tuple(rest), dtype=a.dtype,
                         device=a.device)
    for c in range(1, T // C):
        torch.addcmul(P[:, c - 1, C - 1], Acum[:, c - 1, C - 1],
                      starts[:, c - 1], out=starts[:, c])
    P.addcmul_(Acum, starts[:, :, None])
    return P.reshape(a.shape)


class LinearRecurrence(torch.autograd.Function):
    """``apply(a, b)`` -> every state H [Bt, T, ...] of H_t = a_t * H_{t-1}
    + b_t, H_{-1} = 0.  The backward runs the same recurrence backwards
    in time: G_t = dH_t + a_{t+1} G_{t+1}; db = G, da_t = G_t H_{t-1}."""

    @staticmethod
    def forward(ctx, a, b):
        H = _recurrence(a, b)
        ctx.save_for_backward(a, H)
        return H

    @staticmethod
    def backward(ctx, dH):
        a, H = ctx.saved_tensors
        a_next = torch.zeros_like(a)
        a_next[:, :-1] = a[:, 1:]
        G = _recurrence(a_next.flip(1), dH.flip(1)).flip(1)
        da = torch.zeros_like(a)
        da[:, 1:] = G[:, 1:] * H[:, :-1]
        return da, G


def lr_at(step: int, opt: dict) -> float:
    """Linear warm-up to ``lr`` over ``warmup_steps``, then a cosine down
    to ``min_lr_frac`` of it at ``total_steps``."""
    lr, warm = opt["lr"], opt["warmup_steps"]
    if step < warm:
        return lr * (step + 1) / max(warm, 1)
    t = min(max((step - warm) / max(opt["total_steps"] - warm, 1), 0.0), 1.0)
    f = opt["min_lr_frac"]
    return f * lr + (1 - f) * lr * 0.5 * (1 + math.cos(math.pi * t))


@torch.no_grad()
def adamw(leaves, grads, m, v, step: int, opt: dict, decay) -> float:
    """One AdamW step in place over parallel lists; the gradients clipped
    to a global norm of ``grad_clip`` first.  ``decay[i]``: whether leaf
    i takes weight decay.  Returns the clip's scale."""
    gnorm = math.sqrt(sum(float(torch.sum(g * g)) for g in grads))
    scale = min(opt["grad_clip"] / (gnorm + 1e-9), 1.0)
    lr = lr_at(step, opt)
    b1, b2 = opt["b1"], opt["b2"]
    bc1, bc2 = 1 - b1 ** (step + 1), 1 - b2 ** (step + 1)
    for p, g, mi, vi, dec in zip(leaves, grads, m, v, decay):
        gs = g * scale
        mi.mul_(b1).add_(gs, alpha=1 - b1)
        vi.mul_(b2).addcmul_(gs, gs, value=1 - b2)
        upd = (mi / bc1) / (torch.sqrt(vi / bc2) + opt["eps"])
        if dec:
            upd.add_(p, alpha=opt["weight_decay"])
        p.sub_(upd, alpha=lr)
    return scale


def silu(x: torch.Tensor) -> torch.Tensor:
    return F.silu(x)
