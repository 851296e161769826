"""A stack of Mamba-1 blocks in float32 (falcon-mamba-7b as the port runs
it): pre-norm residual layers of RMSNorm -> Mamba mixer, a final RMSNorm
and an untied head; the loss is the mean next-token cross-entropy.

The mixer: ``x, z = split(h @ in_proj)``; a depthwise causal convolution
of width ``conv_kernel`` with bias, then SiLU; ``dt, B, C = split(x @
x_proj)``; ``delta = softplus(dt @ dt_proj + dt_bias)``; ``A =
-exp(A_log)``; the selective scan ``h_t = exp(delta_t A) h_{t-1} +
delta_t B_t x_t``, ``y_t = C_t . h_t + D x_t``; ``(y * silu(z)) @
out_proj``.  Each configuration's file lists where this departs from the
published model.
"""
from __future__ import annotations

import math
from typing import Dict

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from .common import LinearRecurrence, matmul, next_token_loss, rms_norm


# what ``tools/controls.py`` reads, as ``follow``'s ``prec``: the controls
# (float8 products; the scan's decay, drive and states in bfloat16 with
# float32 products) and a planted fault (the scan's states dropped)
CONTROLS = ("fp8", "scan_bf16")
FAULTS = ("scan_dropped",)


def sizes(cj: dict) -> dict:
    r = cj["as_run"]
    d = r["hidden_size"]
    di = r["expand"] * d
    return dict(L=r["num_hidden_layers"], d=d, di=di,
                N=r["state_size"], K=r["conv_kernel"],
                R=r.get("time_step_rank") or math.ceil(d / 16),
                V=r["vocab_size"], eps=r["layer_norm_epsilon"],
                dt_bias=r["dt_bias_init"])


def port_fields(cj: dict) -> dict:
    """The port's ``ModelConfig`` fields that carry these sizes (its
    ``dt_rank`` is ``ceil(d / 16)``, which the file's rank has to be)."""
    s, t = sizes(cj), cj["dtypes"]
    if s["R"] != math.ceil(s["d"] / 16):
        raise ValueError(f"time_step_rank {s['R']}: the port's dt_rank is "
                         f"ceil(hidden_size / 16) = {math.ceil(s['d'] / 16)}")
    return dict(n_layers=s["L"], d_model=s["d"], vocab_size=s["V"],
                ssm_state=s["N"], expand=s["di"] // s["d"], d_conv=s["K"],
                norm_eps=s["eps"], param_dtype=t["param"],
                compute_dtype=t["compute"], opt_state_dtype=t["opt_state"],
                grad_accum_dtype=t["grad_accum"])


def params_per_token(cj: dict) -> int:
    """The parameters a token runs through: every layer, the final norm
    and the head; the embedding is a gather and is left out."""
    s = sizes(cj)
    d, di, N, K, R = s["d"], s["di"], s["N"], s["K"], s["R"]
    layer = (d + d * 2 * di + K * di + di + di * (R + 2 * N) + R * di + di
             + di * N + di + di * d)
    return s["L"] * layer + d + d * s["V"]


def attention_flops_per_token(cj: dict, seq_len: int) -> int:
    """No attention."""
    return 0


def leaf_specs(cj: dict) -> list:
    s = sizes(cj)
    L, d, di, N, K, R, V = (s[k] for k in ("L", "d", "di", "N", "K", "R",
                                           "V"))
    std, out_std = 0.02, 0.02 / math.sqrt(2 * L)
    b = "blocks.pos0."
    return [("tok_embed", (V, d), ("normal", std)),
            ("final_ln", (d,), ("const", 1.0)),
            ("head_w", (d, V), ("normal", std)),
            (b + "ln1", (L, d), ("const", 1.0)),
            (b + "mamba.in_proj", (L, d, 2 * di), ("normal", std)),
            (b + "mamba.conv_w", (L, K, di), ("uniform", 1 / math.sqrt(K))),
            (b + "mamba.conv_b", (L, di), ("const", 0.0)),
            (b + "mamba.x_proj", (L, di, R + 2 * N), ("normal", std)),
            (b + "mamba.dt_proj", (L, R, di), ("normal", std)),
            (b + "mamba.dt_bias", (L, di), ("const", s["dt_bias"])),
            (b + "mamba.A_log", (L, di, N), ("log_arange",)),
            (b + "mamba.D", (L, di), ("const", 1.0)),
            (b + "mamba.out_proj", (L, di, d), ("normal", out_std))]


def _products(prec: str) -> str:
    """The precision of the products under ``prec``: the scan's variants
    keep them in float32."""
    return "fp32" if prec in ("scan_bf16", "scan_dropped") else prec


def _layer(x, ln1, in_proj, conv_w, conv_b, x_proj, dt_proj, dt_bias, A_log,
           D, out_proj, *, s, prec):
    T, K, N, R = x.shape[1], s["K"], s["N"], s["R"]
    scan, prec = prec, _products(prec)
    a = rms_norm(x, ln1, s["eps"])
    xin, z = matmul(a, in_proj, prec).chunk(2, dim=-1)       # [B, T, di]
    pad = F.pad(xin, (0, 0, K - 1, 0))
    xc = sum(conv_w[k] * pad[:, k:k + T] for k in range(K)) + conv_b
    xc = F.silu(xc)
    dt, Bm, Cm = torch.split(matmul(xc, x_proj, prec), [R, N, N], dim=-1)
    delta = F.softplus(matmul(dt, dt_proj, prec) + dt_bias)
    A = -torch.exp(A_log)                                    # [di, N]
    decay = torch.exp(delta[..., None] * A)                  # [B, T, di, N]
    drive = (delta * xc)[..., None] * Bm[:, :, None, :]
    if scan == "scan_bf16":
        decay, drive = decay.bfloat16(), drive.bfloat16()
    states = LinearRecurrence.apply(decay, drive).float()
    if scan == "scan_dropped":
        states = states * 0
    y = torch.einsum("btdn,btn->btd", states, Cm) + xc * D
    return x + matmul(y * F.silu(z), out_proj, prec)


_LAYER_LEAVES = ("ln1", "mamba.in_proj", "mamba.conv_w", "mamba.conv_b",
                 "mamba.x_proj", "mamba.dt_proj", "mamba.dt_bias",
                 "mamba.A_log", "mamba.D", "mamba.out_proj")


def loss(params: Dict[str, object], tokens: torch.Tensor, cj: dict,
         prec: str) -> torch.Tensor:
    s = sizes(cj)
    x = params["tok_embed"][tokens]
    layers = [params["blocks.pos0." + n] for n in _LAYER_LEAVES]
    for i in range(s["L"]):
        x = checkpoint(_layer, x, *(leaf[i] for leaf in layers),
                       s=s, prec=prec, use_reentrant=False)
    x = rms_norm(x, params["final_ln"], s["eps"])
    return next_token_loss(matmul(x, params["head_w"], _products(prec)),
                           tokens)
