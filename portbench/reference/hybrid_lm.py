"""A Jamba stack without experts in float32 (AI21-Jamba2-3B as the port
runs it; arXiv:2403.19887, ``JambaForCausalLM``): pre-norm residual
layers of RMSNorm -> a mixer -> RMSNorm -> SwiGLU MLP, a final RMSNorm
and a head tied to the embedding; the loss is the mean next-token
cross-entropy.

The mixer of layer ``i`` is attention where ``i % attn_layer_period ==
attn_layer_offset``, else Mamba-1.  Attention carries no positional
encoding: causal, its ``num_key_value_heads`` heads shared by the query
heads in groups (one for all: MQA).  The Mamba mixer: ``x, z =
split(h @ in_proj)``; a depthwise causal convolution of width
``mamba_d_conv`` with bias, then SiLU; ``dt, B, C = split(x @ x_proj)``,
each through a weighted RMSNorm (eps ``rms_norm_eps``); ``delta =
softplus(dt @ dt_proj + dt_bias)``; ``A = -exp(A_log)``; the selective
scan ``h_t = exp(delta_t A) h_{t-1} + delta_t B_t x_t``, ``y_t = C_t .
h_t + D x_t``; ``(y * silu(z)) @ out_proj``.  Each configuration's file
lists where this departs from the published model.

Memory, so that one row of 16,384 tokens fits beside the optimizer's
state: each layer is recomputed in the backward (``checkpoint``), the
attention a block of queries at a time and the scan a block of time
steps at a time, each block recomputed in its turn.
"""
from __future__ import annotations

import math
from typing import Dict, List

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from .common import LinearRecurrence, matmul, next_token_loss, rms_norm


# what ``tools/controls.py`` reads, as ``follow``'s ``prec``: the controls
# (float8 products; the scan's decay, drive and states in bfloat16 with
# float32 products) and planted faults (the scan's states dropped; the
# mixer's dt, B and C norms left out)
CONTROLS = ("fp8", "scan_bf16")
FAULTS = ("scan_dropped", "mixer_norms_dropped")

#: queries of an attention block, time steps of a scan block
Q_BLOCK = 512
T_BLOCK = 2048


def sizes(cj: dict) -> dict:
    r = cj["as_run"]
    d, h = r["hidden_size"], r["num_attention_heads"]
    return dict(L=r["num_hidden_layers"], d=d, h=h,
                kh=r["num_key_value_heads"], hd=r.get("head_dim") or d // h,
                f=r["intermediate_size"], V=r["vocab_size"],
                eps=r["rms_norm_eps"], P=r["attn_layer_period"],
                off=r["attn_layer_offset"], di=r["mamba_expand"] * d,
                N=r["mamba_d_state"], K=r["mamba_d_conv"],
                R=r["mamba_dt_rank"], dt_bias=r["dt_bias_init"])


def kinds(cj: dict) -> List[str]:
    """Each layer's mixer, ``"attn"`` or ``"mamba"``, in order."""
    s = sizes(cj)
    return ["attn" if i % s["P"] == s["off"] else "mamba"
            for i in range(s["L"])]


def port_fields(cj: dict) -> dict:
    """The port's ``ModelConfig`` fields that carry these sizes, over the
    hybrid family's entry: no experts, the attention period and offset,
    Jamba's three layer options on (the port's ``dt_rank`` is
    ``ceil(d / 16)``, which the file's rank has to be)."""
    s, t = sizes(cj), cj["dtypes"]
    if s["R"] != math.ceil(s["d"] / 16):
        raise ValueError(f"mamba_dt_rank {s['R']}: the port's dt_rank is "
                         f"ceil(hidden_size / 16) = {math.ceil(s['d'] / 16)}")
    return dict(n_layers=s["L"], d_model=s["d"], n_heads=s["h"],
                n_kv_heads=s["kh"], head_dim=s["hd"], d_ff=s["f"],
                vocab_size=s["V"], n_experts=0, experts_per_token=0,
                moe_layer_period=1, attn_layer_period=s["P"],
                attn_layer_offset=s["off"], sliding_window=0,
                ssm_state=s["N"], expand=s["di"] // s["d"], d_conv=s["K"],
                norm_eps=s["eps"], use_rope=False, mixer_norms=True,
                tie_embeddings=True, param_dtype=t["param"],
                compute_dtype=t["compute"], opt_state_dtype=t["opt_state"],
                grad_accum_dtype=t["grad_accum"])


def _attn_params(s: dict) -> int:
    d, h, kh, hd, f = s["d"], s["h"], s["kh"], s["hd"], s["f"]
    return 2 * d + d * h * hd + 2 * d * kh * hd + h * hd * d + 3 * d * f


def _mamba_params(s: dict) -> int:
    d, di, N, K, R, f = s["d"], s["di"], s["N"], s["K"], s["R"], s["f"]
    return (2 * d + d * 2 * di + K * di + di + di * (R + 2 * N) + R * di
            + di + di * N + di + R + 2 * N + di * d + 3 * d * f)


def params_per_token(cj: dict) -> int:
    """The parameters a token runs through: every layer, the final norm
    and the head (the embedding's table, read again); the embedding's
    gather is left out."""
    s = sizes(cj)
    per = {"attn": _attn_params(s), "mamba": _mamba_params(s)}
    return sum(per[k] for k in kinds(cj)) + s["d"] + s["d"] * s["V"]


def attention_flops_per_token(cj: dict, seq_len: int) -> int:
    """Causal attention's products, forward and backward, in the attention
    layers alone: 6 * layers * S * heads * head_dim a token."""
    s = sizes(cj)
    return 6 * kinds(cj).count("attn") * seq_len * s["h"] * s["hd"]


def _leaves(s: dict, kind: str) -> list:
    """(name, shape, init) of a layer's leaves, without the stack dim."""
    d, h, kh, hd, f = s["d"], s["h"], s["kh"], s["hd"], s["f"]
    di, N, K, R = s["di"], s["N"], s["K"], s["R"]
    std, out_std = 0.02, 0.02 / math.sqrt(2 * s["L"])
    one = ("const", 1.0)
    out = [("ln1", (d,), one)]
    if kind == "attn":
        out += [("attn.wq", (d, h * hd), ("normal", std)),
                ("attn.wk", (d, kh * hd), ("normal", std)),
                ("attn.wv", (d, kh * hd), ("normal", std)),
                ("attn.wo", (h * hd, d), ("normal", out_std))]
    else:
        out += [("mamba.in_proj", (d, 2 * di), ("normal", std)),
                ("mamba.conv_w", (K, di), ("uniform", 1 / math.sqrt(K))),
                ("mamba.conv_b", (di,), ("const", 0.0)),
                ("mamba.x_proj", (di, R + 2 * N), ("normal", std)),
                ("mamba.dt_norm", (R,), one),
                ("mamba.b_norm", (N,), one),
                ("mamba.c_norm", (N,), one),
                ("mamba.dt_proj", (R, di), ("normal", std)),
                ("mamba.dt_bias", (di,), ("const", s["dt_bias"])),
                ("mamba.A_log", (di, N), ("log_arange",)),
                ("mamba.D", (di,), one),
                ("mamba.out_proj", (di, d), ("normal", out_std))]
    return out + [("ln2", (d,), one),
                  ("mlp.wg", (d, f), ("normal", std)),
                  ("mlp.wu", (d, f), ("normal", std)),
                  ("mlp.wd", (f, d), ("normal", out_std))]


def leaf_specs(cj: dict) -> list:
    """(port path, shape, init) of every leaf: layer ``i`` is period ``i //
    P`` of the leaves at ``blocks.pos{i % P}``, stacked over the periods."""
    s = sizes(cj)
    n = s["L"] // s["P"]
    specs = [("tok_embed", (s["V"], s["d"]), ("normal", 0.02)),
             ("final_ln", (s["d"],), ("const", 1.0))]
    for pos, kind in enumerate(kinds(cj)[:s["P"]]):
        specs += [(f"blocks.pos{pos}.{name}", (n,) + shape, init)
                  for name, shape, init in _leaves(s, kind)]
    return specs


def _products(prec: str) -> str:
    """The precision of the products under ``prec``: the scan's variants
    and the dropped norms keep them in float32."""
    return "fp8" if prec == "fp8" else "fp32"


def _attend(q, k, v, start, prec):
    """A block of queries [B, h, c, hd] starting at row ``start`` over
    every key [B, h, S, hd], causal."""
    c, S = q.shape[2], k.shape[2]
    scores = matmul(q, k.transpose(-1, -2), prec) / math.sqrt(q.shape[-1])
    rows = torch.arange(start, start + c, device=q.device)[:, None]
    cols = torch.arange(S, device=q.device)[None, :]
    scores = scores.masked_fill(cols > rows, float("-inf"))
    return matmul(torch.softmax(scores, dim=-1), v, prec)


def _mlp(x, ln2, wg, wu, wd, s, prec):
    a = rms_norm(x, ln2, s["eps"])
    return x + matmul(F.silu(matmul(a, wg, prec)) * matmul(a, wu, prec), wd,
                      prec)


def _attn_layer(x, p, *, s, prec):
    B, S, _ = x.shape
    h, kh, hd = s["h"], s["kh"], s["hd"]
    prec = _products(prec)
    a = rms_norm(x, p["ln1"], s["eps"])
    q = matmul(a, p["attn.wq"], prec).reshape(B, S, h, hd).transpose(1, 2)
    k = matmul(a, p["attn.wk"], prec).reshape(B, S, kh, hd).transpose(1, 2)
    v = matmul(a, p["attn.wv"], prec).reshape(B, S, kh, hd).transpose(1, 2)
    k = k.repeat_interleave(h // kh, dim=1)       # query head i: kv i // G
    v = v.repeat_interleave(h // kh, dim=1)
    att = torch.cat([checkpoint(_attend, q[:, :, r:r + Q_BLOCK], k, v, r,
                                prec, use_reentrant=False)
                     for r in range(0, S, Q_BLOCK)], dim=2)
    x = x + matmul(att.transpose(1, 2).reshape(B, S, h * hd), p["attn.wo"],
                   prec)
    return _mlp(x, p["ln2"], p["mlp.wg"], p["mlp.wu"], p["mlp.wd"], s, prec)


def _scan_block(delta, xc, Bm, Cm, A, h0, scan):
    """The scan over a block of time steps from state ``h0`` [B, di, N]
    -> (y [B, T, di] without the skip term, the last state)."""
    decay = torch.exp(delta[..., None] * A)                  # [B, T, di, N]
    drive = (delta * xc)[..., None] * Bm[:, :, None, :]
    drive = torch.cat([drive[:, :1] + decay[:, :1] * h0[:, None],
                       drive[:, 1:]], dim=1)
    if scan == "scan_bf16":
        decay, drive = decay.bfloat16(), drive.bfloat16()
    states = LinearRecurrence.apply(decay, drive).float()
    if scan == "scan_dropped":
        states = states * 0
    return torch.einsum("btdn,btn->btd", states, Cm), states[:, -1]


def _mamba_layer(x, p, *, s, prec):
    T, K, N, R = x.shape[1], s["K"], s["N"], s["R"]
    variant, prec = prec, _products(prec)
    a = rms_norm(x, p["ln1"], s["eps"])
    xin, z = matmul(a, p["mamba.in_proj"], prec).chunk(2, dim=-1)
    pad = F.pad(xin, (0, 0, K - 1, 0))
    xc = sum(p["mamba.conv_w"][k] * pad[:, k:k + T] for k in range(K))
    xc = F.silu(xc + p["mamba.conv_b"])
    dt, Bm, Cm = torch.split(matmul(xc, p["mamba.x_proj"], prec), [R, N, N],
                             dim=-1)
    if variant != "mixer_norms_dropped":
        dt = rms_norm(dt, p["mamba.dt_norm"], s["eps"])
        Bm = rms_norm(Bm, p["mamba.b_norm"], s["eps"])
        Cm = rms_norm(Cm, p["mamba.c_norm"], s["eps"])
    else:   # the norms left out; their scales reach the loss at weight 0,
        # so that each leaf still has a gradient (a zero one)
        dt = dt + 0 * sum(p[f"mamba.{n}_norm"].sum() for n in ("dt", "b", "c"))
    delta = F.softplus(matmul(dt, p["mamba.dt_proj"], prec)
                       + p["mamba.dt_bias"])
    A = -torch.exp(p["mamba.A_log"])                         # [di, N]
    hs = xc.new_zeros(x.shape[0], s["di"], N)
    ys = []
    for t in range(0, T, T_BLOCK):
        blk = slice(t, t + T_BLOCK)
        y, hs = checkpoint(_scan_block, delta[:, blk], xc[:, blk],
                           Bm[:, blk], Cm[:, blk], A, hs, variant,
                           use_reentrant=False)
        ys.append(y)
    y = torch.cat(ys, dim=1) + xc * p["mamba.D"]
    x = x + matmul(y * F.silu(z), p["mamba.out_proj"], prec)
    return _mlp(x, p["ln2"], p["mlp.wg"], p["mlp.wu"], p["mlp.wd"], s, prec)


def _layer(x, names, *tensors, kind, s, prec):
    p = dict(zip(names, tensors))
    fn = _attn_layer if kind == "attn" else _mamba_layer
    return fn(x, p, s=s, prec=prec)


def loss(params: Dict[str, object], tokens: torch.Tensor, cj: dict,
         prec: str) -> torch.Tensor:
    """Mean next-token loss of ``tokens`` [B, S]; ``params`` maps a port
    path to a tensor, a layer leaf to the list of its periods' tensors.
    Each layer is recomputed in the backward (``checkpoint``) so that one
    layer's activations live at a time."""
    s = sizes(cj)
    x = params["tok_embed"][tokens]
    for i, kind in enumerate(kinds(cj)):
        names = [n for n, _, _ in _leaves(s, kind)]
        base = f"blocks.pos{i % s['P']}."
        x = checkpoint(_layer, x, names,
                       *(params[base + n][i // s["P"]] for n in names),
                       kind=kind, s=s, prec=prec, use_reentrant=False)
    x = rms_norm(x, params["final_ln"], s["eps"])
    return next_token_loss(matmul(x, params["tok_embed"].t(),
                                  _products(prec)), tokens)
