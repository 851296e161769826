"""A decoder of attention and gated MLP layers in float32 (stablelm-3b as
the port runs it): pre-norm residual layers of RMSNorm -> causal
multi-head attention with rotary positions -> RMSNorm -> SwiGLU MLP, a
final RMSNorm and an untied head; the loss is the mean next-token
cross-entropy.

Each configuration's file lists where this departs from the published
model (``departures``) and the sizes it runs (``as_run``).
"""
from __future__ import annotations

import math
from typing import Dict, List

import torch
from torch.utils.checkpoint import checkpoint

from .common import matmul, next_token_loss, rms_norm


# the controls ``tools/controls.py`` reads, as ``follow``'s ``prec``
CONTROLS = ("fp8",)
FAULTS = ()


def sizes(cj: dict) -> dict:
    r = cj["as_run"]
    d, h = r["hidden_size"], r["num_attention_heads"]
    return dict(L=r["num_hidden_layers"], d=d, h=h,
                kh=r["num_key_value_heads"], hd=r.get("head_dim", d // h),
                f=r["intermediate_size"], V=r["vocab_size"],
                eps=r["rms_norm_eps"], theta=r["rope_theta"])


def port_fields(cj: dict) -> dict:
    """The port's ``ModelConfig`` fields that carry these sizes."""
    s, t = sizes(cj), cj["dtypes"]
    return dict(n_layers=s["L"], d_model=s["d"], n_heads=s["h"],
                n_kv_heads=s["kh"], head_dim=s["hd"], d_ff=s["f"],
                vocab_size=s["V"], rope_theta=s["theta"], norm_eps=s["eps"],
                param_dtype=t["param"], compute_dtype=t["compute"],
                opt_state_dtype=t["opt_state"],
                grad_accum_dtype=t["grad_accum"])


def params_per_token(cj: dict) -> int:
    """The parameters a token runs through: every layer, the final norm
    and the head; the embedding is a gather and is left out."""
    s = sizes(cj)
    d, h, kh, hd, f = s["d"], s["h"], s["kh"], s["hd"], s["f"]
    layer = 2 * d + d * h * hd + 2 * d * kh * hd + h * hd * d + 3 * d * f
    return s["L"] * layer + d + d * s["V"]


def attention_flops_per_token(cj: dict, seq_len: int) -> int:
    """Causal attention's products, forward and backward: 6 * L * S *
    heads * head_dim a token."""
    s = sizes(cj)
    return 6 * s["L"] * seq_len * s["h"] * s["hd"]


def leaf_specs(cj: dict) -> list:
    """(port path, shape, init) of every leaf; layer leaves stacked."""
    s = sizes(cj)
    L, d, h, kh, hd, f, V = (s[k] for k in ("L", "d", "h", "kh", "hd", "f",
                                            "V"))
    std, out_std = 0.02, 0.02 / math.sqrt(2 * L)
    b = "blocks.pos0."
    return [("tok_embed", (V, d), ("normal", std)),
            ("final_ln", (d,), ("const", 1.0)),
            ("head_w", (d, V), ("normal", std)),
            (b + "ln1", (L, d), ("const", 1.0)),
            (b + "attn.wq", (L, d, h * hd), ("normal", std)),
            (b + "attn.wk", (L, d, kh * hd), ("normal", std)),
            (b + "attn.wv", (L, d, kh * hd), ("normal", std)),
            (b + "attn.wo", (L, h * hd, d), ("normal", out_std)),
            (b + "ln2", (L, d), ("const", 1.0)),
            (b + "mlp.wg", (L, d, f), ("normal", std)),
            (b + "mlp.wu", (L, d, f), ("normal", std)),
            (b + "mlp.wd", (L, f, d), ("normal", out_std))]


def _rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """x [B, S, heads, hd]: rotate the two halves of each head by the
    position's angles."""
    S, hd = x.shape[1], x.shape[-1]
    freqs = 1.0 / (theta ** (torch.arange(0, hd, 2, dtype=torch.float32,
                                          device=x.device) / hd))
    ang = torch.arange(S, dtype=torch.float32, device=x.device)[:, None] \
        * freqs
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def _layer(x, ln1, wq, wk, wv, wo, ln2, wg, wu, wd, *, s, prec):
    B, S, _ = x.shape
    h, kh, hd = s["h"], s["kh"], s["hd"]
    a = rms_norm(x, ln1, s["eps"])
    q = _rope(matmul(a, wq, prec).reshape(B, S, h, hd), s["theta"])
    k = _rope(matmul(a, wk, prec).reshape(B, S, kh, hd), s["theta"])
    v = matmul(a, wv, prec).reshape(B, S, kh, hd)
    k = k.repeat_interleave(h // kh, dim=2)       # query head i: kv i // G
    v = v.repeat_interleave(h // kh, dim=2)
    q, k, v = (t.transpose(1, 2) for t in (q, k, v))      # [B, h, S, hd]
    scores = matmul(q, k.transpose(-1, -2), prec) / math.sqrt(hd)
    causal = torch.ones(S, S, dtype=torch.bool, device=x.device).tril()
    scores = scores.masked_fill(~causal, float("-inf"))
    att = matmul(torch.softmax(scores, dim=-1), v, prec)
    x = x + matmul(att.transpose(1, 2).reshape(B, S, h * hd), wo, prec)
    a = rms_norm(x, ln2, s["eps"])
    hid = torch.nn.functional.silu(matmul(a, wg, prec)) * matmul(a, wu, prec)
    return x + matmul(hid, wd, prec)


_LAYER_LEAVES = ("ln1", "attn.wq", "attn.wk", "attn.wv", "attn.wo", "ln2",
                 "mlp.wg", "mlp.wu", "mlp.wd")


def loss(params: Dict[str, object], tokens: torch.Tensor, cj: dict,
         prec: str) -> torch.Tensor:
    """Mean next-token loss of ``tokens`` [B, S]; ``params`` maps a port
    path to a tensor, a layer leaf to the list of its layers' tensors.
    Each layer is recomputed in the backward (``checkpoint``) so that one
    layer's activations live at a time."""
    s = sizes(cj)
    x = params["tok_embed"][tokens]
    layers: List[list] = [params["blocks.pos0." + n] for n in _LAYER_LEAVES]
    for i in range(s["L"]):
        x = checkpoint(_layer, x, *(leaf[i] for leaf in layers),
                       s=s, prec=prec, use_reentrant=False)
    x = rms_norm(x, params["final_ln"], s["eps"])
    return next_token_loss(matmul(x, params["head_w"], prec), tokens)
