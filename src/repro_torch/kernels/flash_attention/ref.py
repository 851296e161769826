"""Plain torch version of flash attention: materializes the full score
matrix with an fp32 softmax (the numerically exact oracle)."""
from __future__ import annotations

import math

import torch


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = True, window: int = 0,
                        softcap: float = 0.0) -> torch.Tensor:
    """q: [B, Sq, Kh, G, hd]; k, v: [B, Skv, Kh, hd] -> [B, Sq, Kh, G, hd].

    Scores and the softmax are fp32; the probabilities are rounded to v's
    dtype before the value product, which accumulates in fp32.  A row with
    no allowed key gives 0."""
    Sq, hd = q.shape[1], q.shape[-1]
    Skv = k.shape[1]
    scale = 1.0 / math.sqrt(hd)
    s = torch.einsum("bqkgh,bskh->bkgqs", q.float(), k.float()) * scale
    if softcap and softcap > 0:
        s = softcap * torch.tanh(s / softcap)
    qp = torch.arange(Sq, device=q.device)[:, None]
    kp = torch.arange(Skv, device=q.device)[None, :]
    mask = torch.ones((Sq, Skv), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kp <= qp
    if window and window > 0:
        mask &= kp > qp - window
    s = s.masked_fill(~mask, float("-inf"))
    p = torch.softmax(s, dim=-1)
    p = torch.nan_to_num(p, nan=0.0)             # fully-masked rows -> 0
    out = torch.einsum("bkgqs,bskh->bqkgh", p.to(v.dtype).float(), v.float())
    return out.to(q.dtype)
