"""Plain torch versions of flash attention and its gradient: both
materialize the full score matrix in fp32 (the numerically exact
oracles the kernels are held against)."""
from __future__ import annotations

import math
from typing import Tuple, Union

import torch

#: log2(e): the kernels keep scores, and the row log-sum-exp, in base 2
LOG2E = 1.4426950408889634


def _scores(q, k, causal, window, softcap):
    """(fp32 scores, softcap's tanh or None, the mask) of q [B, Sq, Kh, G,
    hd] against k [B, Skv, Kh, hd], as [B, Kh, G, Sq, Skv]."""
    Sq, hd = q.shape[1], q.shape[-1]
    Skv = k.shape[1]
    s = torch.einsum("bqkgh,bskh->bkgqs", q.float(), k.float()) * (
        1.0 / math.sqrt(hd))
    t = None
    if softcap and softcap > 0:
        t = torch.tanh(s / softcap)
        s = softcap * t
    qp = torch.arange(Sq, device=q.device)[:, None]
    kp = torch.arange(Skv, device=q.device)[None, :]
    mask = torch.ones((Sq, Skv), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kp <= qp
    if window and window > 0:
        mask &= kp > qp - window
    return s, t, mask


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = True, window: int = 0,
                        softcap: float = 0.0, return_lse: bool = False
                        ) -> Union[torch.Tensor,
                                   Tuple[torch.Tensor, torch.Tensor]]:
    """q: [B, Sq, Kh, G, hd]; k, v: [B, Skv, Kh, hd] -> [B, Sq, Kh, G, hd].

    Scores and the softmax are fp32; the probabilities are rounded to v's
    dtype before the value product, which accumulates in fp32.  A row with
    no allowed key gives 0.

    ``return_lse``: also return each row's log-sum-exp of its allowed
    (scaled, capped) scores in base 2, lse = log2(sum 2^(s * log2(e))),
    [B, Kh, G, Sq] fp32, +inf for a row with no allowed key (what the
    forward kernels write for the backward)."""
    s, _, mask = _scores(q, k, causal, window, softcap)
    s = s.masked_fill(~mask, float("-inf"))
    p = torch.softmax(s, dim=-1)
    p = torch.nan_to_num(p, nan=0.0)             # fully-masked rows -> 0
    out = torch.einsum("bkgqs,bskh->bqkgh", p.to(v.dtype).float(), v.float())
    out = out.to(q.dtype)
    if not return_lse:
        return out
    lse = torch.logsumexp(s, dim=-1) * LOG2E
    return out, lse.masked_fill(~mask.any(-1), float("inf"))


def flash_attention_backward_ref(q: torch.Tensor, k: torch.Tensor,
                                 v: torch.Tensor, out: torch.Tensor,
                                 lse: torch.Tensor, dout: torch.Tensor, *,
                                 causal: bool = True, window: int = 0,
                                 softcap: float = 0.0
                                 ) -> Tuple[torch.Tensor, torch.Tensor,
                                            torch.Tensor]:
    """Gradients (dq, dk, dv) of ``flash_attention_ref`` from the forward's
    output ``out`` and base-2 row log-sum-exp ``lse`` [B, Kh, G, Sq] and
    the output's gradient ``dout``, written out in fp32:

        P  = 2^(s * log2(e) - lse) on allowed pairs, else 0
        D  = rowsum(dout * out)
        dV = P^T dout, with P rounded to v's dtype as the forward rounds it
        dS = P * (dout v^T - D), times (1 - tanh^2) under a softcap
        dQ = dS k / sqrt(hd);  dK = dS^T q / sqrt(hd)

    A row with lse = +inf (no allowed key) has P = 0 and so no gradient.
    Each gradient comes back in its input's dtype."""
    s, t, mask = _scores(q, k, causal, window, softcap)
    p = torch.exp2(s * LOG2E - lse[..., None]).masked_fill(~mask, 0.0)
    do = dout.float()
    d_row = torch.einsum("bqkgh,bqkgh->bkgq", do, out.float())
    dv = torch.einsum("bkgqs,bqkgh->bskh", p.to(v.dtype).float(), do)
    ds = p * (torch.einsum("bqkgh,bskh->bkgqs", do, v.float())
              - d_row[..., None])
    if t is not None:
        ds = ds * (1.0 - t * t)
    scale = 1.0 / math.sqrt(q.shape[-1])
    dq = torch.einsum("bkgqs,bskh->bqkgh", ds, k.float()) * scale
    dk = torch.einsum("bkgqs,bqkgh->bskh", ds, q.float()) * scale
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)
