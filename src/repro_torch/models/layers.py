"""Shared model building blocks, in torch.

Plain functions over nested dicts of tensors, named as in the reference's
parameter tree.  Prefill and training attention go through the
flash-attention kernel (``kernels/flash_attention``; with gradients its
``FlashAttentionFunction``, the kernel's forward and the plain version's
backward) unless ``attn_impl == "reference"``, which takes the reference's
plain sdpa (``chunked_sdpa`` past ``attn_q_chunk``); the decode step is
plain einsum attention over the cache, as in the reference.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..kernels.flash_attention import flash_attention


# ---------------------------------------------------------------------------
#  Sharding rules
# ---------------------------------------------------------------------------
class Rules:
    """The reference maps logical axis names to mesh axes and constrains
    activations with them.  The port runs on one card, so only the empty
    mapping exists and nothing is constrained."""

    def __init__(self, mapping: Optional[Dict[str, Any]] = None):
        if mapping:
            raise NotImplementedError(
                "sharding rules need a device mesh, which the port does not "
                "have yet (ROADMAP.md, queue A: train/sharding.py)")
        self.mapping: Dict[str, Any] = {}


NO_RULES = Rules()

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


def dt(name: str) -> torch.dtype:
    if name not in _DTYPES:
        raise ValueError(f"unknown dtype {name!r}; known: {list(_DTYPES)}")
    return _DTYPES[name]


def resolve_device(device=None) -> torch.device:
    """The card unless the caller asks for another device.  Never falls
    back to the CPU."""
    dev = torch.device(device or "cuda")
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("repro_torch runs on a CUDA card and none is "
                               "available; pass device='cpu' (serving: "
                               "--device cpu) to run the plain versions on "
                               "the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


# ---------------------------------------------------------------------------
#  Normalization
# ---------------------------------------------------------------------------
def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float
             ) -> torch.Tensor:
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    return (out * scale.float()).to(x.dtype)


# ---------------------------------------------------------------------------
#  Rotary position embeddings
# ---------------------------------------------------------------------------
def rope_freqs(head_dim: int, theta: float,
               device: Optional[torch.device] = None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float
               ) -> torch.Tensor:
    """x: [..., seq, heads, head_dim]; positions: [..., seq] (int).  The
    head dim is split in halves (not interleaved)."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, x.device)                # [hd/2]
    angles = positions[..., :, None].float() * freqs       # [..., S, hd/2]
    cos = torch.cos(angles)[..., :, None, :]               # [..., S, 1, hd/2]
    sin = torch.sin(angles)[..., :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
#  Attention (GQA, causal / bidirectional / sliding-window)
# ---------------------------------------------------------------------------
def _softcap(scores: torch.Tensor, cap: float) -> torch.Tensor:
    if cap and cap > 0:
        return cap * torch.tanh(scores / cap)
    return scores


def attention_scores_mask(q_pos: torch.Tensor, kv_pos: torch.Tensor,
                          causal: bool, window: int,
                          kv_valid: Optional[torch.Tensor] = None
                          ) -> torch.Tensor:
    """Boolean [.., Sq, Skv] mask of allowed attention pairs."""
    rel = q_pos[..., :, None] - kv_pos[..., None, :]
    mask = torch.ones(rel.shape, dtype=torch.bool, device=rel.device)
    if causal:
        mask &= rel >= 0
    if window and window > 0:
        mask &= rel < window
    if kv_valid is not None:
        mask &= kv_valid[..., None, :]
    return mask


def sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
         mask: torch.Tensor, softcap: float = 0.0) -> torch.Tensor:
    """Grouped-query scaled dot-product attention (plain torch).

    q: [B, Sq, Kh, G, hd]; k, v: [B, Skv, Kh, hd]; mask broadcastable to
    [B, Kh, G, Sq, Skv].  Returns [B, Sq, Kh, G, hd].  Masked scores are
    -1e30, so a fully masked row gets uniform weights, as in the
    reference."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    scores = torch.einsum("bqkgh,bskh->bkgqs", q.float(), k.float()) * scale
    scores = _softcap(scores, softcap)
    scores = torch.where(mask, scores, torch.full((), -1e30,
                                                  device=scores.device))
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgqs,bskh->bqkgh", probs.to(v.dtype).float(),
                       v.float())
    return out.to(q.dtype)


def chunked_sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 q_pos: torch.Tensor, kv_pos: torch.Tensor,
                 causal: bool, window: int, softcap: float,
                 q_chunk: int = 1024) -> torch.Tensor:
    """sdpa over chunks of q, so the [Sq, Skv] score matrix never exists
    whole; numerically the same as sdpa (fp32 softmax)."""
    outs = []
    for s0 in range(0, q.shape[1], q_chunk):
        qc = q[:, s0:s0 + q_chunk]
        mask = attention_scores_mask(q_pos[s0:s0 + q_chunk], kv_pos, causal,
                                     window)
        outs.append(sdpa(qc, k, v, mask[None, None, None], softcap))
    return torch.cat(outs, dim=1)


def _clamp_start(start: int, size: int, length: int) -> int:
    """Start index of an update of ``length`` rows into ``size`` rows, clamped
    as ``jax.lax.dynamic_update_slice`` clamps it."""
    return min(max(start, 0), size - length)


def attn_block(x: torch.Tensor, kv_src: torch.Tensor,
               p: Dict[str, torch.Tensor], cfg, rules: Rules,
               q_pos: torch.Tensor, kv_pos: torch.Tensor,
               causal: bool, window: int = 0,
               use_rope: bool = True,
               kv_cache: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
               cache_pos: Optional[int] = None,
               attn_impl: Optional[str] = None,
               ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """Full attention sub-block: projections + RoPE + attention + out-proj.

    Prefill (``kv_cache`` None) returns the computed (k, v) for the cache.
    Decode writes the new k/v into ``kv_cache`` IN PLACE at ``cache_pos``
    (the counterpart of the reference's donated cache buffer), attends over
    the whole cache and returns the same two tensors.
    """
    B, Sq, d = x.shape
    h, kh, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    G = h // kh
    cdt = dt(cfg.compute_dtype)
    if attn_impl is None:
        attn_impl = cfg.attn_impl

    q = x.to(cdt) @ p["wq"].to(cdt)
    k = kv_src.to(cdt) @ p["wk"].to(cdt)
    v = kv_src.to(cdt) @ p["wv"].to(cdt)
    if cfg.attn_bias:
        q = q + p["bq"].to(cdt)
        k = k + p["bk"].to(cdt)
        v = v + p["bv"].to(cdt)
    q = q.reshape(B, Sq, kh, G, hd)
    k = k.reshape(B, kv_src.shape[1], kh, hd)
    v = v.reshape(B, kv_src.shape[1], kh, hd)

    if use_rope:
        q = apply_rope(q.reshape(B, Sq, kh * G, hd), q_pos, cfg.rope_theta
                       ).reshape(B, Sq, kh, G, hd)
        k = apply_rope(k, kv_pos, cfg.rope_theta)

    r = cfg.kv_repeat
    if r > 1:
        # each kv head repeated r times, queries regrouped: the same GQA
        k = k.repeat_interleave(r, dim=2)
        v = v.repeat_interleave(r, dim=2)
        q = q.reshape(B, Sq, kh * r, G // r, hd)

    if kv_cache is not None:
        k_cache, v_cache = kv_cache
        S_cache = k_cache.shape[1]
        slot = cache_pos % window if window and window > 0 else cache_pos
        start = _clamp_start(slot, S_cache, k.shape[1])
        k_cache[:, start:start + k.shape[1]].copy_(k)
        v_cache[:, start:start + v.shape[1]].copy_(v)
        idx = torch.arange(S_cache, device=x.device)
        if window and window > 0:
            # ring buffer: entry i holds the absolute position of its slot
            n_wrap = (cache_pos // window) * window
            abs_pos = torch.where(idx <= slot, n_wrap + idx,
                                  n_wrap - window + idx)
            kv_valid = (abs_pos >= 0) & (abs_pos <= cache_pos)
            kv_p = abs_pos
        else:
            kv_valid = idx <= cache_pos
            kv_p = idx
        mask = attention_scores_mask(q_pos, kv_p, causal, window, kv_valid)
        out = sdpa(q, k_cache.to(cdt), v_cache.to(cdt),
                   mask[None, None, None], cfg.logit_softcap)
        new_cache = (k_cache, v_cache)
    else:
        qc = cfg.attn_q_chunk
        if attn_impl in ("auto", "cuda"):
            out = flash_attention(q.contiguous(), k.contiguous(),
                                  v.contiguous(), causal=causal,
                                  window=window, softcap=cfg.logit_softcap,
                                  impl=attn_impl)
        elif attn_impl != "reference":
            raise ValueError(f"unknown attn_impl {attn_impl!r}")
        elif (qc and Sq > qc) or (not qc and Sq >= 8192):
            out = chunked_sdpa(q, k, v, q_pos, kv_pos, causal, window,
                               cfg.logit_softcap, q_chunk=qc or 1024)
        else:
            mask = attention_scores_mask(q_pos, kv_pos, causal, window)
            out = sdpa(q, k, v, mask[None, None, None], cfg.logit_softcap)
        new_cache = (k, v)   # prefill: the computed k/v build the cache

    out = out.reshape(B, Sq, h * hd) @ p["wo"].to(cdt)
    return out, new_cache


# ---------------------------------------------------------------------------
#  Dense FFN
# ---------------------------------------------------------------------------
def mlp_block(x: torch.Tensor, p: Dict[str, torch.Tensor], cfg,
              rules: Rules) -> torch.Tensor:
    cdt = dt(cfg.compute_dtype)
    xc = x.to(cdt)
    if cfg.mlp_kind == "swiglu":
        g = xc @ p["wg"].to(cdt)
        u = xc @ p["wu"].to(cdt)
        hid = F.silu(g) * u
    else:  # gelu; jax.nn.gelu defaults to the tanh approximation
        hid = F.gelu(xc @ p["wu"].to(cdt), approximate="tanh")
    return hid @ p["wd"].to(cdt)


# ---------------------------------------------------------------------------
#  Initializers
# ---------------------------------------------------------------------------
def normal_init(gen: torch.Generator, shape, scale: float,
                dtype: torch.dtype) -> torch.Tensor:
    """N(0, 1) * scale drawn in fp32 on the generator's device, then cast.
    Scaled in place: one fp32 copy of the leaf at a time (a stacked expert
    weight of grok-1 at 4 layers is 25.8 GB in fp32)."""
    return torch.randn(shape, generator=gen, dtype=torch.float32,
                       device=gen.device).mul_(scale).to(dtype)
