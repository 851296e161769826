"""The reference's unified model, in torch, for the families the port runs:
dense (attention + MLP), moe (attention + the MoE FFN of ``moe.py``) and
ssm (Mamba-1).

Layers are grouped into structural periods (dense, moe and ssm: period 1) and
their parameters stacked along a leading layer dim, as in the reference;
where the reference runs ``lax.scan`` over periods, the port runs a Python
loop over the stacked parameters' layer index.

Entry points:
  init_params / param_shapes / param_count
  forward_prefill(params, batch, cfg)      -> (logits, cache)
  decode_step(params, cache, batch, cfg)   -> (logits, cache)
  make_cache_shapes(cfg, B, S)             -> cache shapes (meta tensors)
  grow_cache(cache, cfg, max_len)          -> cache with free decode slots

A cache is a dict of stacked tensors plus ``pos_idx``, the next decode
position, kept as a host int (decode slices the cache with it).  With a
sliding window W the attention cache is a ring: position p sits at slot
p mod W, after a prefill too (the reference's prefill cache breaks that
when the prompt is longer than W and not a multiple of it).

The backbone returns ``(h, new_cache)``.  ``moe_block`` also returns its
load-balancing loss; serving drops it, and the backbone will sum it when
training is ported (ROADMAP queue A item 7).
"""
from __future__ import annotations

import math
from typing import Any, Dict, List, Optional, Tuple

import torch

from .layers import (NO_RULES, Rules, attn_block, dt, mlp_block, normal_init,
                     rms_norm)
from .mamba import mamba_block
from .moe import moe_block

Params = Dict[str, Any]

#: families the port cannot run yet, and what each still needs
_UNSUPPORTED = {
    "hybrid": "a card path over 4 cards with model sharding (one "
              "full-width period, 4 MoE layers of 16 experts, is 77 GB in "
              "bf16) and its attention/Mamba/MoE interleave held against "
              "the reference",
    "vlm": "cross-attention over vision embeddings",
    "audio": "the audio front end and encoder-only serving",
}


def check_supported(cfg) -> None:
    """Raise for a family whose modules are not ported yet."""
    if cfg.family in _UNSUPPORTED:
        raise NotImplementedError(
            f"{cfg.name}: family {cfg.family!r} needs "
            f"{_UNSUPPORTED[cfg.family]}, which the "
            f"port does not have yet (ROADMAP.md, queue A: 'LM families "
            f"still to port')")


# ---------------------------------------------------------------------------
#  Structure
# ---------------------------------------------------------------------------
def period(cfg) -> int:
    p = 1
    if cfg.family == "hybrid":
        p = math.lcm(cfg.attn_layer_period, cfg.moe_layer_period)
    elif cfg.family == "vlm" and cfg.cross_attn_period:
        p = cfg.cross_attn_period
    elif cfg.n_experts and cfg.moe_layer_period > 1:
        p = cfg.moe_layer_period
    if cfg.n_layers % p:
        raise ValueError(f"{cfg.name}: {cfg.n_layers} layers is not a "
                         f"multiple of the period {p}")
    return p


def n_periods(cfg) -> int:
    return cfg.n_layers // period(cfg)


# ---------------------------------------------------------------------------
#  Parameter definitions: (path, shape, init_scale)
# ---------------------------------------------------------------------------
def _layer_defs(cfg, pos: int) -> List[Tuple[str, tuple, float]]:
    """Definitions for the layer at in-period position ``pos`` (shapes
    WITHOUT the leading n_periods stack dim)."""
    d, f = cfg.d_model, cfg.d_ff
    h, kh, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    out_scale = 0.02 / math.sqrt(2 * cfg.n_layers)
    defs: List[Tuple[str, tuple, float]] = [("ln1", (d,), 1.0)]
    if cfg.layer_kind(pos) == "attn":
        defs += [("attn.wq", (d, h * hd), 0.02),
                 ("attn.wk", (d, kh * hd), 0.02),
                 ("attn.wv", (d, kh * hd), 0.02),
                 ("attn.wo", (h * hd, d), out_scale)]
        if cfg.attn_bias:
            defs += [("attn.bq", (h * hd,), 0.0),
                     ("attn.bk", (kh * hd,), 0.0),
                     ("attn.bv", (kh * hd,), 0.0)]
    else:  # mamba
        di, N, dtr, K = cfg.d_inner, cfg.ssm_state, cfg.dt_rank, cfg.d_conv
        defs += [("mamba.in_proj", (d, 2 * di), 0.02),
                 ("mamba.conv_w", (K, di), 0.02),
                 ("mamba.conv_b", (di,), 0.0),
                 ("mamba.x_proj", (di, dtr + 2 * N), 0.02),
                 ("mamba.dt_proj", (dtr, di), 0.02),
                 ("mamba.dt_bias", (di,), 0.0),
                 ("mamba.A_log", (di, N), 1.0),
                 ("mamba.D", (di,), 1.0),
                 ("mamba.out_proj", (di, d), out_scale)]
    if cfg.has_cross_attn(pos):
        defs += [("ln_x", (d,), 1.0),
                 ("xattn.wq", (d, h * hd), 0.02),
                 ("xattn.wk", (d, kh * hd), 0.02),
                 ("xattn.wv", (d, kh * hd), 0.02),
                 ("xattn.wo", (h * hd, d), out_scale),
                 ("xattn.gate", (1,), 0.0)]
    if cfg.d_ff > 0:
        defs.append(("ln2", (d,), 1.0))
        if cfg.ffn_kind(pos) == "moe":
            E = cfg.n_experts
            defs += [("moe.router", (d, E), 0.02),
                     ("moe.wg", (E, d, f), 0.02),
                     ("moe.wu", (E, d, f), 0.02),
                     ("moe.wd", (E, f, d), out_scale)]
        else:
            if cfg.mlp_kind == "swiglu":
                defs.append(("mlp.wg", (d, f), 0.02))
            defs += [("mlp.wu", (d, f), 0.02),
                     ("mlp.wd", (f, d), out_scale)]
    return defs


def _top_defs(cfg) -> List[Tuple[str, tuple, float]]:
    d, V = cfg.d_model, cfg.vocab_size
    defs: List[Tuple[str, tuple, float]] = []
    if cfg.family == "audio":
        defs += [("in_proj_w", (d, d), 0.02), ("in_proj_b", (d,), 0.0),
                 ("in_ln", (d,), 1.0)]
    else:
        defs.append(("tok_embed", (V, d), 0.02))
    defs += [("final_ln", (d,), 1.0), ("head_w", (d, V), 0.02)]
    return defs


def _assign(tree: dict, path: str, val) -> None:
    parts = path.split(".")
    for p_ in parts[:-1]:
        tree = tree.setdefault(p_, {})
    tree[parts[-1]] = val


def _build(cfg, leaf_fn) -> Params:
    """Build the param tree; ``leaf_fn(path, shape, scale)`` produces each
    leaf.  Layer params get a leading n_periods dim."""
    np_ = n_periods(cfg)
    tree: Params = {"blocks": {}}
    for path, shape, scale in _top_defs(cfg):
        _assign(tree, path, leaf_fn(path, shape, scale))
    for pos in range(period(cfg)):
        sub: Params = {}
        for path, shape, scale in _layer_defs(cfg, pos):
            _assign(sub, path, leaf_fn(f"blocks.pos{pos}.{path}",
                                       (np_,) + shape, scale))
        tree["blocks"][f"pos{pos}"] = sub
    return tree


def init_params(cfg, seed: int = 0, device="cuda") -> Params:
    """Random parameters from a seeded ``torch.Generator`` on ``device``.
    The structure and the constant leaves are the reference's; the random
    bits are not (tests carry the reference's weights across instead)."""
    check_supported(cfg)
    device = torch.device(device)
    pdt = dt(cfg.param_dtype)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)

    def leaf(path, shape, scale):
        if path.endswith("A_log"):
            # mamba: A init = -(1..N) per state dim, log-parameterized
            N = shape[-1]
            a = torch.log(torch.arange(1, N + 1, dtype=torch.float32,
                                       device=device))
            return a.expand(shape).to(pdt).contiguous()
        if path.endswith((".D", "ln1", "ln2", "ln_x", "final_ln", "in_ln")):
            return torch.ones(shape, dtype=pdt, device=device)
        if path.endswith("dt_bias"):
            return torch.full(shape, -4.6, dtype=pdt, device=device)
        if scale == 0.0:
            return torch.zeros(shape, dtype=pdt, device=device)
        return normal_init(gen, shape, scale, pdt)

    return _build(cfg, leaf)


def param_shapes(cfg) -> Params:
    """The parameter tree as meta tensors (shapes and dtypes, no data)."""
    pdt = dt(cfg.param_dtype)
    return _build(cfg, lambda path, shape, scale:
                  torch.empty(shape, dtype=pdt, device="meta"))


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def param_count(cfg) -> int:
    return sum(t.numel() for t in _leaves(param_shapes(cfg)))


# ---------------------------------------------------------------------------
#  Decode cache
# ---------------------------------------------------------------------------
def cache_len(cfg, seq_len: int) -> int:
    return min(seq_len, cfg.sliding_window) if cfg.sliding_window else seq_len


def make_cache_shapes(cfg, batch: int, seq_len: int) -> Dict[str, Any]:
    """The decode cache as meta tensors (shapes and dtypes only)."""
    np_ = n_periods(cfg)
    kh, hd = cfg.kh_eff, cfg.hd
    cdt = dt(cfg.compute_dtype)
    Sc = cache_len(cfg, seq_len)
    meta = lambda shape, dtype: torch.empty(shape, dtype=dtype, device="meta")
    tree: Dict[str, Any] = {}
    for pos in range(period(cfg)):
        sub: Dict[str, Any] = {}
        if cfg.layer_kind(pos) == "attn":
            sub["k"] = meta((np_, batch, Sc, kh, hd), cdt)
            sub["v"] = meta((np_, batch, Sc, kh, hd), cdt)
        else:
            di, N, K = cfg.d_inner, cfg.ssm_state, cfg.d_conv
            sub["conv"] = meta((np_, batch, K - 1, di), cdt)
            sub["h"] = meta((np_, batch, di, N), torch.float32)
        if cfg.has_cross_attn(pos):
            vshp = (np_, batch, cfg.n_vision_tokens, kh, hd)
            sub["xk"] = meta(vshp, cdt)
            sub["xv"] = meta(vshp, cdt)
        tree[f"pos{pos}"] = sub
    tree["pos_idx"] = meta((), torch.int32)
    return tree


def grow_cache(cache: Dict[str, Any], cfg, max_len: int) -> Dict[str, Any]:
    """Pad prefill-built KV caches along the seq axis to ``max_len`` so
    decode has free slots (serving-time cache allocation)."""
    Sc = cache_len(cfg, max_len)
    out: Dict[str, Any] = {}
    for key, sub in cache.items():
        if not isinstance(sub, dict):
            out[key] = sub
            continue
        grown = {}
        for name, x in sub.items():
            if name in ("k", "v") and x.dim() == 5 and x.shape[2] < Sc:
                big = x.new_zeros(x.shape[:2] + (Sc,) + x.shape[3:])
                big[:, :, :x.shape[2]].copy_(x)
                x = big
            grown[name] = x
        out[key] = grown
    return out


# ---------------------------------------------------------------------------
#  Layer application
# ---------------------------------------------------------------------------
def _apply_layer(h, sub, cfg, rules, pos, q_pos, kv_pos, cache, cache_pos,
                 mode):
    """One layer at in-period position ``pos``.  Returns (h, new_cache)."""
    new_cache: Dict[str, Any] = {}
    hin = rms_norm(h, sub["ln1"], cfg.norm_eps)
    if cfg.layer_kind(pos) == "attn":
        kv_cache = ((cache["k"], cache["v"])
                    if (cache is not None and mode == "decode") else None)
        out, (k_, v_) = attn_block(
            hin, hin, sub["attn"], cfg, rules, q_pos, kv_pos,
            causal=cfg.causal, window=cfg.sliding_window,
            kv_cache=kv_cache, cache_pos=cache_pos)
        if mode == "prefill" and cfg.sliding_window:
            S, W = k_.shape[1], cache_len(cfg, k_.shape[1])
            k_, v_ = k_[:, -W:], v_[:, -W:]
            if S > W and S % W:
                # the last W positions, S-W+j at slot j: roll them so that
                # position p sits at slot p mod W, where decode reads it
                k_, v_ = (torch.roll(t, S % W, dims=1) for t in (k_, v_))
        new_cache["k"], new_cache["v"] = k_, v_
        h = h + out
    else:
        st = ((cache["conv"], cache["h"])
              if (cache is not None and mode == "decode") else None)
        out, st_new = mamba_block(hin, sub["mamba"], cfg, rules, state=st)
        if st_new is not None:
            new_cache["conv"], new_cache["h"] = st_new
        h = h + out
    if cfg.d_ff > 0:
        hin2 = rms_norm(h, sub["ln2"], cfg.norm_eps)
        if cfg.ffn_kind(pos) == "moe":
            out, _aux = moe_block(hin2, sub["moe"], cfg, rules)
        else:
            out = mlp_block(hin2, sub["mlp"], cfg, rules)
        h = h + out
    return h, new_cache


# ---------------------------------------------------------------------------
#  Backbone (a loop over periods)
# ---------------------------------------------------------------------------
def backbone(params, h, cfg, rules: Rules, mode: str, q_pos, kv_pos,
             cache=None, cache_pos: Optional[int] = None):
    """h: [B, S, d] -> (h, new_cache).

    mode 'prefill' stacks each layer's new cache along a leading layer dim.
    mode 'decode' updates ``cache`` IN PLACE, layer slice by layer slice: the
    counterpart of the reference's donated cache buffer, so a multi-GB cache
    is never copied per token."""
    if mode not in ("prefill", "decode"):
        raise ValueError(f"mode {mode!r}: the port runs prefill and decode "
                         f"(training is not ported yet)")
    P_ = period(cfg)
    blocks = params["blocks"]
    stacked: Dict[str, Dict[str, torch.Tensor]] = {}
    for i in range(n_periods(cfg)):
        for pos in range(P_):
            key = f"pos{pos}"
            sub = _index(blocks[key], i)
            cc = ({n: t[i] for n, t in cache[key].items()}
                  if mode == "decode" else None)
            h, nc = _apply_layer(h, sub, cfg, rules, pos, q_pos, kv_pos, cc,
                                 cache_pos, mode)
            if mode == "decode":
                for name, new in nc.items():
                    if new is not cc[name]:   # attention wrote its view
                        cc[name].copy_(new)
                continue
            dst = stacked.setdefault(key, {})
            for name, new in nc.items():
                if name not in dst:
                    dst[name] = new.new_empty((n_periods(cfg),) + new.shape)
                dst[name][i].copy_(new)
    new_cache = cache if mode == "decode" else (stacked or None)
    return h, new_cache


def _index(tree, i):
    if isinstance(tree, dict):
        return {k: _index(v, i) for k, v in tree.items()}
    return tree[i]


# ---------------------------------------------------------------------------
#  Entry points
# ---------------------------------------------------------------------------
def _embed(params, batch, cfg, rules: Rules):
    # gather then cast: the same values as the reference's cast then gather
    return params["tok_embed"][batch["tokens"]].to(dt(cfg.compute_dtype))


def _logits(params, h, cfg, rules: Rules):
    cdt = dt(cfg.compute_dtype)
    h = rms_norm(h, params["final_ln"], cfg.norm_eps)
    return h.to(cdt) @ params["head_w"].to(cdt)


def forward_prefill(params, batch, cfg, rules: Rules = NO_RULES):
    """Full forward over the prompt -> (last-position logits, cache)."""
    check_supported(cfg)
    x = _embed(params, batch, cfg, rules)
    S = x.shape[1]
    pos = torch.arange(S, device=x.device)
    h, cache = backbone(params, x, cfg, rules, "prefill", pos, pos)
    logits = _logits(params, h[:, -1:], cfg, rules)
    if cache is not None:
        cache["pos_idx"] = S
    return logits, cache


def decode_step(params, cache, batch, cfg, rules: Rules = NO_RULES):
    """One-token decode against the cache -> (logits [B,1,V], cache).

    The cache is donated: its tensors are updated in place and the returned
    cache shares them, with ``pos_idx`` one further."""
    check_supported(cfg)
    x = _embed(params, batch, cfg, rules)                # [B, 1, d]
    pos_idx = int(cache["pos_idx"])
    q_pos = torch.tensor([pos_idx], device=x.device)
    h, new_cache = backbone(params, x, cfg, rules, "decode", q_pos, q_pos,
                            cache=cache, cache_pos=pos_idx)
    logits = _logits(params, h, cfg, rules)
    new_cache = dict(new_cache)
    new_cache["pos_idx"] = pos_idx + 1
    return logits, new_cache
