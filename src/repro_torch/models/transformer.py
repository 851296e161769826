"""The reference's unified model, in torch, for all six families: dense
(attention + MLP), moe (attention + the MoE FFN of ``moe.py``), ssm
(Mamba-1), vlm (a gated cross-attention over vision embeddings every
``cross_attn_period``-th layer), audio (an encoder over frame embeddings)
and hybrid (jamba's attention/Mamba/MoE interleave; with MoE layers on the
CPU only, see ``check_supported``).  Three fields the reference lacks give
the published Jamba's layers (``configs/base.py``): ``use_rope=False``,
``mixer_norms`` (RMSNorms on the mixer's dt, B and C) and
``tie_embeddings`` (the head is ``tok_embed``'s transpose, no ``head_w``).

Layers are grouped into structural periods (dense, moe, ssm and audio: 1;
jamba: 8 with attention at offset 4 and MoE every 2nd layer; llama-vision:
5 with cross-attention at offset 3) and their parameters stacked along a
leading layer dim, as in the reference; where the reference runs
``lax.scan`` over periods, the port runs a Python loop over the stacked
parameters' layer index.  The vision and audio front ends are stubs, as in
the reference: ``batch["vision"]`` holds precomputed patch embeddings
``[B, n_vision_tokens, d]`` and ``batch["frames"]`` frame embeddings
``[B, T, d]``.

Entry points:
  init_params / param_shapes / param_specs / param_count
  forward_train(params, batch, cfg)        -> (loss, {"ce", "aux"})
  forward_prefill(params, batch, cfg)      -> (logits, cache)
  decode_step(params, cache, batch, cfg)   -> (logits, cache)
  make_cache_shapes(cfg, B, S, rules, as_spec) -> cache shapes (meta
                                              tensors) or specs
  grow_cache(cache, cfg, max_len)          -> cache with free decode slots

Each takes ``rules`` (default: the empty ``NO_RULES``); with DTensor
parameters (``train/sharding.py``) the backbone constrains activations
where the reference does.  The entry points run under
``implicit_replication``, which changes nothing on plain tensors.

A cache is a dict of stacked tensors plus ``pos_idx``, the next decode
position, kept as a host int (decode slices the cache with it).  A period
may mix kinds: ``k``/``v`` at attention layers, ``conv``/``h`` at Mamba
layers, and ``xk``/``xv`` (the vision K/V, written by the prefill and only
read by decode) at cross-attention layers.  With a sliding window W the
attention cache is a ring: position p sits at slot p mod W, after a
prefill too (the reference's prefill cache breaks that when the prompt is
longer than W and not a multiple of it).

The backbone returns ``(h, new_cache, aux)``: ``aux`` sums the MoE
layers' load-balancing losses, which ``forward_train`` adds to the loss and
serving drops.  In training each layer runs under
``torch.utils.checkpoint`` when ``remat_policy == "full"``, and no cache is
built: the decode path's in-place cache writes never meet autograd.  Under
a train step's tracers (``st``) each layer's forward, recompute and
backward is a ``model.layer`` span and its forward counts ``attn_layers``
or ``mamba_layers``.
"""
from __future__ import annotations

import math
from typing import Any, Dict, List, Optional, Tuple

import torch
from torch.distributed.tensor import DTensor
from torch.distributed.tensor import zeros as dtensor_zeros
from torch.utils.checkpoint import checkpoint

from .layers import (NO_RULES, Rules, attn_block, dt, implicit_replication,
                     mlp_block, normal_init, on_shards, reshape, rms_norm,
                     sdpa, write_rows)
from .mamba import mamba_block
from .moe import moe_block

Params = Dict[str, Any]

#: why the port runs a hybrid with MoE layers on the CPU only
_HYBRID_ON_CUDA = (
    "its card path needs model sharding over 4 cards: one full-width "
    "period of jamba-1.5-large holds 4 MoE layers of 16 experts, 4 x 16 x "
    "3 x 8192 x 24576 x 2 B = 77 GB in bf16, which does not fit one 80 GB "
    "card beside anything else (ROADMAP.md, queue A: jamba's 4-card path, "
    "after train/sharding.py)")


def check_supported(cfg, device) -> None:
    """Raise for a configuration the port does not run on ``device``: a
    hybrid with MoE layers on a CUDA device (one without experts, as
    Jamba2-3B, runs there).  Called before anything is allocated there."""
    if (cfg.family == "hybrid" and cfg.n_experts > 0
            and torch.device(device).type == "cuda"):
        raise NotImplementedError(
            f"{cfg.name}: the hybrid family with MoE layers runs on the CPU "
            f"only; {_HYBRID_ON_CUDA}")


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
#  Parameter definitions: (path, shape, logical_axes, init_scale)
# ---------------------------------------------------------------------------
def _layer_defs(cfg, pos: int) -> List[Tuple[str, tuple, tuple, float]]:
    """Definitions for the layer at in-period position ``pos`` (shapes
    WITHOUT the leading n_periods stack dim)."""
    d, f = cfg.d_model, cfg.d_ff
    h, kh, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    out_scale = 0.02 / math.sqrt(2 * cfg.n_layers)
    defs: List[Tuple[str, tuple, tuple, float]] = [("ln1", (d,), (None,), 1.0)]
    if cfg.layer_kind(pos) == "attn":
        defs += [("attn.wq", (d, h * hd), ("embed", "heads"), 0.02),
                 ("attn.wk", (d, kh * hd), ("embed", "kv_heads"), 0.02),
                 ("attn.wv", (d, kh * hd), ("embed", "kv_heads"), 0.02),
                 ("attn.wo", (h * hd, d), ("heads", "embed"), out_scale)]
        if cfg.attn_bias:
            defs += [("attn.bq", (h * hd,), ("heads",), 0.0),
                     ("attn.bk", (kh * hd,), ("kv_heads",), 0.0),
                     ("attn.bv", (kh * hd,), ("kv_heads",), 0.0)]
    else:  # mamba
        di, N, dtr, K = cfg.d_inner, cfg.ssm_state, cfg.dt_rank, cfg.d_conv
        defs += [("mamba.in_proj", (d, 2 * di), ("embed", "d_inner"), 0.02),
                 ("mamba.conv_w", (K, di), (None, "d_inner"), 0.02),
                 ("mamba.conv_b", (di,), ("d_inner",), 0.0),
                 ("mamba.x_proj", (di, dtr + 2 * N), ("d_inner", None), 0.02),
                 ("mamba.dt_proj", (dtr, di), (None, "d_inner"), 0.02),
                 ("mamba.dt_bias", (di,), ("d_inner",), 0.0),
                 ("mamba.A_log", (di, N), ("d_inner", None), 1.0),
                 ("mamba.D", (di,), ("d_inner",), 1.0),
                 ("mamba.out_proj", (di, d), ("d_inner", "embed"), out_scale)]
        if cfg.mixer_norms:
            defs += [("mamba.dt_norm", (dtr,), (None,), 1.0),
                     ("mamba.b_norm", (N,), (None,), 1.0),
                     ("mamba.c_norm", (N,), (None,), 1.0)]
    if cfg.has_cross_attn(pos):
        defs += [("ln_x", (d,), (None,), 1.0),
                 ("xattn.wq", (d, h * hd), ("embed", "heads"), 0.02),
                 ("xattn.wk", (d, kh * hd), ("embed", "kv_heads"), 0.02),
                 ("xattn.wv", (d, kh * hd), ("embed", "kv_heads"), 0.02),
                 ("xattn.wo", (h * hd, d), ("heads", "embed"), out_scale),
                 ("xattn.gate", (1,), (None,), 0.0)]
    if cfg.d_ff > 0:
        defs.append(("ln2", (d,), (None,), 1.0))
        if cfg.ffn_kind(pos) == "moe":
            E = cfg.n_experts
            # 'experts'/'expert_ff' resolve per sharding profile: experts
            # replicated with TP over d_ff, or (expert_parallel) experts
            # over 'model' with d_ff whole
            defs += [("moe.router", (d, E), ("embed", None), 0.02),
                     ("moe.wg", (E, d, f), ("experts", "embed", "expert_ff"),
                      0.02),
                     ("moe.wu", (E, d, f), ("experts", "embed", "expert_ff"),
                      0.02),
                     ("moe.wd", (E, f, d), ("experts", "expert_ff", "embed"),
                      out_scale)]
        else:
            if cfg.mlp_kind == "swiglu":
                defs.append(("mlp.wg", (d, f), ("embed", "d_ff"), 0.02))
            defs += [("mlp.wu", (d, f), ("embed", "d_ff"), 0.02),
                     ("mlp.wd", (f, d), ("d_ff", "embed"), out_scale)]
    return defs


def _top_defs(cfg) -> List[Tuple[str, tuple, tuple, float]]:
    d, V = cfg.d_model, cfg.vocab_size
    defs: List[Tuple[str, tuple, tuple, float]] = []
    if cfg.family == "audio":
        defs += [("in_proj_w", (d, d), ("embed", None), 0.02),
                 ("in_proj_b", (d,), (None,), 0.0),
                 ("in_ln", (d,), (None,), 1.0)]
    else:
        defs.append(("tok_embed", (V, d), ("vocab", "embed"), 0.02))
    defs.append(("final_ln", (d,), (None,), 1.0))
    if not cfg.tie_embeddings:
        defs.append(("head_w", (d, V), ("embed", "vocab"), 0.02))
    return defs


def _assign(tree: dict, path: str, val) -> None:
    parts = path.split(".")
    for p_ in parts[:-1]:
        tree = tree.setdefault(p_, {})
    tree[parts[-1]] = val


def _build(cfg, leaf_fn) -> Params:
    """Build the param tree; ``leaf_fn(path, shape, axes, scale)`` produces
    each leaf.  Layer params get a leading n_periods dim ('layers')."""
    np_ = n_periods(cfg)
    tree: Params = {"blocks": {}}
    for path, shape, axes, scale in _top_defs(cfg):
        _assign(tree, path, leaf_fn(path, shape, axes, scale))
    for pos in range(period(cfg)):
        sub: Params = {}
        for path, shape, axes, scale in _layer_defs(cfg, pos):
            _assign(sub, path, leaf_fn(f"blocks.pos{pos}.{path}",
                                       (np_,) + shape, ("layers",) + axes,
                                       scale))
        tree["blocks"][f"pos{pos}"] = sub
    return tree


def init_params(cfg, seed: int = 0, device="cuda", place=None) -> Params:
    """Random parameters from a seeded ``torch.Generator`` on ``device``.
    The structure and the constant leaves are the reference's; the random
    bits are not (tests carry the reference's weights across instead).
    ``place(path, leaf)``, if given, replaces each leaf as soon as it is
    drawn (a sharded launcher keeps its rank's shard: one whole leaf lives
    at a time, and every rank draws the same values from the seed)."""
    device = torch.device(device)
    check_supported(cfg, device)
    pdt = dt(cfg.param_dtype)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)

    def placed(path, shape, axes, scale):
        x = leaf(path, shape, scale)
        return x if place is None else place(path, x)

    def leaf(path, shape, scale):
        if path.endswith("A_log"):
            # mamba: A init = -(1..N) per state dim, log-parameterized
            N = shape[-1]
            a = torch.log(torch.arange(1, N + 1, dtype=torch.float32,
                                       device=device))
            return a.expand(shape).to(pdt).contiguous()
        if path.endswith((".D", "ln1", "ln2", "ln_x", "final_ln", "in_ln",
                          "_norm")):
            return torch.ones(shape, dtype=pdt, device=device)
        if path.endswith("dt_bias"):
            return torch.full(shape, -4.6, dtype=pdt, device=device)
        if scale == 0.0:
            return torch.zeros(shape, dtype=pdt, device=device)
        return normal_init(gen, shape, scale, pdt)

    return _build(cfg, placed)


def param_shapes(cfg) -> Params:
    """The parameter tree as meta tensors (shapes and dtypes, no data)."""
    pdt = dt(cfg.param_dtype)
    return _build(cfg, lambda path, shape, axes, scale:
                  torch.empty(shape, dtype=pdt, device="meta"))


def param_specs(cfg, rules: Rules) -> Params:
    """The parameter tree of specs: one entry a dim (the reference's
    ``PartitionSpec``), from each leaf's logical axes through ``rules``."""
    return _build(cfg, lambda path, shape, axes, scale: rules.spec(*axes))


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


def make_cache_shapes(cfg, batch: int, seq_len: int, rules: Rules = NO_RULES,
                      as_spec: bool = False) -> Dict[str, Any]:
    """The decode cache as meta tensors (shapes and dtypes only), or with
    ``as_spec`` its specs under ``rules``."""
    np_ = n_periods(cfg)
    kh, hd = cfg.kh_eff, cfg.hd      # kv heads after TP replication
    cdt = dt(cfg.compute_dtype)
    Sc = cache_len(cfg, seq_len)

    def leaf(shape, dtype, *axes):
        if as_spec:
            return rules.spec(*axes)
        return torch.empty(shape, dtype=dtype, device="meta")
    tree: Dict[str, Any] = {}
    for pos in range(period(cfg)):
        sub: Dict[str, Any] = {}
        if cfg.layer_kind(pos) == "attn":
            axes = ("layers", "batch", "kv_seq", "kv_heads_cache", None)
            sub["k"] = leaf((np_, batch, Sc, kh, hd), cdt, *axes)
            sub["v"] = leaf((np_, batch, Sc, kh, hd), cdt, *axes)
        else:
            di, N, K = cfg.d_inner, cfg.ssm_state, cfg.d_conv
            sub["conv"] = leaf((np_, batch, K - 1, di), cdt,
                               "layers", "batch", None, "d_inner")
            sub["h"] = leaf((np_, batch, di, N), torch.float32,
                            "layers", "batch", "d_inner", None)
        if cfg.has_cross_attn(pos):
            vshp = (np_, batch, cfg.n_vision_tokens, kh, hd)
            vaxes = ("layers", "batch", None, "kv_heads_cache", None)
            sub["xk"] = leaf(vshp, cdt, *vaxes)
            sub["xv"] = leaf(vshp, cdt, *vaxes)
        tree[f"pos{pos}"] = sub
    tree["pos_idx"] = leaf((), torch.int32)
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
                shape = x.shape[:2] + (Sc,) + x.shape[3:]
                if isinstance(x, DTensor):      # zeros placed as x
                    big = dtensor_zeros(shape, dtype=x.dtype,
                                        device_mesh=x.device_mesh,
                                        placements=x.placements)
                    write_rows(big, x, 2, 0)
                else:
                    big = x.new_zeros(shape)
                    big[:, :, :x.shape[2]].copy_(x)
                x = big
            grown[name] = x
        out[key] = grown
    return out


# ---------------------------------------------------------------------------
#  Layer application
# ---------------------------------------------------------------------------
def _apply_layer(h, sub, cfg, rules, pos, q_pos, kv_pos, vision, cache,
                 cache_pos, mode):
    """One layer at in-period position ``pos``.  Returns (h, new_cache,
    aux): ``aux`` is the MoE layer's load-balancing loss, None elsewhere."""
    new_cache: Dict[str, Any] = {}
    aux = None
    hin = rms_norm(h, sub["ln1"], cfg.norm_eps)
    hin = rules.cons(hin, "batch", "seq_act", None)   # SP: norm runs sharded
    if cfg.layer_kind(pos) == "attn":
        kv_cache = ((cache["k"], cache["v"])
                    if (cache is not None and mode == "decode") else None)
        out, (k_, v_) = attn_block(
            hin, hin, sub["attn"], cfg, rules, q_pos, kv_pos,
            causal=cfg.causal, window=cfg.sliding_window,
            use_rope=cfg.use_rope, kv_cache=kv_cache, cache_pos=cache_pos)
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
    if cfg.has_cross_attn(pos):
        # decode reads the vision K/V its prefill cached; a prefill without
        # vision (text-only serving) skips the branch and caches none
        cached = mode == "decode" and "xk" in cache
        if cached or vision is not None:
            hx = rms_norm(h, sub["ln_x"], cfg.norm_eps)
            if cached:
                xk, xv = cache["xk"], cache["xv"]
                out = _cross_with_cache(hx, xk, xv, sub["xattn"], cfg)
                # the same objects: the decode copy-back skips them
                new_cache["xk"], new_cache["xv"] = xk, xv
            else:
                out, (xk, xv) = attn_block(
                    hx, vision, sub["xattn"], cfg, rules, q_pos,
                    torch.arange(vision.shape[1], device=h.device),
                    causal=False, use_rope=False)
                if mode == "prefill":
                    new_cache["xk"], new_cache["xv"] = xk, xv
            h = h + torch.tanh(sub["xattn"]["gate"].to(h.dtype)) * out
    if cfg.d_ff > 0:
        hin2 = rms_norm(h, sub["ln2"], cfg.norm_eps)
        hin2 = rules.cons(hin2, "batch", "seq_act", None)
        if cfg.ffn_kind(pos) == "moe":
            out, aux = moe_block(hin2, sub["moe"], cfg, rules)
        else:
            out = mlp_block(hin2, sub["mlp"], cfg, rules)
        h = h + out
    # sequence parallelism: the residual stream parked seq-sharded over the
    # TP axis between blocks (a no-op unless cfg.seq_shard)
    h = rules.cons(h, "batch", "seq_act", None)
    return h, new_cache, aux


def _cross_with_cache(hx, xk, xv, p, cfg):
    """Cross-attention against the cached vision K/V (the decode path):
    plain sdpa over ``kh_eff`` heads, no softcap, as the reference's."""
    B, Sq, _ = hx.shape
    h_, kh, hd = cfg.n_heads, cfg.kh_eff, cfg.hd
    cdt = dt(cfg.compute_dtype)
    q = reshape(hx.to(cdt) @ p["wq"].to(cdt), (B, Sq, kh, h_ // kh, hd))
    mask = torch.ones((1, 1, 1, Sq, xk.shape[1]), dtype=torch.bool,
                      device=hx.device)
    out = sdpa(q, xk.to(cdt), xv.to(cdt), mask, 0.0)
    return out.reshape(B, Sq, h_ * hd) @ p["wo"].to(cdt)


# ---------------------------------------------------------------------------
#  Backbone (a loop over periods)
# ---------------------------------------------------------------------------
def backbone(params, h, cfg, rules: Rules, mode: str, q_pos, kv_pos,
             vision=None, cache=None, cache_pos: Optional[int] = None,
             st=None):
    """h: [B, S, d] -> (h, new_cache, aux).

    mode 'train' builds no cache and returns the MoE layers' summed aux loss
    (fp32); with ``remat_policy == "full"`` each layer runs under
    ``torch.utils.checkpoint``: the backward keeps each layer's input and
    runs the layer again, kernels included, before its backward.  The
    reference checkpoints its scan body, a whole period; a layer at a time
    holds one layer's activations, not a period's (Jamba2-3B's period is
    14 layers), and gives the same values.  A block leaf may be a stacked
    tensor or a list of per-layer tensors (``train_step`` passes per-layer
    leaves that accumulate their own gradients).  ``st``: the train step's
    tracers (``obs.trace.StepScope``), under which each layer's forward,
    recompute and backward is a ``model.layer`` span (``_train_layers``).
    mode 'prefill' stacks each layer's new cache along a leading layer dim.
    mode 'decode' updates ``cache`` IN PLACE, layer slice by layer slice: the
    counterpart of the reference's donated cache buffer, so a multi-GB cache
    is never copied per token.  Both return ``aux`` None."""
    if mode not in ("train", "prefill", "decode"):
        raise ValueError(f"unknown backbone mode {mode!r}")
    P_ = period(cfg)
    blocks = params["blocks"]
    if mode == "train":
        return _train_layers(blocks, h, cfg, rules, q_pos, kv_pos, vision,
                             st)
    stacked: Dict[str, Dict[str, torch.Tensor]] = {}
    for i in range(n_periods(cfg)):
        for pos in range(P_):
            key = f"pos{pos}"
            sub = _index(blocks[key], i)
            cc = ({n: t[i] for n, t in cache[key].items()}
                  if mode == "decode" else None)
            h, nc, _ = _apply_layer(h, sub, cfg, rules, pos, q_pos, kv_pos,
                                    vision, cc, cache_pos, mode)
            if mode == "decode":
                for name, new in nc.items():
                    if new is not cc[name]:   # attention wrote its view
                        cc[name].copy_(new)
                continue
            dst = stacked.setdefault(key, {})
            for name, new in nc.items():
                if isinstance(new, DTensor):     # stacked once, placed as new
                    dst.setdefault(name, []).append(new)
                    continue
                if name not in dst:
                    dst[name] = new.new_empty((n_periods(cfg),) + new.shape)
                dst[name][i].copy_(new)
    if mode == "decode":
        return h, cache, None
    for dst in stacked.values():
        for name, new in dst.items():
            if isinstance(new, list):
                dst[name] = torch.stack(new)
    return h, stacked or None, None


def _train_layers(blocks, h, cfg, rules, q_pos, kv_pos, vision, st):
    """Mode 'train': every layer in order, each under its own checkpoint
    when ``remat_policy == "full"`` -> (h, None, the summed aux)."""
    # one unbind a stacked leaf: its backward stacks the layers' gradients
    # once, where indexing would add a full-size zero gradient a layer
    blocks = _unbind(blocks)
    P_ = period(cfg)
    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    spans = None if st is None else _BackwardSpans(
        st, [cfg.layer_kind(i) for i in range(cfg.n_layers)])
    for i in range(n_periods(cfg)):
        for pos in range(P_):
            layer = i * P_ + pos
            fn = _train_layer
            if spans is not None:
                spans.at(h, layer)
                fn = _spanned(st, cfg.layer_kind(pos), layer)
            args = (h, _index(blocks[f"pos{pos}"], i), cfg, rules, pos,
                    q_pos, kv_pos, vision)
            if cfg.remat_policy == "full":
                h, a = checkpoint(fn, *args, use_reentrant=False,
                                  preserve_rng_state=False)
            else:
                h, a = fn(*args)
            if a is not None:
                aux = aux + a
    if spans is not None:
        spans.at(h, cfg.n_layers)
    return h, None, aux


def _train_layer(h, sub, cfg, rules, pos, q_pos, kv_pos, vision):
    """One layer in mode 'train' -> (h, its aux or None)."""
    h, _, a = _apply_layer(h, sub, cfg, rules, pos, q_pos, kv_pos, vision,
                           None, None, "train")
    return h, a


def _spanned(st, kind: str, layer: int):
    """``_train_layer`` inside a ``model.layer`` span: its first call is
    the layer's forward, which counts ``<kind>_layers``; a second, the
    checkpoint's recompute in the backward."""
    ran = False

    def run(*args):
        nonlocal ran
        phase = "recompute" if ran else "forward"
        ran = True
        with st.span("model", "model.layer",
                     counter=f"{kind}_layers" if phase == "forward" else None,
                     kind=kind, layer=layer, phase=phase):
            return _train_layer(*args)
    return run


class _BackwardSpans:
    """The layers' ``model.layer`` backward spans, bounded by gradient
    hooks on autograd's thread (as ``train.grad_accum`` is): layer k's
    opens when the gradient of its output arrives and closes when its
    input's is complete.  The tensor between layers k - 1 and k carries
    one hook that does both, so that one thread's spans stay nested."""

    def __init__(self, st, kinds: List[str]):
        self.st, self.kinds = st, kinds
        self.open: List[Any] = [None] * len(kinds)

    def at(self, x: torch.Tensor, k: int) -> None:
        """Hook ``x``, the input of layer ``k`` (the last layer's output
        when ``k`` is the layer count)."""
        if not x.requires_grad:
            return

        def hook(grad):
            if k < len(self.kinds) and self.open[k] is not None:
                self.open[k].__exit__(None, None, None)
                self.open[k] = None
            if k > 0:
                self.open[k - 1] = self.st.span(
                    "model", "model.layer", kind=self.kinds[k - 1],
                    layer=k - 1, phase="backward").__enter__()
        x.register_hook(hook)


def _unbind(tree):
    """Stacked leaves -> lists of per-layer views; lists stay as they are."""
    if isinstance(tree, dict):
        return {k: _unbind(v) for k, v in tree.items()}
    return list(tree.unbind(0)) if isinstance(tree, torch.Tensor) else tree


def _index(tree, i):
    if isinstance(tree, dict):
        return {k: _index(v, i) for k, v in tree.items()}
    return tree[i]


# ---------------------------------------------------------------------------
#  Entry points
# ---------------------------------------------------------------------------
def _embed(params, batch, cfg, rules: Rules):
    cdt = dt(cfg.compute_dtype)
    if cfg.family == "audio":
        # the stub front end's frame embeddings [B, T, d]
        x = batch["frames"].to(cdt) @ params["in_proj_w"].to(cdt)
        x = x + params["in_proj_b"].to(cdt)
        return rms_norm(x, params["in_ln"], cfg.norm_eps)
    table, tok = params["tok_embed"], batch["tokens"]
    # each rank gathers its batch rows from the whole table (the table's
    # gradient: each data rank's part of the sum)
    tp = rules.placements(tok, "batch", None)
    x = on_shards(lambda t, i: EmbedRows.apply(t, i, cdt), (table, tok),
                  (rules.placements(table, None, None), tp), tp)
    return rules.cons(x, "batch", None, None)


class EmbedRows(torch.autograd.Function):
    """``apply(table, idx, dtype)``: ``table[idx]`` cast to ``dtype``,
    gathered then cast (the reference's cast then gather gives the same
    values without a cast copy of the whole table).  The table's
    gradient sums the rows of repeated ids in fp32 and rounds to the
    table's dtype once, as the reference's gradient does at fp32 compute:
    autograd through a gather in a bf16 table (grok-1's) would round each
    repeat's gradient to bf16 and add them in bf16."""

    @staticmethod
    def forward(ctx, table, idx, dtype):
        ctx.save_for_backward(idx)
        ctx.table = (table.shape, table.dtype)
        return table[idx].to(dtype)

    @staticmethod
    def backward(ctx, grad):
        idx, = ctx.saved_tensors
        shape, dtype = ctx.table
        acc = torch.zeros(shape, dtype=torch.float32, device=grad.device)
        acc.index_put_((idx,), grad.float(), accumulate=True)
        return acc.to(dtype), None, None


def _logits(params, h, cfg, rules: Rules):
    cdt = dt(cfg.compute_dtype)
    h = rms_norm(h, params["final_ln"], cfg.norm_eps)
    head = (params["tok_embed"].to(cdt).t() if cfg.tie_embeddings
            else params["head_w"].to(cdt))
    return rules.cons(h.to(cdt) @ head, "batch", None, "vocab")


def _token_nll(lg: torch.Tensor, tgt: torch.Tensor) -> torch.Tensor:
    """logsumexp minus the gold logit, a position."""
    logz = torch.logsumexp(lg, dim=-1)
    return logz - lg.gather(-1, tgt[..., None].long())[..., 0]


def forward_train(params, batch, cfg, rules: Rules = NO_RULES, st=None):
    """-> (scalar loss, {"ce", "aux"}), differentiable in ``params``.

    ``batch`` holds ``tokens`` [B, S] (audio: ``frames`` [B, T, d] and
    ``labels`` [B, T]; a vlm: ``vision`` too).  The logits are fp32; ``ce``
    is logsumexp minus the gold logit, averaged over the next tokens
    (audio: over ``labels`` at every position); the loss is ``ce + 0.01 *
    aux``, ``aux`` the MoE layers' summed load-balancing loss (0 without
    MoE layers).  ``st``: the train step's tracers, passed to
    ``backbone``."""
    check_supported(cfg, params["final_ln"].device)
    with implicit_replication():
        x = _embed(params, batch, cfg, rules)
        pos = torch.arange(x.shape[1], device=x.device)
        h, _, aux = backbone(params, x, cfg, rules, "train", pos, pos,
                             vision=batch.get("vision"), st=st)
        logits = _logits(params, h, cfg, rules).float()
        if cfg.family == "audio":
            tgt, lg = batch["labels"], logits
        else:
            tgt, lg = batch["tokens"][:, 1:], logits[:, :-1]
        # a row's loss on the rank holding the row: the vocab gathered
        lp = rules.placements(lg, "batch", None, None)
        nll = on_shards(_token_nll, (lg, tgt), (lp, lp), lp)
        ce = nll.mean()
        return ce + 0.01 * aux, {"ce": ce, "aux": aux}


def forward_prefill(params, batch, cfg, rules: Rules = NO_RULES):
    """Full forward over the prompt -> (last-position logits, cache).

    ``batch`` holds ``tokens`` [B, S] (audio: ``frames`` [B, T, d]) and, for
    a vlm, optionally ``vision`` [B, n_vision_tokens, d]."""
    check_supported(cfg, params["final_ln"].device)
    with implicit_replication():
        x = _embed(params, batch, cfg, rules)
        S = x.shape[1]
        pos = torch.arange(S, device=x.device)
        h, cache, _ = backbone(params, x, cfg, rules, "prefill", pos, pos,
                               vision=batch.get("vision"))
        logits = _logits(params, h[:, -1:], cfg, rules)
    if cache is not None:
        cache["pos_idx"] = S
    return logits, cache


def decode_step(params, cache, batch, cfg, rules: Rules = NO_RULES):
    """One-token decode against the cache -> (logits [B,1,V], cache).

    The cache is donated: its tensors are updated in place and the returned
    cache shares them, with ``pos_idx`` one further.  A vlm's cross-attention
    reads the vision K/V its prefill cached."""
    check_supported(cfg, params["final_ln"].device)
    with implicit_replication():
        x = _embed(params, batch, cfg, rules)            # [B, 1, d]
        pos_idx = int(cache["pos_idx"])
        q_pos = torch.tensor([pos_idx], device=x.device)
        h, new_cache, _ = backbone(params, x, cfg, rules, "decode", q_pos,
                                   q_pos, cache=cache, cache_pos=pos_idx)
        logits = _logits(params, h, cfg, rules)
    new_cache = dict(new_cache)
    new_cache["pos_idx"] = pos_idx + 1
    return logits, new_cache
