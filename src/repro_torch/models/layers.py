"""Shared model building blocks, in torch.

Plain functions over nested dicts of tensors, named as in the reference's
parameter tree.  Prefill and training attention go through the
flash-attention kernel (``kernels/flash_attention``; with gradients its
``FlashAttentionFunction``, the forward kernel and the backward kernel)
unless ``attn_impl == "reference"``, which takes the reference's
plain sdpa (``chunked_sdpa`` past ``attn_q_chunk``); the decode step is
plain einsum attention over the cache, as in the reference.

Sharding is injected through ``Rules`` (logical axis -> mesh axis), as in
the reference: on plain tensors, or with the empty mapping, every
constraint is a no-op; with DTensor parameters the same functions run on
DTensors, ``Rules.cons`` redistributing where the reference constrains,
and the kernels run on each rank's shards (``on_shards``).
"""
from __future__ import annotations

import contextlib
import functools
import math
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.distributed.tensor import (DTensor, Partial, Placement, Replicate,
                                      Shard)
from torch.distributed.tensor.experimental import local_map

from ..kernels.flash_attention import flash_attention


# ---------------------------------------------------------------------------
#  Sharding rules
# ---------------------------------------------------------------------------
class Rules:
    """Maps logical axis names to mesh axis names (or None).  With an empty
    mapping, or on a plain tensor, every constraint is a no-op
    (single-device paths).  On a DTensor, ``cons`` is the counterpart of
    the reference's ``with_sharding_constraint``: ``x.redistribute`` to the
    spec's placements on ``mesh`` (the DTensor's own mesh when None), each
    mesh axis dropped from a dim it does not divide."""

    def __init__(self, mapping: Optional[Dict[str, Any]] = None, mesh=None):
        self.mapping: Dict[str, Any] = dict(mapping or {})
        self.mesh = mesh

    def spec(self, *axes: Optional[str]) -> Tuple[Any, ...]:
        """One entry a tensor dim, as the reference's ``P(...)``."""
        return tuple(self.mapping.get(a) if a else None for a in axes)

    def placements(self, x: torch.Tensor, *axes: Optional[str]):
        """The DTensor placements of ``spec(*axes)`` for ``x`` on the
        rules' mesh (``x``'s own when None), limited to the dims of ``x``
        each axis divides; None for a plain tensor."""
        if not isinstance(x, DTensor):
            return None
        from ..train.sharding import spec_placements
        mesh = self.mesh if self.mesh is not None else x.device_mesh
        return spec_placements(self.spec(*axes), x.shape, mesh)

    def cons(self, x: torch.Tensor, *axes: Optional[str]) -> torch.Tensor:
        if not self.mapping or not isinstance(x, DTensor):
            return x
        plc = self.placements(x, *axes)
        if tuple(x.placements) == plc:
            return x
        return x.redistribute(x.device_mesh, plc)

    def place(self, x: torch.Tensor, like: torch.Tensor,
              *axes: Optional[str]) -> torch.Tensor:
        """``x``, the same whole value on every rank (made inside the
        model), as a DTensor on ``like``'s mesh placed by ``spec(*axes)``;
        ``x`` as it is when ``like`` is a plain tensor."""
        if not isinstance(like, DTensor):
            return x
        from ..train.sharding import distribute
        return distribute(x, like.device_mesh, self.spec(*axes))


@contextlib.contextmanager
def implicit_replication():
    """``torch.distributed.tensor.experimental.implicit_replication`` that
    nests: a plain tensor meeting a DTensor in an op counts as replicated
    over the mesh (positions, masks, zeros made inside the model), and the
    setting before the block is restored after it (torch's own resets it
    to off, which would leave an enclosing step's backward without it)."""
    dispatcher = DTensor._op_dispatcher
    before = dispatcher._allow_implicit_replication
    dispatcher._allow_implicit_replication = True
    try:
        yield
    finally:
        dispatcher._allow_implicit_replication = before


def on_shards(fn, args, in_placements, out_placements):
    """``fn(*args)`` on each rank's shards (``local_map``): every DTensor
    argument is first redistributed to its entry of ``in_placements`` (None
    for an argument that is not a tensor), and the outputs become DTensors
    placed by ``out_placements``.  The kernels run this way, and so does
    work whose DTensor rules are missing or differ between torch versions
    (the embedding's gather, the MoE router and experts, the depthwise
    conv, decode attention, the Mamba step, the loss's rows); ``fn`` sees
    plain local tensors.  With no DTensor argument it is ``fn(*args)``
    and the placements are not read (they are None then)."""
    mesh = next((a.device_mesh for a in args if isinstance(a, DTensor)),
                None)
    if mesh is None:
        return fn(*args)
    # local_map reads a tuple as one entry an output: one output's
    # placements go as a list
    single = all(isinstance(p, Placement) for p in out_placements)
    outs = [out_placements] if single else list(out_placements)
    # a mesh dim an output is split on (sharded, or each rank's part of a
    # sum) splits the work: there a replicated input's gradient is each
    # rank's part of the sum (Partial); on a mesh dim every output is
    # replicated on, each rank holds all of it
    split = [any(isinstance(o[j], (Shard, Partial)) for o in outs)
             for j in range(mesh.ndim)]
    grads = tuple(None if p is None else [
        Partial() if split[j] and isinstance(pl, Replicate) else pl
        for j, pl in enumerate(p)] for p in in_placements)
    return local_map(
        functools.partial(_contiguous_grads, fn),
        out_placements=(list(out_placements) if single
                            else tuple(list(o) for o in outs)),
        in_placements=tuple(None if p is None else list(p)
                            for p in in_placements),
        in_grad_placements=grads, device_mesh=mesh,
        redistribute_inputs=True)(*args)


class _ContiguousGrad(torch.autograd.Function):
    """The identity, whose backward makes its gradient contiguous."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return grad.contiguous()


def _contiguous_grads(fn, *args):
    """``fn(*args)`` on local tensors, each input's gradient made
    contiguous: ``local_map`` wraps it in a DTensor whose strides are the
    contiguous ones of its global shape, and a later DTensor reshape that
    takes a view by those strides fails on a local gradient in another
    layout (the einsums' backward inside the kernels' plain backward, at
    one kv head a rank)."""
    if torch.is_grad_enabled():
        args = tuple(_ContiguousGrad.apply(a) if isinstance(a, torch.Tensor)
                     and a.requires_grad else a for a in args)
    return fn(*args)


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
    # the queries grouped by the kv heads after their repeat (kv_repeat
    # r: each kv head repeated r times, its G queries split r ways): the
    # same GQA, a view of the same (kh, G) order
    r = cfg.kv_repeat
    q = reshape(q, (B, Sq, kh * r, G // r, hd))
    k = reshape(k, (B, kv_src.shape[1], kh, hd))
    v = reshape(v, (B, kv_src.shape[1], kh, hd))
    q = rules.cons(q, "batch", None, "kv_heads_act", None, None)
    k = rules.cons(k, "batch", None, "kv_heads_act", None)
    v = rules.cons(v, "batch", None, "kv_heads_act", None)

    if use_rope:
        q = apply_rope(q.reshape(B, Sq, h, hd), q_pos, cfg.rope_theta
                       ).reshape(B, Sq, kh * r, G // r, hd)
        k = apply_rope(k, kv_pos, cfg.rope_theta)

    if r > 1:
        k = k.repeat_interleave(r, dim=2)
        v = v.repeat_interleave(r, dim=2)
        k = rules.cons(k, "batch", None, "kv_heads_act", None)
        v = rules.cons(v, "batch", None, "kv_heads_act", None)

    if kv_cache is not None:
        k_cache, v_cache = kv_cache
        S_cache = k_cache.shape[1]
        slot = cache_pos % window if window and window > 0 else cache_pos
        start = _clamp_start(slot, S_cache, k.shape[1])
        write_rows(k_cache, k, 1, start)
        write_rows(v_cache, v, 1, start)
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
        # each rank's batch rows and kv heads; a cache split along its
        # sequence (the flash-decode layout) is gathered for the step
        qp = rules.placements(q, "batch", None, "kv_heads_act", None, None)
        kp = rules.placements(k_cache, "batch", None, "kv_heads_act", None)
        out = on_shards(functools.partial(
            _cache_sdpa, cdt=cdt, softcap=cfg.logit_softcap),
            (q, k_cache, v_cache, mask[None, None, None]),
            (qp, kp, kp, None), qp)
        new_cache = (k_cache, v_cache)
    else:
        qc = cfg.attn_q_chunk
        if attn_impl in ("auto", "cuda"):
            # the kernel on each rank's heads: batch over the data axes,
            # kv heads over 'model' when they divide it; out as q
            qp = rules.placements(q, "batch", None, "kv_heads_act", None,
                                  None)
            kp = rules.placements(k, "batch", None, "kv_heads_act", None)
            out = on_shards(functools.partial(
                _flash_local, causal=causal, window=window,
                softcap=cfg.logit_softcap, impl=attn_impl),
                (q, k, v), (qp, kp, kp), qp)
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
    out = rules.cons(out, "batch", None, None)
    return out, new_cache


def reshape(x: torch.Tensor, shape) -> torch.Tensor:
    """``x.reshape(shape)``.  On a DTensor, a sharded dim that the reshape
    splits into several is first gathered over the mesh dims that shard it
    unless the first part of the split divides over them: DTensor cannot
    split it then (mixtral's 8 kv heads over 'model' 16; a microbatch of
    16 sequences over 32 data ranks), where GSPMD reshards by itself."""
    if not isinstance(x, DTensor):
        return x.reshape(shape)
    sizes = tuple(shape)
    gather = set()
    for j, first in _split_dims(tuple(x.shape), sizes).items():
        mdims = [i for i, pl in enumerate(x.placements)
                 if isinstance(pl, Shard) and pl.dim == j]
        if mdims and first % math.prod(x.device_mesh.size(i)
                                       for i in mdims):
            gather.update(mdims)
    if gather:
        x = x.redistribute(x.device_mesh, [
            Replicate() if i in gather else pl
            for i, pl in enumerate(x.placements)])
    return x.reshape(sizes)


def _split_dims(src, dst):
    """{dim of ``src``: the size of the first of the dims of ``dst`` it is
    split into}, for each dim a reshape from ``src`` to ``dst`` splits."""
    out, i, k = {}, 0, 0
    while i < len(src) and k < len(dst):
        gi, gk, a, b = [i], [k], src[i], dst[k]
        while a != b:
            if a < b:
                i += 1
                a *= src[i]
                gi.append(i)
            else:
                k += 1
                b *= dst[k]
                gk.append(k)
        if len(gi) == 1 and len(gk) > 1:
            out[gi[0]] = next((dst[q] for q in gk if dst[q] != 1), 1)
        i, k = i + 1, k + 1
    return out


def _cache_sdpa(q, k_cache, v_cache, mask, *, cdt, softcap):
    return sdpa(q, k_cache.to(cdt), v_cache.to(cdt), mask, softcap)


def _flash_local(q, k, v, **kw):
    return flash_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                           **kw)


def write_rows(dst: torch.Tensor, src: torch.Tensor, dim: int, start: int
               ) -> None:
    """``dst.narrow(dim, start, n).copy_(src)``, in place, ``n`` the rows
    of ``src``.  On a DTensor ``dst`` each rank writes the rows of its own
    shard, so a cache split along ``dim`` (the flash-decode layout: its
    sequence over 'model') takes the write with no gather."""
    n = src.shape[dim]
    if not isinstance(dst, DTensor):
        dst.narrow(dim, start, n).copy_(src)
        return
    from ..train.sharding import local_window
    mesh = dst.device_mesh
    plc = tuple(Replicate() if isinstance(p, Shard) and p.dim == dim else p
                for p in dst.placements)
    src = src.redistribute(mesh, plc).to_local()
    shape, offset = local_window(dst.shape, mesh, dst.placements)
    lo, hi = max(start, offset[dim]), min(start + n, offset[dim] + shape[dim])
    if hi > lo:
        dst.to_local().narrow(dim, lo - offset[dim], hi - lo).copy_(
            src.narrow(dim, lo - start, hi - lo).to(dst.dtype))


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
    hid = rules.cons(hid, "batch", None, "d_ff")
    return rules.cons(hid @ p["wd"].to(cdt), "batch", None, None)


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
