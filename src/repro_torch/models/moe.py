"""Top-k Mixture-of-Experts FFN, in torch: the reference's GShard-style
grouped dispatch with a static capacity (``repro/models/moe.py``).

Tokens are flattened and cut into groups of ``Gs = min(moe_group_size, T)``
(the last one padded, with a ``valid`` mask).  Per group the fp32 router
picks each token's top-k experts; a token's slot at expert e gets the rank
``cumsum`` of e's mask over the group, slot 2 ranking after slot 1, and a
rank at or over the capacity C drops that slot.  Dispatch and combine are
dense one-hot einsums, as in the reference; the expert products are batched
matmuls.  None of this is a kernel of the reference: it computes the block
outside any Pallas call, so the port keeps it in plain torch.

``moe_block`` returns the Switch/GShard load-balancing loss beside the
output; training adds it up over the layers into the loss (``0.01 ·
aux``), serving drops it.  Training routes as a prefill does: a group's
slots past the capacity C are dropped, and gradients reach the router
through the kept slots' gates and through the aux loss's mean router
probabilities, as in the reference.
"""
from __future__ import annotations

import functools
from typing import Dict, NamedTuple, Tuple

import torch
import torch.nn.functional as F
from torch.distributed.tensor import Partial, Replicate, Shard

from .layers import Rules, dt, on_shards, reshape


def _capacity(group_size: int, k: int, n_experts: int, factor: float) -> int:
    c = int(round(group_size * k * factor / n_experts))
    return max(8, -(-c // 8) * 8)          # >= 8, a multiple of 8


class Routing(NamedTuple):
    """The router's decisions for tokens in groups ``[Gn, Gs]``."""
    probs: torch.Tensor     # [Gn, Gs, E] fp32 softmax of the router logits
    topi: torch.Tensor      # [Gn, Gs, k] experts, best first
    keep: torch.Tensor      # [Gn, Gs, k] bool: the slot got a capacity slot
    load: torch.Tensor      # [Gn, E] slots asked of each expert (valid only)
    combine: torch.Tensor   # [Gn, Gs, E, C] fp32 gate of each kept slot


def route(xg: torch.Tensor, valid: torch.Tensor, router: torch.Tensor,
          k: int, capacity: int) -> Routing:
    """xg: [Gn, Gs, d]; valid: [Gn, Gs] bool; router: [d, E]."""
    Gn, Gs, _ = xg.shape
    E, C = router.shape[-1], capacity
    logits = xg.float() @ router.float()
    probs = torch.softmax(logits, dim=-1)
    # a stable descending sort breaks ties toward the lower expert, as
    # jax.lax.top_k does (padded tokens, x = 0, tie every expert)
    topv, topi = torch.sort(probs, dim=-1, descending=True, stable=True)
    topv, topi = topv[..., :k], topi[..., :k]
    topv = topv / torch.clamp(topv.sum(-1, keepdim=True), min=1e-9)

    combine = torch.zeros((Gn, Gs, E * C), dtype=torch.float32,
                          device=xg.device)
    prev = torch.zeros((Gn, 1, E), dtype=torch.int64, device=xg.device)
    keep = []
    for slot in range(k):
        e = topi[..., slot]
        mask = F.one_hot(e, E) * valid[..., None]          # [Gn, Gs, E]
        pos = torch.cumsum(mask, dim=1) - 1 + prev          # rank in expert
        prev = prev + mask.sum(dim=1, keepdim=True)
        rank = pos.gather(-1, e[..., None])[..., 0]         # [Gn, Gs]
        kept = valid & (rank < C)
        # a dropped slot or a padded token adds nothing (jax.nn.one_hot of
        # an index outside [0, C) is a zero row); mask, do not clamp
        idx = torch.where(kept, e * C + rank, torch.zeros_like(rank))
        val = torch.where(kept, topv[..., slot], torch.zeros_like(topv[
            ..., slot]))
        combine.scatter_add_(-1, idx[..., None], val[..., None])
        keep.append(kept)
    return Routing(probs, topi, torch.stack(keep, -1), prev[:, 0],
                   combine.view(Gn, Gs, E, C))


def _route_local(xg, vg, router, *, k, capacity):
    return tuple(route(xg, vg, router, k, capacity))


def _experts(xg, combine, wg, wu, wd, *, cfg, rules):
    """Dispatch the groups' tokens to their experts' capacity slots, the
    expert FFN, and the gated combine: xg [Gn, Gs, d], combine [Gn, Gs, E,
    C] fp32 -> [Gn, Gs, d] in the compute dtype."""
    cdt = dt(cfg.compute_dtype)
    dispatch = (combine > 0).to(cdt)                     # [Gn, Gs, E, C]
    combine = combine.to(cdt)
    xe = torch.einsum("gsec,gsd->gecd", dispatch, xg.to(cdt))   # [Gn,E,C,d]
    xe = rules.cons(xe, "batch", "experts", None, None)
    if cfg.mlp_kind == "swiglu":
        h = F.silu(_expert_mm(xe, wg, cdt)) * _expert_mm(xe, wu, cdt)
    else:  # gelu; jax.nn.gelu defaults to the tanh approximation
        h = F.gelu(_expert_mm(xe, wu, cdt), approximate="tanh")
    h = rules.cons(h, "batch", "experts", None, "expert_ff")
    ye = _expert_mm(h, wd, cdt)
    del h
    return torch.einsum("gsec,gecd->gsd", combine, ye)


def _expert_mm(a: torch.Tensor, w: torch.Tensor, cdt: torch.dtype
               ) -> torch.Tensor:
    """a: [Gn, E, C, i] times each expert's w [E, i, o] in ``cdt``.  The
    cast copy of w lives only for this product (grok's three fp32 expert
    weights would take 19.3 GB a layer together)."""
    return torch.einsum("geci,eio->geco", a, w.to(cdt))


def _experts_out(gp, cp, w_in):
    """The experts' output placements: the groups' (``gp``) on a mesh dim
    that splits them, each rank's part of the sum (Partial) on one that
    splits the experts or d_ff, else replicated; None on plain tensors."""
    if gp is None:
        return None
    return tuple(g if isinstance(g, Shard) else
                 Partial() if isinstance(c, Shard) or isinstance(w, Shard)
                 else Replicate() for g, c, w in zip(gp, cp, w_in))


def moe_block(x: torch.Tensor, p: Dict[str, torch.Tensor], cfg,
              rules: Rules) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: [B, S, d] -> (out [B, S, d], aux_loss scalar)."""
    B, S, d = x.shape
    E, k = cfg.n_experts, cfg.experts_per_token
    cdt = dt(cfg.compute_dtype)

    T = B * S
    Gs = min(cfg.moe_group_size, T)
    pad = (-T) % Gs
    xt = x.reshape(T, d)
    valid = torch.ones((T,), dtype=torch.bool, device=x.device)
    if pad:
        xt = F.pad(xt, (0, 0, 0, pad))
        valid = F.pad(valid, (0, pad))
    Gn = xt.shape[0] // Gs
    xg = reshape(xt, (Gn, Gs, d))
    vg = valid.reshape(Gn, Gs)
    xg = rules.cons(xg, "batch", None, None)
    C = _capacity(Gs, k, E, cfg.capacity_factor)

    # each rank routes its own groups (groups over the data axes)
    gp = rules.placements(xg, "batch", None, None)
    vg = rules.place(vg, xg, "batch", None)
    r = Routing(*on_shards(
        functools.partial(_route_local, k=k, capacity=C),
        (xg, vg, p["router"]),
        (gp, gp, rules.placements(p["router"], None, None)), (gp,) * 5))
    # dispatch, the expert products and the combine on each rank's groups:
    # the weights gathered over the data axes (FSDP) and split over 'model'
    # by d_ff (TP) or by expert (EP: the combine's slots of the rank's
    # experts); a rank's output is its part of the sum over 'model',
    # reduced in fp32 before the cast
    cp = rules.placements(r.combine, "batch", None, "experts", None)
    w_in = rules.placements(p["wu"], "experts", None, "expert_ff")
    w_out = rules.placements(p["wd"], "experts", "expert_ff", None)
    weights = (p.get("wg"), p["wu"], p["wd"])
    out = on_shards(functools.partial(_experts, cfg=cfg, rules=rules),
                    (xg, r.combine) + weights,
                    (gp, cp, None if weights[0] is None else w_in, w_in,
                     w_out), _experts_out(gp, cp, w_in))
    out = rules.cons(out, "batch", None, None)       # [Gn, Gs, d]
    out = out.reshape(Gn * Gs, d)
    if pad:
        out = out[:T]
    out = rules.cons(reshape(out, (B, S, d)).to(x.dtype), "batch", None,
                     None)

    # load-balance aux loss (mean over groups): E * sum_e f_e * P_e; padded
    # tokens count in P_e, as in the reference
    me = r.probs.mean(dim=1)                             # [Gn, E]
    top1 = F.one_hot(r.topi[..., 0], E).float()
    fe = (top1 * vg[..., None]).mean(dim=1)              # [Gn, E]
    aux = (E * (fe * me).sum(-1)).mean()
    return out, aux
