"""AdamW (own implementation) with the reference's dtype policy and its
warmup + cosine schedule (``repro/train/optimizer.py``).

The update math runs in fp32; moments are stored in ``opt_state_dtype``
and parameters in ``param_dtype``; leaves with fewer than 2 dims (norms,
biases) take no weight decay.  ``adamw_update`` writes the new parameters
and moments INTO the given tensors under ``torch.no_grad()``: the
counterpart of the reference's donated params and opt state (its jitted
step reuses their buffers), so no second copy of the state exists.  Call
it only once no autograd graph holds the parameters, that is after the
last microbatch's backward.

Two routes (``impl``).  On CUDA tensors the update and its global norm
are the fused kernels of ``csrc/adamw.cu`` (``kernels.adamw``): one pass a
leaf that reads p, g, m and v once and writes p, m and v once, and one
that reads g once for the norm, bitwise the plain route's update at the
same clip scale.  On CPU tensors, and with ``impl="reference"``
anywhere, the plain route: the same math in PyTorch ops a piece at a time
(``_pieces``), and ``global_norm``, the oracle the kernels are held to.
Leaves on both devices raise.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, Iterator, List

import torch
from torch.distributed.tensor import DTensor

from ..kernels.adamw import adamw_cuda, square_sums_cuda
from ..models.layers import dt


@dataclass(frozen=True)
class OptConfig:
    lr: float = 3e-4
    min_lr_frac: float = 0.1
    warmup_steps: int = 100
    total_steps: int = 10_000
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0


def _as_step(step, device=None) -> torch.Tensor:
    return torch.as_tensor(step, dtype=torch.int32, device=device)


def lr_at(step, cfg: OptConfig) -> torch.Tensor:
    """The learning rate at ``step`` (an int or an int32 tensor), as an fp32
    tensor on the step's device, computed as the reference computes it in
    fp32: linear warmup to ``lr``, then a cosine down to ``min_lr_frac``."""
    step = _as_step(step)
    warm = cfg.lr * (step + 1).float() / max(cfg.warmup_steps, 1)
    t = torch.clamp((step - cfg.warmup_steps).float()
                    / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = cfg.min_lr_frac * cfg.lr + (1 - cfg.min_lr_frac) * cfg.lr \
        * 0.5 * (1 + torch.cos(math.pi * t))
    return torch.where(step < cfg.warmup_steps, warm, cos)


def tree_leaves(tree) -> List[torch.Tensor]:
    """The leaves of a nested dict, in the reference's order (jax flattens
    a dict by its sorted keys)."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    return [tree]


def tree_map(fn, tree, *rest):
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)


def init_opt_state(params, model_cfg) -> Dict[str, Any]:
    """Zero moments in ``opt_state_dtype`` beside each parameter, and the
    step as an int32 tensor on the parameters' device."""
    odt = dt(model_cfg.opt_state_dtype)

    def zeros(p):
        if isinstance(p, DTensor):                  # placed as p
            return torch.zeros_like(p, dtype=odt)
        return torch.zeros(p.shape, dtype=odt, device=p.device)
    device = tree_leaves(params)[0].device
    return {"m": tree_map(zeros, params), "v": tree_map(zeros, params),
            "step": torch.zeros((), dtype=torch.int32, device=device)}


def opt_state_shapes(params, model_cfg) -> Dict[str, Any]:
    """The opt state as meta tensors (shapes and dtypes, no data)."""
    odt = dt(model_cfg.opt_state_dtype)
    meta = lambda p: torch.empty(p.shape, dtype=odt, device="meta")
    return {"m": tree_map(meta, params), "v": tree_map(meta, params),
            "step": torch.empty((), dtype=torch.int32, device="meta")}


def opt_state_specs(param_specs_tree) -> Dict[str, Any]:
    """Specs mirroring the parameter sharding; the step replicated."""
    return {"m": param_specs_tree, "v": param_specs_tree, "step": ()}


#: the most elements of a leaf, or of one layer of a stacked leaf, that
#: AdamW and the global norm take at a time: their fp32 temporaries (a
#: dozen in the update) stay at 256 MB each, where a whole leaf's would
#: not fit beside the state on one card (qwen2-72b's head_w: 1.25e9
#: elements, 5 GB a temporary; one grok-1 layer's stacked experts: 1.61e9)
PIECE = 1 << 26


def _pieces(*ts: torch.Tensor, by_layer: bool = False) -> Iterator[tuple]:
    """Aligned views of tensors of one shape, a tuple at a time, that
    cover them once, each of at most PIECE elements: tensors of PIECE or
    fewer whole, larger ones in flat runs (by their leading dim where one
    is not contiguous).  With ``by_layer`` a stacked leaf (3 or more dims)
    goes one layer at a time first, so that the update never holds fp32
    temporaries of more than one layer.  The update is elementwise, so
    the pieces change none of its values."""
    if by_layer and ts[0].dim() >= 3:
        for rows in zip(*(t.unbind(0) for t in ts)):
            yield from _pieces(*rows)
    elif ts[0].numel() <= PIECE:
        yield ts
    elif all(t.is_contiguous() for t in ts):
        yield from zip(*(t.view(-1).split(PIECE) for t in ts))
    else:
        for rows in zip(*(t.unbind(0) for t in ts)):
            yield from _pieces(*rows)


def n_pieces(params) -> int:
    """How many pieces the plain route of ``adamw_update`` updates
    ``params`` in: those of the leaves on the CPU."""
    return sum(1 for P in tree_leaves(params) if not _local(P).is_cuda
               for _ in _pieces(_local(P), by_layer=True))


def n_fused(params) -> int:
    """How many elements the fused kernel of ``adamw_update`` updates in
    ``params``: those of the leaves on the card (a rank's shards)."""
    return sum(_local(P).numel() for P in tree_leaves(params)
               if _local(P).is_cuda)


def _fused(leaves, impl: str) -> bool:
    """Whether ``leaves`` take the kernels: with ``impl`` "auto" where any
    lies on the card (the kernels raise on one that does not)."""
    if impl not in ("auto", "reference"):
        raise ValueError(f"unknown adamw impl {impl!r}")
    return impl == "auto" and any(_local(t).is_cuda for t in leaves)


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in fp32.  DTensor leaves
    count each element once over the mesh (``sharding.sum_of_squares``)."""
    leaves = tree_leaves(tree)
    if any(isinstance(x, DTensor) for x in leaves):
        from .sharding import sum_of_squares
        return torch.sqrt(sum_of_squares(leaves).sum())
    return torch.sqrt(torch.stack([square_sum(x) for x in leaves]).sum())


def square_sum(x: torch.Tensor) -> torch.Tensor:
    """The sum of squares of one leaf in fp32, a piece at a time
    (``_pieces``): a leaf of at most PIECE elements in one sum, as the
    reference sums it."""
    sums = [torch.sum(torch.square(p.float())) for p, in _pieces(x)]
    return sums[0] if len(sums) == 1 else torch.stack(sums).sum()


def _local(t):
    return t.to_local() if isinstance(t, DTensor) else t


@torch.no_grad()
def adamw_update(grads, params, opt_state, ocfg: OptConfig, model_cfg,
                 grad_div: int = 1, impl: str = "auto"
                 ) -> Dict[str, torch.Tensor]:
    """One AdamW step, IN PLACE on ``params`` and ``opt_state`` (see the
    module docstring), on ``grads / grad_div`` (the gradients summed over
    ``grad_div`` passes; the plain route divides them in place first, the
    kernels as they read them).  Returns the stats ``{"lr",
    "grad_norm"}`` as 0-dim tensors.  DTensor leaves (a sharded step)
    update each rank's shards in place, clipped by the global gradient
    norm.  ``impl``: "auto" (the kernels on the card, the plain route on
    the CPU; leaves on both devices raise) or "reference" (the plain
    route on any device)."""
    step = _local(opt_state["step"])
    lr = lr_at(step, ocfg)
    leaves = list(zip(tree_leaves(params), tree_leaves(grads),
                      tree_leaves(opt_state["m"]),
                      tree_leaves(opt_state["v"])))
    fused = _fused([t for leaf in leaves for t in leaf], impl)
    sharded = any(isinstance(G, DTensor) for _, G, _, _ in leaves)
    if grad_div != 1 and (sharded or not fused):
        for _, G, _, _ in leaves:
            G.div_(grad_div)
        grad_div = 1
    if fused and not sharded:
        norms = square_sums_cuda([G for _, G, _, _ in leaves], grad_div,
                                 ocfg.grad_clip)
        gnorm, scale = norms[1], norms[2]
    else:
        gnorm = global_norm(grads)
        scale = (torch.clamp(ocfg.grad_clip / (gnorm + 1e-9), max=1.0)
                 if ocfg.grad_clip > 0
                 else torch.ones((), device=gnorm.device))
    b1, b2 = ocfg.b1, ocfg.b2
    bc1 = 1 - torch.pow(b1, step.float() + 1)
    bc2 = 1 - torch.pow(b2, step.float() + 1)
    for P, G, M, V in leaves:
        wd = ocfg.weight_decay if P.dim() >= 2 else 0.0   # none on norms
        P, G, M, V = (_local(t) for t in (P, G, M, V))
        if fused:
            adamw_cuda(P, G, M, V, lr=lr, scale=scale, bc1=bc1, bc2=bc2,
                       b1=b1, b2=b2, eps=ocfg.eps, wd=wd, grad_div=grad_div)
            continue
        for p, g, m, v in _pieces(P, G, M, V, by_layer=True):
            g32 = g.float() * scale
            m32 = b1 * m.float() + (1 - b1) * g32
            v32 = b2 * v.float() + (1 - b2) * g32 * g32
            mh = m32 / bc1
            vh = v32 / bc2
            p32 = p.float()
            upd = lr * (mh / (torch.sqrt(vh) + ocfg.eps) + wd * p32)
            p.copy_(p32 - upd)
            m.copy_(m32)
            v.copy_(v32)
    step.add_(1)
    return {"lr": lr, "grad_norm": gnorm}
