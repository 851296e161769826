"""Train step: microbatch gradient accumulation (the paper's medium-level
horizontal partitioning: the global batch is split into m even splits that
stream through forward and backward like shared caches through an
execution tree), gradient clipping and AdamW (``repro/train/
train_step.py``).

The reference's jitted step donates params and opt state; here
``adamw_update`` writes them in place once the last microbatch's backward
has freed its graph.  Gradients accumulate in ``grad_accum_dtype`` (""
means ``opt_state_dtype``), in one buffer a parameter leaf that the
per-layer gradients land in as the backward produces them.
``jit_train_step`` (in/out shardings over a mesh) waits for the sharding
slice (ROADMAP queue A).
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from ..models.layers import NO_RULES, Rules, dt
from ..models.transformer import forward_train
from .optimizer import OptConfig, adamw_update, tree_map


def _split_microbatches(batch: Dict[str, torch.Tensor], m: int
                        ) -> List[Dict[str, torch.Tensor]]:
    """[B, ...] -> m dicts of [B/m, ...] views."""
    for name, x in batch.items():
        if x.shape[0] % m:
            raise ValueError(f"global batch {x.shape[0]} ({name}) is not "
                             f"divisible by {m} microbatches")
    return [{k: x.reshape(m, x.shape[0] // m, *x.shape[1:])[i]
             for k, x in batch.items()} for i in range(m)]


def _accumulating_leaves(params, gdt: Optional[torch.dtype]
                         ) -> Tuple[Any, Any, list]:
    """(leaf tree, accumulator tree, hook handles).

    The leaf tree holds, for each parameter, leaves that share its memory
    and need a gradient: a stacked block leaf becomes a list of per-layer
    leaves, so that each layer's gradient arrives on its own.  A hook adds
    each arriving gradient, cast to ``gdt`` (None: the parameter's dtype),
    into the matching slice of a zeroed accumulator of the parameter's
    shape, then drops it: a gradient lives from its layer's backward to
    that add, never beside a whole second copy."""
    handles = []

    def bind(leaf: torch.Tensor, acc: torch.Tensor) -> torch.Tensor:
        leaf = leaf.detach().requires_grad_(True)

        def add(t: torch.Tensor) -> None:
            acc.add_(t.grad.to(acc.dtype))
            t.grad = None
        handles.append(leaf.register_post_accumulate_grad_hook(add))
        return leaf

    def make(p: torch.Tensor, stacked: bool):
        acc = torch.zeros(p.shape, dtype=gdt or p.dtype, device=p.device)
        if stacked:
            return [bind(p[i], acc[i]) for i in range(p.shape[0])], acc
        return bind(p, acc), acc

    pairs = {k: tree_map(lambda p: make(p, k == "blocks"), v)
             for k, v in params.items()}
    return (tree_map(lambda pr: pr[0], pairs),
            tree_map(lambda pr: pr[1], pairs), handles)


def make_train_step(cfg, ocfg: OptConfig, rules: Rules = NO_RULES,
                    grad_transform: Optional[Callable] = None):
    """Returns ``train_step(params, opt_state, batch) -> (params,
    opt_state, metrics)``.  ``params`` and ``opt_state`` are updated in
    place and returned; ``grad_transform(grads) -> grads`` hooks gradient
    compression and the like.  ``metrics``: ``loss``, ``ce``, ``aux``
    (each the mean over the microbatches), ``lr`` and ``grad_norm``, 0-dim
    tensors on the parameters' device."""
    m = max(cfg.grad_accum, 1)
    # one microbatch: the gradients in the parameters' dtype, as the
    # reference's value_and_grad gives them
    gdt = dt(cfg.grad_accum_dtype or cfg.opt_state_dtype) if m > 1 else None

    def train_step(params, opt_state, batch):
        leaves, grads, handles = _accumulating_leaves(params, gdt)
        try:
            sums: Dict[str, torch.Tensor] = {}
            for mb in (_split_microbatches(batch, m) if m > 1 else [batch]):
                loss, mets = forward_train(leaves, mb, cfg, rules)
                loss.backward()
                for k, v in dict(mets, loss=loss).items():
                    v = v.detach()
                    sums[k] = sums[k] + v if k in sums else v
        finally:
            for h in handles:
                h.remove()
        del leaves
        if m > 1:
            grads = tree_map(lambda g: g.div_(m), grads)
        if grad_transform is not None:
            grads = grad_transform(grads)
        stats = adamw_update(grads, params, opt_state, ocfg, cfg)
        metrics = {k: v / m for k, v in sums.items()}
        metrics.update(stats)
        return params, opt_state, metrics

    return train_step
