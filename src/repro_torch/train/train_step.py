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
``sharded_train_step`` is the reference's ``jit_train_step``: the same
step over a ``DeviceMesh``, on DTensors placed by the sharding rules.

Under a tracer (``obs.trace``) a step records the spans ``train.step``,
``train.microbatch``, ``model.forward``, ``model.backward``,
``model.layer`` (each layer's forward, recompute and backward, from
``models/transformer.py``), ``train.grad_accum`` (in each accumulator
hook, on whichever thread runs the backward) and ``train.update`` (the
scaling, ``grad_transform`` and AdamW), and counts ``train_steps``,
``attn_layers`` and ``mamba_layers`` (the layers of each kind run forward,
over the step's microbatches), ``grad_accum_adds``, ``adamw_pieces`` (the
plain route's pieces) and ``adamw_fused_elems`` (the elements the fused
kernel updates); without one it reads one contextvar a step.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Tuple

import torch
from torch.distributed.tensor import DTensor

from ..models.layers import NO_RULES, Rules, dt
from ..models.transformer import forward_train
from ..obs import trace
from .optimizer import (OptConfig, adamw_update, n_fused, n_pieces,
                        tree_map)

_OFF = trace.NULL_SPAN


def _split_microbatches(batch: Dict[str, torch.Tensor], m: int
                        ) -> List[Dict[str, torch.Tensor]]:
    """[B, ...] -> m dicts of [B/m, ...] views."""
    for name, x in batch.items():
        if x.shape[0] % m:
            raise ValueError(f"global batch {x.shape[0]} ({name}) is not "
                             f"divisible by {m} microbatches")
    return [{k: x.reshape(m, x.shape[0] // m, *x.shape[1:])[i]
             for k, x in batch.items()} for i in range(m)]


def _accumulating_leaves(params, gdt: Optional[torch.dtype],
                         st: Optional[trace.StepScope] = None
                         ) -> Tuple[Any, Any, list]:
    """(leaf tree, accumulator tree, hook handles).

    The leaf tree holds, for each parameter, leaves that share its memory
    and need a gradient: a stacked block leaf becomes a list of per-layer
    leaves, so that each layer's gradient arrives on its own.  A hook adds
    each arriving gradient, cast to ``gdt`` (None: the parameter's dtype),
    into the matching slice of a zeroed accumulator of the parameter's
    shape, then drops it: a gradient lives from its layer's backward to
    that add, never beside a whole second copy.  ``st``: the step's
    tracers, which each add is a ``train.grad_accum`` span of."""
    handles = []

    def bind(leaf: torch.Tensor, acc: torch.Tensor) -> torch.Tensor:
        leaf = leaf.detach().requires_grad_(True)

        def add(t: torch.Tensor) -> None:
            with _OFF if st is None else st.span(
                    "train", "train.grad_accum", counter="grad_accum_adds"):
                acc.add_(t.grad.to(acc.dtype))
                t.grad = None
        handles.append(leaf.register_post_accumulate_grad_hook(add))
        return leaf

    def make(p: torch.Tensor, stacked: bool):
        if isinstance(p, DTensor):                  # placed as p
            acc = torch.zeros_like(p, dtype=gdt or p.dtype)
        else:
            acc = torch.zeros(p.shape, dtype=gdt or p.dtype, device=p.device)
        if stacked:
            return [bind(p[i], acc[i]) for i in range(p.shape[0])], acc
        return bind(p, acc), acc

    pairs = {k: tree_map(lambda p: make(p, k == "blocks"), v)
             for k, v in params.items()}
    return (tree_map(lambda pr: pr[0], pairs),
            tree_map(lambda pr: pr[1], pairs), handles)


def make_train_step(cfg, ocfg: OptConfig, rules: Rules = NO_RULES,
                    grad_transform: Optional[Callable] = None,
                    place_batch: Optional[Callable] = None,
                    merge: int = 1):
    """Returns ``train_step(params, opt_state, batch) -> (params,
    opt_state, metrics)``.  ``params`` and ``opt_state`` are updated in
    place and returned; ``grad_transform(grads) -> grads`` hooks gradient
    compression and the like.  ``metrics``: ``loss``, ``ce``, ``aux``
    (each the mean over the microbatches), ``lr`` and ``grad_norm``, 0-dim
    tensors on the parameters' device.  ``place_batch(mb) -> mb`` places
    each microbatch (``sharded_train_step``: over the mesh).  ``merge``
    runs that many neighbouring microbatches as one pass (``sharded_train_
    step``, where one microbatch does not split over the batch axes; see
    ``microbatches_a_pass``)."""
    m = max(cfg.grad_accum, 1)
    if m % merge:
        raise ValueError(f"{merge} microbatches a pass do not divide {m}")
    passes = m // merge
    # one microbatch: the gradients in the parameters' dtype, as the
    # reference's value_and_grad gives them
    gdt = dt(cfg.grad_accum_dtype or cfg.opt_state_dtype) if m > 1 else None

    # AdamW's plain pieces and fused elements, counted once traced
    pieces: List[int] = []

    def train_step(params, opt_state, batch):
        st = trace.step_scope()
        with _OFF if st is None else st.span("train", "train.step",
                                             microbatches=passes):
            leaves, grads, handles = _accumulating_leaves(params, gdt, st)
            try:
                sums: Dict[str, torch.Tensor] = {}
                for k, mb in enumerate(
                        _split_microbatches(batch, passes) if passes > 1
                        else [batch]):
                    with _OFF if st is None else st.span(
                            "train", "train.microbatch", k=k):
                        if place_batch is not None:
                            mb = place_batch(mb)
                        with _OFF if st is None else st.span(
                                "model", "model.forward", k=k):
                            loss, mets = forward_train(leaves, mb, cfg, rules,
                                                       st=st)
                        if isinstance(loss, DTensor):
                            loss = loss.full_tensor()
                        with _OFF if st is None else st.span(
                                "model", "model.backward", k=k):
                            loss.backward()
                        for name, v in dict(mets, loss=loss).items():
                            v = v.detach()
                            sums[name] = sums[name] + v if name in sums else v
            finally:
                for h in handles:
                    h.remove()
            del leaves
            if st is not None and not pieces:
                pieces.extend((n_pieces(params), n_fused(params)))
            with _OFF if st is None else st.span(
                    "train", "train.update", pieces=pieces[0]):
                # AdamW divides by the pass count as it reads the sums,
                # unless a transform has to see the mean
                div = passes
                if grad_transform is not None:
                    if passes > 1:
                        grads = tree_map(lambda g: g.div_(passes), grads)
                    grads, div = grad_transform(grads), 1
                stats = adamw_update(grads, params, opt_state, ocfg, cfg,
                                     grad_div=div)
            if st is not None:
                st.count("adamw_pieces", pieces[0])
                if pieces[1]:
                    st.count("adamw_fused_elems", pieces[1])
            metrics = {k: v / passes for k, v in sums.items()}
            metrics.update(stats)
        return params, opt_state, metrics

    return train_step


def microbatches_a_pass(cfg, batch, batch_spec, mesh) -> int:
    """How many neighbouring microbatches ``sharded_train_step`` runs as
    one pass: 1 when a microbatch splits evenly over the batch axes of
    ``batch_spec`` (dim 0), else the least k dividing ``grad_accum`` for
    which k microbatches do (16 sequences over 32 ranks: k = 2, a pod's
    ranks one sequence each, the other pod's the next microbatch's), so
    every rank runs its own share and none the whole microbatch.  This is
    exact: the loss is a mean of per-sequence terms of equal size (the
    MoE aux loss a mean of per-group terms, its groups and capacity the
    same when a group lies within one sequence), so k microbatches in one
    pass give the mean of their separate gradients.  1 (the microbatch
    whole on each rank) where no k does, or where MoE groups would span
    sequences."""
    from .sharding import axis_size
    m = max(cfg.grad_accum, 1)
    x = next(iter(batch.values()))
    mb, n = x.shape[0] // m, axis_size(mesh, batch_spec[0])
    if mb % n == 0 or (cfg.n_experts and x.shape[1] % cfg.moe_group_size):
        return 1
    return next((k for k in range(2, m + 1) if m % k == 0 and k * mb % n == 0),
                1)


def sharded_train_step(cfg, ocfg: OptConfig, rules: Rules, param_spec_tree,
                       batch_specs, mesh,
                       grad_transform: Optional[Callable] = None):
    """The counterpart of the reference's ``jit_train_step``: the train step
    over ``mesh`` (a ``DeviceMesh``), every rank calling it with the same
    arguments.

    Params and opt state are placed by ``param_spec_tree`` (and
    ``opt_state_specs`` of it), each spec limited to the dims it divides:
    a plain tensor is the whole value on each rank, which keeps its own
    slice; a DTensor already so placed is used as it is, and then updated
    in place, the counterpart of ``donate_argnums=(0, 1)``.  The batch
    holds the global batch on every rank (plain tensors; a DTensor is
    gathered first); it is split into microbatches as the unsharded step
    splits it, k neighbouring microbatches a pass where one alone does not
    split over the batch axes (``microbatches_a_pass``), and each pass is
    placed by ``batch_specs``.  The model runs on
    DTensors under ``implicit_replication`` (its backward too), the
    kernels on each rank's shards; gradients accumulate into DTensors
    placed as their parameters, AdamW updates each rank's shards in place,
    clipped by the global norm.  Returns (params, opt_state, metrics),
    the metrics whole 0-dim tensors on every rank."""
    from ..models.layers import implicit_replication
    from .optimizer import opt_state_specs
    from .sharding import distribute, distribute_tree, full
    steps: Dict[int, Callable] = {}
    o_specs = opt_state_specs(param_spec_tree)

    def train_step(params, opt_state, batch):
        params = distribute_tree(params, param_spec_tree, mesh)
        opt_state = distribute_tree(opt_state, o_specs, mesh)
        batch = {k: full(v) for k, v in batch.items()}
        k = microbatches_a_pass(cfg, batch, next(iter(batch_specs.values())),
                                mesh)
        if k not in steps:
            steps[k] = make_train_step(
                cfg, ocfg, rules, grad_transform, merge=k,
                place_batch=lambda mb: {n: distribute(v, mesh, batch_specs[n])
                                        for n, v in mb.items()})
        with implicit_replication():
            params, opt_state, metrics = steps[k](params, opt_state, batch)
        return params, opt_state, {k: full(v) for k, v in metrics.items()}

    return train_step
