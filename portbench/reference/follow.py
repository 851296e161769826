"""Drive a reference model file through a cell's first training steps and
read what the comparison needs: each step's loss, each leaf's first
gradient as the optimizer takes it (clipped), and each leaf's change
after the last step.  A layer of a stacked leaf is a leaf of its own.

The batches are packed by ``docs`` from the run's seed and the weights
made by ``weights`` from it: nothing the port made is read.
"""
from __future__ import annotations

import importlib
from typing import Dict

import torch

from .. import docs
from ..weights import layer_slices, make_leaves, stacked
from .common import adamw


def model_module(cj: dict):
    return importlib.import_module(f"portbench.reference.{cj['reference']}")


def _norm(x: torch.Tensor) -> float:
    return float(torch.linalg.vector_norm(x.float()))


def follow(cj: dict, tr: dict, seed: int, steps: int, device,
           prec: str = "fp32", drop_half: bool = False) -> Dict[str, object]:
    """``steps`` AdamW steps of the reference from the seed's weights over
    the seed's batches, each microbatch in blocks of the configuration's
    ``reference_rows`` rows (all of them where it names none), so that
    the reference fits where the program's microbatch would not.  ``drop_half``: each global batch's second half
    left out and the loss the mean over the rest (a planted fault)."""
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        return _follow(cj, tr, seed, steps, torch.device(device), prec,
                       drop_half)
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = tf32


def _follow(cj, tr, seed, steps, device, prec, drop_half):
    mod = model_module(cj)
    specs = mod.leaf_specs(cj)
    opt = tr["optimizer"]
    params, names, leaves, decay = {}, [], [], []
    for path, x in make_leaves(specs, seed, device):
        parts = []
        for name, t in layer_slices(path, x):
            t = t.detach().requires_grad_(True)
            parts.append(t)
            names.append(name)
            leaves.append(t)
            decay.append(path not in opt["no_decay"])
        params[path] = parts if stacked(path) else parts[0]
    m = [torch.zeros_like(t) for t in leaves]
    v = [torch.zeros_like(t) for t in leaves]
    batches = docs.global_batches(tr, cj["as_run"]["vocab_size"], seed)
    micro = cj["microbatches"]
    losses, grad_norms = [], {}
    for step in range(steps):
        tokens = torch.from_numpy(next(batches)[:, :-1]).long().to(device)
        n_mb = micro
        if drop_half:
            tokens, n_mb = tokens[:tokens.shape[0] // 2], max(1, micro // 2)
        rows = tokens.shape[0] // n_mb
        block = min(cj.get("reference_rows") or rows, rows)
        if rows % block:
            raise ValueError(f"reference_rows {block} does not divide a "
                             f"microbatch's {rows} rows")
        total = 0.0
        for j in range(n_mb * rows // block):
            # a microbatch's mean loss as the mean of its blocks' means
            loss = mod.loss(params, tokens[j * block:(j + 1) * block], cj,
                            prec) * (block / rows)
            loss.backward()
            total += float(loss.detach())
        grads = []
        for t in leaves:
            grads.append(t.grad.div_(n_mb))
            t.grad = None
        scale = adamw([t.detach() for t in leaves], grads, m, v, step, opt,
                      decay)
        if step == 0:
            grad_norms = {n: _norm(g) * scale for n, g in zip(names, grads)}
        del grads
        losses.append(total / n_mb)
    del m, v
    delta = {}
    by_name = dict(zip(names, leaves))
    for path, x in make_leaves(specs, seed, device):
        for name, t0 in layer_slices(path, x):
            delta[name] = _norm(by_name[name].detach() - t0)
    return {"losses": losses, "grad_norms": grad_norms, "delta_norms": delta}
