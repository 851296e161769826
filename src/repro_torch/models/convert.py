"""Carry parameter, optimizer-state and cache trees across from numpy
arrays.

The reference's trees, turned to numpy (``jax.tree.map(np.asarray, ...)``),
become the port's: the same nested dicts, with torch tensors on ``device``
(the card unless the caller asks for another: ``device="cpu"``).
Every leaf is COPIED, because ``torch.from_numpy`` shares the numpy buffer.
bfloat16 arrays (``ml_dtypes.bfloat16``, which ``torch.from_numpy`` refuses)
are copied as their uint16 bits and reinterpreted as ``torch.bfloat16``.
Given a mesh and specs, parameters and moments become DTensors, each rank
copying only its own slice.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from .layers import resolve_device


def tensor_from_numpy(a, device=None) -> torch.Tensor:
    """One array -> a tensor on ``device`` that owns its memory."""
    device = resolve_device(device)
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        bits = torch.from_numpy(np.array(a.view(np.uint16), copy=True))
        return bits.view(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(a, copy=True)).to(device)


def params_from_numpy(tree: Any, device=None, mesh=None, specs=None) -> Any:
    """Nested dicts of numpy arrays -> the same dicts of tensors.  With a
    ``mesh`` (a ``DeviceMesh``) and ``specs`` (the matching tree of specs),
    DTensors placed by them (each spec limited to the dims it divides):
    every rank copies only its own slice of each array to ``device``, so a
    card never holds more than its shard."""
    device = resolve_device(device)
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, device, mesh,
                                     None if specs is None else specs[k])
                for k, v in tree.items()}
    if mesh is None:
        return tensor_from_numpy(tree, device)
    from ..train.sharding import (from_local_shard, local_window,
                                  spec_placements)
    a = np.asarray(tree)
    plc = spec_placements(specs, a.shape, mesh)
    shape, offset = local_window(a.shape, mesh, plc)
    block = a[tuple(slice(o, o + n) for o, n in zip(offset, shape))]
    return from_local_shard(tensor_from_numpy(block, device), mesh, plc,
                            a.shape)


def opt_state_from_numpy(state: Any, device=None, mesh=None,
                         specs=None) -> Any:
    """The reference's AdamW state (``m``, ``v``: parameter trees; ``step``:
    an int32 scalar) -> the port's, ``step`` an int32 tensor on
    ``device``.  With ``mesh``, ``specs`` is the parameter spec tree: the
    moments are placed as their parameters and the step replicated."""
    device = resolve_device(device)
    step = torch.tensor(int(np.asarray(state["step"])), dtype=torch.int32,
                        device=device)
    if mesh is not None:
        from ..train.sharding import distribute
        step = distribute(step, mesh, ())
    return {"m": params_from_numpy(state["m"], device, mesh, specs),
            "v": params_from_numpy(state["v"], device, mesh, specs),
            "step": step}


def cache_from_numpy(tree: Any, device=None) -> Any:
    """A decode cache: like ``params_from_numpy``, with ``pos_idx`` as the
    host int the port's cache keeps."""
    device = resolve_device(device)
    out = {}
    for k, v in tree.items():
        if k == "pos_idx":
            out[k] = int(np.asarray(v))
        elif isinstance(v, dict):
            out[k] = params_from_numpy(v, device)
        else:
            out[k] = tensor_from_numpy(v, device)
    return out
