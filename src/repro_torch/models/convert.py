"""Carry parameter, optimizer-state and cache trees across from numpy
arrays.

The reference's trees, turned to numpy (``jax.tree.map(np.asarray, ...)``),
become the port's: the same nested dicts, with torch tensors on ``device``
(the card unless the caller asks for another: ``device="cpu"``).
Every leaf is COPIED, because ``torch.from_numpy`` shares the numpy buffer.
bfloat16 arrays (``ml_dtypes.bfloat16``, which ``torch.from_numpy`` refuses)
are copied as their uint16 bits and reinterpreted as ``torch.bfloat16``.
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


def params_from_numpy(tree: Any, device=None) -> Any:
    """Nested dicts of numpy arrays -> the same dicts of tensors."""
    device = resolve_device(device)
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, device) for k, v in tree.items()}
    return tensor_from_numpy(tree, device)


def opt_state_from_numpy(state: Any, device=None) -> Any:
    """The reference's AdamW state (``m``, ``v``: parameter trees; ``step``:
    an int32 scalar) -> the port's, ``step`` an int32 tensor on
    ``device``."""
    device = resolve_device(device)
    return {"m": params_from_numpy(state["m"], device),
            "v": params_from_numpy(state["v"], device),
            "step": torch.tensor(int(np.asarray(state["step"])),
                                 dtype=torch.int32, device=device)}


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
