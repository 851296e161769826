"""Checkpoints (``repro/train/checkpoint.py``): atomic, optionally
asynchronous, keep-last-k.

Layout:  <dir>/step_<N:08d>/
           arrays.npz   one entry a leaf, keyed by its flattened path
                        ("params/blocks/pos0/attn/wq", the reference's
                        keys, in its sorted-dict order)
           meta.json    step, paths, shapes, dtypes, time, extra

Two deliberate differences from the reference: the meta is JSON (the
reference writes ``meta.msgpack``; msgpack is not a dependency of the
port), and a bfloat16 leaf is stored as its uint16 bits with "bfloat16"
in ``meta["dtypes"]`` (numpy has no bfloat16 without ``ml_dtypes``).  A
checkpoint without ``meta.json`` (the reference's) restores with the step
its directory names.

Saves go to ``step_<N>.tmp`` and are renamed into place.  Restore places
each array like the template's leaf (its dtype and device).  The manager copies the state to the host BEFORE it returns
and before any background write: the optimizer updates the parameters in
place, so the next step would otherwise change what is being written.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from .optimizer import tree_map

_BF16 = "bfloat16"


# ------------------------------------------------------------- tree <-> flat
def _flatten_with_paths(tree, prefix: str = "") -> List[Tuple[str, Any]]:
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out += _flatten_with_paths(tree[k], f"{prefix}{k}/")
        return out
    return [(prefix[:-1], tree)]


def tree_paths(tree) -> List[str]:
    return [k for k, _ in _flatten_with_paths(tree)]


def _unflatten_like(template, values: Dict[str, Any], prefix: str = ""):
    if isinstance(template, dict):
        return {k: _unflatten_like(v, values, f"{prefix}{k}/")
                for k, v in template.items()}
    return values[prefix[:-1]]


def _host_view(x) -> np.ndarray:
    """A leaf as a numpy array (bf16 as its uint16 bits); a CPU tensor's
    memory is shared, not copied."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy().view(np.uint16)
        return x.numpy()
    return np.asarray(x)


def _host_copy(x):
    """A leaf copied to the host: a CPU tensor (or numpy array) that owns
    its memory."""
    if isinstance(x, torch.Tensor):
        return x.detach().to("cpu", copy=True)
    return np.array(x, copy=True)


def _dtype_name(x) -> str:
    if isinstance(x, torch.Tensor):
        return str(x.dtype).split(".")[-1]
    return str(np.asarray(x).dtype)


# ------------------------------------------------------------------ save
def save_checkpoint(directory: str, step: int, state: Dict[str, Any],
                    extra_meta: Optional[dict] = None) -> str:
    """Synchronous atomic save of a nested dict of tensors or arrays."""
    os.makedirs(directory, exist_ok=True)
    final = os.path.join(directory, f"step_{step:08d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    flat = _flatten_with_paths(state)
    dtypes = {k: _dtype_name(v) for k, v in flat}
    arrays = {k: _host_view(v) for k, v in flat}
    np.savez(os.path.join(tmp, "arrays.npz"), **arrays)
    meta = {"step": step,
            "paths": [k for k, _ in flat],
            "shapes": {k: list(a.shape) for k, a in arrays.items()},
            "dtypes": dtypes,
            "time": time.time(),
            "extra": extra_meta or {}}
    with open(os.path.join(tmp, "meta.json"), "w") as f:
        json.dump(meta, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    return final


def _steps(directory: str) -> List[int]:
    if not os.path.isdir(directory):
        return []
    return sorted(int(d.split("_")[1]) for d in os.listdir(directory)
                  if d.startswith("step_") and not d.endswith(".tmp"))


def latest_step(directory: str) -> Optional[int]:
    steps = _steps(directory)
    return steps[-1] if steps else None


def _to_tensor(a: np.ndarray, like, dtype_name: Optional[str]):
    if dtype_name == _BF16 or (a.dtype.itemsize == 2 and a.dtype.kind == "V"):
        t = torch.from_numpy(np.array(a.view(np.uint16).view(np.int16),
                                      copy=True)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a, copy=True))
    if isinstance(like, torch.Tensor):
        return t.to(device=like.device, dtype=like.dtype)
    return t


def restore_checkpoint(directory: str, template, step: Optional[int] = None):
    """-> (tree shaped like ``template``, meta).  Each leaf takes the
    template leaf's dtype and device."""
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {directory}")
    path = os.path.join(directory, f"step_{step:08d}")
    meta_path = os.path.join(path, "meta.json")
    if os.path.exists(meta_path):
        with open(meta_path) as f:
            meta = json.load(f)
    else:
        meta = {"step": step, "dtypes": {}}
    with np.load(os.path.join(path, "arrays.npz")) as data:
        flat = _flatten_with_paths(template)
        values = {k: _to_tensor(data[k], like, meta["dtypes"].get(k))
                  for k, like in flat}
    return _unflatten_like(template, values), meta


# ----------------------------------------------------------- manager
class CheckpointManager:
    """Periodic, asynchronous, keep-last-k checkpointing."""

    def __init__(self, directory: str, every_steps: int = 100,
                 keep: int = 3, async_save: bool = True):
        self.directory = directory
        self.every_steps = every_steps
        self.keep = keep
        self.async_save = async_save
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        self.saves = 0

    def maybe_save(self, step: int, state, extra_meta=None,
                   force: bool = False) -> bool:
        if not force and (step % self.every_steps != 0 or step == 0):
            return False
        # the host copy is taken here, before the next in-place step
        host_state = tree_map(_host_copy, state)
        if self.async_save:
            self.wait()
            self._thread = threading.Thread(
                target=self._save, args=(step, host_state, extra_meta),
                daemon=True, name="checkpoint")
            self._thread.start()
        else:
            self._save(step, host_state, extra_meta)
        return True

    def _save(self, step, host_state, extra_meta) -> None:
        try:
            save_checkpoint(self.directory, step, host_state, extra_meta)
            self.saves += 1
            self._gc()
        except Exception as e:  # noqa: BLE001 — re-raised by wait()
            if not self.async_save:
                raise
            self._error = e

    def wait(self) -> None:
        """Join the background save; re-raise its error, if any."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def _gc(self) -> None:
        for s in _steps(self.directory)[:-self.keep]:
            shutil.rmtree(os.path.join(self.directory, f"step_{s:08d}"),
                          ignore_errors=True)
