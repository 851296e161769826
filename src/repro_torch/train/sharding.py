"""Logical-axis -> mesh-axis rules for every execution profile, and their
DTensor placements (``repro/train/sharding.py``).

The production mesh is (data=16, model=16), optionally with a leading pod=2
axis (multi-pod).  Parameters are 2D-sharded: FSDP-style over the data-like
axes ('embed' dims) x tensor-parallel over 'model' ('heads'/'d_ff'/'vocab'/
'd_inner'), uniform across profiles so a checkpoint reshards trivially.

Profiles differ only in activation layout:
  train:   batch over (pod, data)
  prefill: batch over (pod, data)
  decode:  batch over (pod, data); KV-cache heads over 'model' when the
           kv-head count divides the model axis, otherwise the cache SEQ
           dim goes over 'model' (flash-decode layout)
  long:    batch=1 -> unsharded; KV/SSM state sharded as wide as possible
           (seq over data[+model]).

A spec is the reference's ``PartitionSpec`` as a plain tuple: one entry a
tensor dim, each a mesh-axis name, a tuple of names or None.  On a
``torch.distributed`` ``DeviceMesh`` it becomes DTensor placements
(``placements``): ``Shard(dim)`` on each mesh dim a tensor dim names,
``Replicate()`` on the others; a tensor dim over ``("pod", "data")`` is
split over both mesh dims in mesh order, pod outermost, as GSPMD splits it.
"""
from __future__ import annotations

from typing import Any, Dict, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import (DTensor, Partial, Replicate, Shard,
                                      distribute_tensor)
from torch.distributed.tensor._utils import \
    compute_local_shape_and_global_offset

from ..models.layers import Rules

Spec = Tuple[Any, ...]


def mesh_shape(mesh) -> Dict[str, int]:
    """{axis name: size} of a ``DeviceMesh`` or of any object whose
    ``.shape`` maps axis names to sizes (the reference's ``Mesh.shape``)."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, mesh.shape))
    return dict(mesh.shape)


def make_rules(mesh, profile: str = "train", cfg=None) -> Rules:
    """``mesh``: a ``DeviceMesh`` (the rules then constrain DTensors on it)
    or any object with ``.shape`` mapping axis -> size (specs only)."""
    shape = mesh_shape(mesh)
    multi_pod = "pod" in shape
    data_ax = ("pod", "data") if multi_pod else "data"
    model_n = shape.get("model", 1)

    kh = getattr(cfg, "kh_eff", getattr(cfg, "n_kv_heads", 0)) \
        if cfg is not None else 0
    kv_div = bool(kh) and kh % model_n == 0

    mapping = {
        # ---- parameters (2D: FSDP x TP) ----
        "embed": data_ax,            # FSDP axis
        "vocab": "model",
        "heads": "model",            # fused h*hd projection dim
        "kv_heads": "model",         # fused kh*hd projection dim
        "d_ff": "model",
        "d_inner": "model",
        # MoE: baseline = experts replicated, TP over d_ff; EP mode (needs
        # n_experts % model == 0) = experts over 'model', d_ff unsharded
        "experts": ("model" if getattr(cfg, "expert_parallel", False)
                    else None),
        "expert_ff": (None if getattr(cfg, "expert_parallel", False)
                      else "model"),
        "layers": None,
        # ---- activations ----
        "batch": data_ax,
        "kv_seq": None,
        "kv_heads_act": "model" if kv_div else None,
        "kv_heads_cache": "model" if kv_div else None,
        # sequence parallelism (residual stream seq dim over 'model');
        # None = replicated residual (baseline, pure Megatron-TP)
        "seq_act": ("model" if getattr(cfg, "seq_shard", False)
                    and profile == "train" else None),
    }
    if profile == "decode" and not kv_div:
        # flash-decode: split the KV cache along SEQ over 'model'
        mapping["kv_seq"] = "model"
    if profile == "long":
        mapping["batch"] = None              # global_batch = 1
        mapping["kv_seq"] = (data_ax if kv_div
                             else (("pod", "data", "model") if multi_pod
                                   else ("data", "model")))
    return Rules(mapping, mesh if isinstance(mesh, dist.DeviceMesh) else None)


def data_axis_size(mesh) -> int:
    shape = mesh_shape(mesh)
    size = shape["data"]
    if "pod" in shape:
        size *= shape["pod"]
    return size


# ---------------------------------------------------------------------------
#  Specs -> placements
# ---------------------------------------------------------------------------
def _names(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, (tuple, list)) else (entry,)


def axis_size(mesh, entry) -> int:
    """Devices a spec entry splits its tensor dim over."""
    shape = mesh_shape(mesh)
    return int(np.prod([shape[n] for n in _names(entry)], dtype=np.int64))


def limit_spec(spec: Spec, shape, mesh) -> Spec:
    """Drop mesh axes from dims they do not divide (the reference's
    ``launch/specs.limit_spec``: e.g. hubert's vocab=504 over model=16)."""
    dims = tuple(shape.shape) if hasattr(shape, "shape") else tuple(shape)
    entries = list(spec) + [None] * (len(dims) - len(spec))
    return tuple(e if d % axis_size(mesh, e) == 0 else None
                 for d, e in zip(dims, entries))


def placements(spec: Spec, mesh) -> Tuple[Any, ...]:
    """A spec -> one placement a mesh dim (``mesh`` a ``DeviceMesh`` or a
    shape object)."""
    names = list(mesh_shape(mesh))
    out: list = [Replicate()] * len(names)
    for dim, entry in enumerate(spec):
        axes = _names(entry)
        order = [names.index(a) for a in axes]
        if order != sorted(order):
            raise ValueError(f"spec entry {entry!r} is not in mesh order "
                             f"{tuple(names)}")
        for i in order:
            if isinstance(out[i], Shard):
                raise ValueError(f"mesh axis {names[i]!r} appears twice in "
                                 f"spec {spec!r}")
            out[i] = Shard(dim)
    return tuple(out)


def spec_placements(spec: Spec, shape, mesh) -> Tuple[Any, ...]:
    """``placements`` of ``spec`` limited to the dims of ``shape`` it
    divides."""
    return placements(limit_spec(spec, shape, mesh), mesh)


# ---------------------------------------------------------------------------
#  Distributing tensors
# ---------------------------------------------------------------------------
def local_window(shape, mesh, plc) -> Tuple[Tuple[int, ...], Tuple[int, ...]]:
    """(local shape, global offset) of this rank's shard."""
    return compute_local_shape_and_global_offset(tuple(shape), mesh, plc)


def from_local_shard(local: torch.Tensor, mesh, plc, shape) -> DTensor:
    """A DTensor of global ``shape`` from this rank's shard (no copy, no
    communication)."""
    stride = tuple(torch.empty(shape, device="meta").stride())
    return DTensor.from_local(local, mesh, plc, run_check=False,
                              shape=torch.Size(shape), stride=stride)


def distribute(x: torch.Tensor, mesh, spec: Spec) -> DTensor:
    """``x`` placed by ``spec`` (limited to the dims it divides).  A plain
    tensor is the whole value on every rank: each takes its own slice,
    with no communication.  A DTensor already so placed is returned as
    it is; one placed otherwise is redistributed."""
    plc = spec_placements(spec, x.shape, mesh)
    if isinstance(x, DTensor):
        if tuple(x.placements) == plc:
            return x
        return x.redistribute(mesh, plc)
    return distribute_tensor(x, mesh, plc, src_data_rank=None)


def distribute_tree(tree, spec_tree, mesh):
    """``distribute`` leaf by leaf over nested dicts (specs are leaves)."""
    if isinstance(tree, dict):
        return {k: distribute_tree(v, spec_tree[k], mesh)
                for k, v in tree.items()}
    return distribute(tree, mesh, spec_tree)


def full(x):
    """The whole value of a DTensor on every rank; a plain tensor as it
    is."""
    return x.full_tensor() if isinstance(x, DTensor) else x


def local(x):
    """This rank's shard of a DTensor; a plain tensor as it is."""
    return x.to_local() if isinstance(x, DTensor) else x


def sum_of_squares(leaves: Sequence[torch.Tensor]) -> torch.Tensor:
    """[len(leaves)] fp32: each leaf's global sum of squares.  A DTensor
    leaf's local sum is all-reduced over the mesh dims it is sharded on
    (its replicas hold the same values and are not added), leaves sharded
    alike in one all-reduce a mesh dim."""
    sums = [torch.sum(torch.square(local(x).float())) for x in leaves]
    groups: Dict[Tuple[int, ...], list] = {}
    for i, x in enumerate(leaves):
        if not isinstance(x, DTensor):
            continue
        if any(isinstance(p, Partial) for p in x.placements):
            raise ValueError("sum_of_squares: a Partial DTensor has no "
                             "value of its own on a rank")
        dims = tuple(j for j, p in enumerate(x.placements)
                     if isinstance(p, Shard))
        groups.setdefault(dims, []).append(i)
    for dims, idx in groups.items():
        if not dims:
            continue
        mesh = leaves[idx[0]].device_mesh
        vec = torch.stack([sums[i] for i in idx])
        for j in dims:
            dist.all_reduce(vec, group=mesh.get_group(j))
        for k, i in enumerate(idx):
            sums[i] = vec[k]
    return torch.stack(sums)
