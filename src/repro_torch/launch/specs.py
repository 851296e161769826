"""Shapes and placements for every (arch x shape x mesh) cell
(``repro/launch/specs.py``).

No device allocation happens here: parameters, opt state, caches and
batches are meta tensors, and their shardings are specs (the reference's
``PartitionSpec`` as tuples) and DTensor placements in place of
``NamedSharding``.  ``mesh`` is a ``DeviceMesh`` or any object whose
``.shape`` maps axis names to sizes (``launch.mesh.make_production_mesh``).
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from ..configs.base import ModelConfig, ShapeConfig
from ..models.layers import Rules
from ..models.transformer import make_cache_shapes, param_shapes, param_specs
from ..train.optimizer import opt_state_shapes, opt_state_specs, tree_map
from ..train.sharding import limit_spec, make_rules, mesh_shape, placements

__all__ = ["limit_spec", "limit_specs_tree", "batch_shapes", "batch_pspecs",
           "kv_repeat_for", "cell_specs", "placements_tree"]


def limit_specs_tree(spec_tree, shape_tree, mesh):
    """``limit_spec`` leaf by leaf (specs are the leaves)."""
    return tree_map(lambda s, sh: limit_spec(s, sh, mesh), spec_tree,
                    shape_tree)


def placements_tree(spec_tree, mesh):
    return tree_map(lambda s: placements(s, mesh), spec_tree)


def batch_shapes(cfg: ModelConfig, shape: ShapeConfig) -> Dict[str, Any]:
    """Model inputs of one cell as meta tensors (train/prefill: the full
    window; decode: one new token against a seq_len cache).  Token ids and
    labels are int64, as the port's batches carry them."""
    B, S = shape.global_batch, shape.seq_len
    S_in = 1 if shape.kind == "decode" else S
    cdt = getattr(torch, cfg.compute_dtype)
    meta = lambda shp, dtype: torch.empty(shp, dtype=dtype, device="meta")
    out: Dict[str, Any] = {}
    if cfg.family == "audio":
        # the modality front end is a stub: precomputed frame embeddings
        out["frames"] = meta((B, S_in, cfg.d_model), cdt)
        if shape.kind == "train":
            out["labels"] = meta((B, S_in), torch.int64)
        return out
    out["tokens"] = meta((B, S_in), torch.int64)
    if cfg.family == "vlm" and shape.kind != "decode":
        out["vision"] = meta((B, cfg.n_vision_tokens, cfg.d_model), cdt)
    return out


def batch_pspecs(cfg: ModelConfig, shape: ShapeConfig, rules: Rules
                 ) -> Dict[str, Any]:
    specs: Dict[str, Any] = {}
    for name in batch_shapes(cfg, shape):
        if name in ("tokens", "labels"):
            specs[name] = rules.spec("batch", None)
        else:                                    # frames / vision: [B, T, d]
            specs[name] = rules.spec("batch", None, None)
    return specs


def kv_repeat_for(cfg: ModelConfig, model_n: int) -> int:
    """TP kv-head replication factor: smallest r with (kh*r) % model_n == 0
    and h % (kh*r) == 0 (query regrouping must stay even).  1 if none."""
    kh, h = cfg.n_kv_heads, cfg.n_heads
    if not kh or not h or kh % model_n == 0:
        return 1
    if model_n % kh == 0:
        r = model_n // kh
        if h % (kh * r) == 0:
            return r
    return 1


def cell_specs(cfg: ModelConfig, shape: ShapeConfig, mesh) -> Dict[str, Any]:
    """Everything the launchers need for one cell: shapes (meta tensor
    trees), specs limited to the dims they divide, and their placements.
    Returns the possibly-updated cfg under 'cfg' (kv_repeat applied);
    callers must use it for the model functions."""
    r = kv_repeat_for(cfg, mesh_shape(mesh).get("model", 1))
    if r > 1:
        cfg = cfg.replace(kv_repeat=r)
    profile = shape.kind
    if shape.kind == "decode" and shape.seq_len >= 262_144:
        profile = "long"
    rules = make_rules(mesh, profile, cfg)

    p_shapes = param_shapes(cfg)
    p_spec = limit_specs_tree(param_specs(cfg, rules), p_shapes, mesh)
    b_shapes = batch_shapes(cfg, shape)
    b_spec = limit_specs_tree(batch_pspecs(cfg, shape, rules), b_shapes,
                              mesh)
    out: Dict[str, Any] = {
        "cfg": cfg,
        "rules": rules,
        "profile": profile,
        "param_shapes": p_shapes,
        "param_specs": p_spec,
        "param_placements": placements_tree(p_spec, mesh),
        "batch_shapes": b_shapes,
        "batch_specs": b_spec,
        "batch_placements": placements_tree(b_spec, mesh),
    }
    if shape.kind == "train":
        out["opt_shapes"] = opt_state_shapes(p_shapes, cfg)
        out["opt_specs"] = limit_specs_tree(opt_state_specs(p_spec),
                                            out["opt_shapes"], mesh)
        out["opt_placements"] = placements_tree(out["opt_specs"], mesh)
    if shape.kind == "decode":
        out["cache_shapes"] = make_cache_shapes(
            cfg, shape.global_batch, shape.seq_len, rules)
        out["cache_specs"] = limit_specs_tree(
            make_cache_shapes(cfg, shape.global_batch, shape.seq_len, rules,
                              as_spec=True), out["cache_shapes"], mesh)
        out["cache_placements"] = placements_tree(out["cache_specs"], mesh)
    return out
