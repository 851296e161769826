"""Multi-pod dry run: trace every (architecture x input shape) cell's step
on the production meshes and report each device's memory and roofline
terms (the counterpart of ``repro/launch/dryrun.py``).

The reference lowers and compiles each cell through XLA on 512 fake host
devices.  Here the cell's own step (``sharded_train_step``, or
``sharded_serve_steps``' prefill or decode) runs once on DTensors whose
local shards are meta tensors, over a ``DeviceMesh`` of torch's fake
process group at the production world size
(``launch/mesh.make_fake_production_mesh``), under
``launch/op_cost.OpCounter``.  No memory is allocated and no other rank
exists, yet every sharding rule, redistribution and kernel shape of the
step runs as on 256 or 512 cards: a sharding mismatch, a shape a kernel
refuses or a missing DTensor rule fails the cell.  The kernels take their
fake implementations on meta tensors (``kernels/*/ops.py``).  Each
device's bytes are held against the H100's 80 GB and the roofline terms
priced at its data-sheet figures (``launch/roofline.py``).

The fake group is process-global: run the dry run in a process of its own
(it refuses to start beside a real process group).

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch mixtral-8x7b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all               # 16x16
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --multi-pod   # 2x16x16
"""
from __future__ import annotations

import argparse
import gzip
import json
import os
import sys
import time
import traceback
from typing import Any, Dict

import torch
from torch.distributed.tensor import DTensor

from ..configs import ARCH_IDS, get_config, get_shapes
from ..train.optimizer import OptConfig, tree_leaves, tree_map
from .op_cost import OpCounter, totals
from .roofline import HBM_BYTES, model_flops_for, roofline_from_totals

ARTIFACT_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                            "artifacts", "dryrun")
#: the tensors a step's arguments hold, by kind
_ARG_KINDS = ("params", "opt_state", "cache", "batch")


def _local_meta(tree, plc_tree, mesh):
    """A DTensor a leaf of a meta-tensor tree, from a meta tensor of this
    rank's local shard (no tensor of the global shape exists)."""
    from ..train.sharding import from_local_shard, local_window

    def leaf(x, plc):
        shape, _ = local_window(x.shape, mesh, plc)
        return from_local_shard(torch.empty(shape, dtype=x.dtype,
                                            device="meta"), mesh, plc,
                                x.shape)
    return tree_map(leaf, tree, plc_tree)


def _local(x):
    return x.to_local() if isinstance(x, DTensor) else x


def _bytes(tree) -> int:
    return sum(t.numel() * t.element_size()
               for t in (_local(x) for x in tree_leaves(tree))
               if isinstance(t, torch.Tensor))


def trace_step(cfg, shape, mesh=None) -> Dict[str, Any]:
    """Run one step of ``shape`` for ``cfg`` on meta tensors under an
    ``OpCounter``: over ``mesh`` (a ``DeviceMesh``, fake or real) the
    sharded step on local meta shards; with None the unsharded step on
    whole meta tensors (a world of one, as ``launch/train.py`` runs).

    Returns {"counter", "cfg", "args" (local bytes of params, opt_state,
    cache and batch), "output_bytes" (returned tensors no argument
    holds), "alias_bytes" (returned arguments updated in place),
    "trace_s"}.  The batch passed to the sharded train step is the global
    batch on every rank (plain meta tensors), as ``sharded_train_step``
    takes it: its argument bytes are this rank's shard of it."""
    from ..launch.specs import batch_shapes
    from ..train.sharding import local_window
    from ..train.serve_step import make_serve_steps, sharded_serve_steps
    from ..train.train_step import make_train_step, sharded_train_step
    from ..models.transformer import make_cache_shapes, param_shapes
    from ..train.optimizer import opt_state_shapes

    if mesh is not None:
        from .specs import cell_specs
        specs = cell_specs(cfg, shape, mesh)
        cfg, rules = specs["cfg"], specs["rules"]
        place = lambda name: _local_meta(specs[f"{name}_shapes"],
                                         specs[f"{name}_placements"], mesh)
        batch_local = {k: torch.empty(
            local_window(v.shape, mesh, specs["batch_placements"][k])[0],
            dtype=v.dtype, device="meta")
            for k, v in specs["batch_shapes"].items()}
    else:
        from ..models.layers import NO_RULES
        rules = NO_RULES
        whole = {"param": param_shapes(cfg)}
        if shape.kind == "train":
            whole["opt"] = opt_state_shapes(whole["param"], cfg)
        if shape.kind == "decode":
            whole["cache"] = make_cache_shapes(cfg, shape.global_batch,
                                               shape.seq_len)
        place = lambda name: whole[name]
        batch_local = batch_shapes(cfg, shape)
    batch = batch_shapes(cfg, shape)
    args = {"params": place("param"), "batch": batch_local}
    if shape.kind == "train":
        args["opt_state"] = place("opt")
    if shape.kind == "decode":
        args["cache"] = place("cache")
        args["cache"]["pos_idx"] = shape.seq_len - 1  # the cache's last slot
    params = args["params"]
    t0 = time.perf_counter()
    with OpCounter() as counter:
        if shape.kind == "train":
            step = (make_train_step(cfg, OptConfig()) if mesh is None else
                    sharded_train_step(cfg, OptConfig(), rules,
                                       specs["param_specs"],
                                       specs["batch_specs"], mesh))
            out = step(params, args["opt_state"], batch)
        else:
            prefill, decode = (make_serve_steps(cfg) if mesh is None else
                               sharded_serve_steps(
                                   cfg, rules, specs["param_specs"], mesh,
                                   shape.global_batch, shape.seq_len))
            out = (prefill(params, batch) if shape.kind == "prefill"
                   else decode(params, args["cache"], batch))
    trace_s = time.perf_counter() - t0
    held = {id(_local(x).untyped_storage())
            for a in args.values() for x in tree_leaves(a)
            if isinstance(x, torch.Tensor)}
    outs = [_local(x) for x in _out_leaves(out)]
    alias = sum(t.numel() * t.element_size() for t in outs
                if id(t.untyped_storage()) in held)
    total = sum(t.numel() * t.element_size() for t in outs)
    return {"counter": counter, "cfg": cfg, "trace_s": trace_s,
            "args": {k: _bytes(args[k]) for k in _ARG_KINDS if k in args},
            "output_bytes": total - alias, "alias_bytes": alias}


def _out_leaves(out):
    if isinstance(out, dict):
        for v in out.values():
            yield from _out_leaves(v)
    elif isinstance(out, (tuple, list)):
        for v in out:
            yield from _out_leaves(v)
    elif isinstance(out, torch.Tensor):
        yield out


def trace_cell(arch_id: str, shape_name: str, mesh):
    """The counterpart of the reference's ``lower_cell``: one cell's step
    traced on ``mesh``.  Returns (trace_step's result, cfg, shape)."""
    shape = get_shapes(arch_id)[shape_name]
    res = trace_step(get_config(arch_id), shape, mesh)
    return res, res["cfg"], shape


def record(res: Dict[str, Any], cfg, shape, n_devices: int
           ) -> Dict[str, Any]:
    """The reference's memory and roofline record, where a key has a
    meaning here."""
    args = sum(res["args"].values())
    peak = args + res["counter"].peak_bytes
    roof = roofline_from_totals(res["counter"].totals(), n_devices,
                                model_flops_for(cfg, shape))
    return {"memory": {"argument_bytes": args,
                       "argument_bytes_by_kind": dict(res["args"]),
                       "output_bytes": res["output_bytes"],
                       "alias_bytes": res["alias_bytes"],
                       "trace_peak_bytes": res["counter"].peak_bytes,
                       "peak_bytes_per_device": peak,
                       "hbm_bytes": HBM_BYTES},
            "roofline": roof.to_dict()}


def run_cell(arch_id: str, shape_name: str, *, multi_pod: bool = False,
             verbose: bool = True, save: bool = True) -> Dict[str, Any]:
    from .mesh import make_fake_production_mesh
    mesh = make_fake_production_mesh(multi_pod=multi_pod)
    mesh_name = "2x16x16" if multi_pod else "16x16"
    res, cfg, shape = trace_cell(arch_id, shape_name, mesh)
    rec: Dict[str, Any] = {
        "arch": arch_id, "shape": shape_name, "mesh": mesh_name,
        "kind": shape.kind, "seq_len": shape.seq_len,
        "global_batch": shape.global_batch,
        "trace_s": round(res["trace_s"], 1)}
    rec.update(record(res, cfg, shape, mesh.size()))
    if verbose:
        print_record(rec)
    if save:
        os.makedirs(ARTIFACT_DIR, exist_ok=True)
        base = f"{arch_id}_{shape_name}_{mesh_name}"
        with open(os.path.join(ARTIFACT_DIR, base + ".json"), "w") as f:
            json.dump(rec, f, indent=2)
        # the op table: the roofline can be priced again after op_cost or
        # roofline changes without tracing every cell
        with gzip.open(os.path.join(ARTIFACT_DIR, base + ".ops.json.gz"),
                       "wt") as f:
            json.dump(res["counter"].rows(), f)
    return rec


def print_record(rec: Dict[str, Any]) -> None:
    m, r = rec["memory"], rec["roofline"]
    gib = 2 ** 30
    wire = ", ".join(f"{k} {v:.3e} ({int(r['collective_count_by_kind'][k])}"
                     f")" for k, v in
                     sorted(r["collective_bytes_by_kind"].items()))
    print(f"[{rec['mesh']}] {rec['arch']} x {rec['shape']}")
    print(f"  trace {rec['trace_s']:.1f}s")
    print(f"  memory/device: args {m['argument_bytes'] / gib:.2f} GiB"
          f" + trace peak {m['trace_peak_bytes'] / gib:.2f} GiB"
          f" -> peak {m['peak_bytes_per_device'] / gib:.2f} GiB"
          f" (H100 {m['hbm_bytes'] / 1e9:.0f} GB)")
    print(f"  flops/dev {r['flops_per_device']:.3e}"
          f"  bytes/dev {r['bytes_per_device']:.3e}"
          f"  coll bytes/dev {r['collective_bytes_per_device']:.3e}"
          f" [{wire or 'none'}]")
    print(f"  t_compute {r['t_compute_s'] * 1e3:.2f} ms"
          f"  t_memory {r['t_memory_s'] * 1e3:.2f} ms"
          f"  t_collective {r['t_collective_s'] * 1e3:.2f} ms"
          f"  -> bottleneck: {r['bottleneck']}")
    print(f"  MODEL_FLOPS/traced FLOPs {r['useful_flops_fraction']:.3f}"
          f"  roofline fraction {r['roofline_fraction']:.3f}")
    sys.stdout.flush()


def reanalyze_artifacts() -> int:
    """Price every saved artifact's roofline again from its stored op
    table (after op_cost or roofline changes), with no trace."""
    n = 0
    for fname in sorted(os.listdir(ARTIFACT_DIR)):
        if not fname.endswith(".json"):
            continue
        jpath = os.path.join(ARTIFACT_DIR, fname)
        opath = jpath[:-5] + ".ops.json.gz"
        if not os.path.exists(opath):
            continue
        with open(jpath) as f:
            rec = json.load(f)
        with gzip.open(opath, "rt") as f:
            rows = json.load(f)
        roof = roofline_from_totals(totals(rows),
                                    rec["roofline"]["n_devices"],
                                    rec["roofline"]["model_flops"])
        rec["roofline"] = roof.to_dict()
        with open(jpath, "w") as f:
            json.dump(rec, f, indent=2)
        n += 1
    print(f"reanalyzed {n} artifacts")
    return n


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default=None, choices=ARCH_IDS + [None])
    ap.add_argument("--shape", default=None)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--all", action="store_true",
                    help="every (arch x shape) cell")
    ap.add_argument("--no-save", action="store_true")
    args = ap.parse_args()

    cells = []
    if args.all:
        for arch_id in ARCH_IDS:
            for shape_name in get_shapes(arch_id):
                cells.append((arch_id, shape_name))
    else:
        if not args.arch:
            ap.error("--arch required unless --all")
        shapes = get_shapes(args.arch)
        names = [args.shape] if args.shape else list(shapes)
        cells = [(args.arch, s) for s in names]

    failures = []
    for arch_id, shape_name in cells:
        try:
            run_cell(arch_id, shape_name, multi_pod=args.multi_pod,
                     save=not args.no_save)
        except Exception:
            failures.append((arch_id, shape_name))
            traceback.print_exc()
    mesh = "multi-pod 2x16x16" if args.multi_pod else "single-pod 16x16"
    print(f"\n{len(cells) - len(failures)}/{len(cells)} cells passed"
          f" ({mesh})")
    for f in failures:
        print("  FAILED:", f)
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
