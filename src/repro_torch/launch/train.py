"""Training launcher: the end-to-end loop wiring every layer of the
trainer on one card.

  ETL input pipeline (core engine, shared caches, Algorithm-2 prefetch;
  the batch copied to the card on the prefetch thread)
    -> train_step (microbatch splits, per-period remat, the kernels'
       forwards with the plain versions' gradients, in-place AdamW)
    -> CheckpointManager (async, atomic, keep-k) + StragglerWatchdog

Runs on the card unless given ``--device cpu`` (the kernels' plain
versions, for the smoke configs).  ``--mesh data=D,model=M`` (and
``pod=P``) shards the step over the ranks ``torchrun`` starts: the
process group is ``nccl`` on the card and ``gloo`` on the CPU unless
``--dist-backend`` names one; under ``nccl`` a world larger than the
visible cards raises.  ``REPRO_TRACE=1`` records the run's spans (the
train step's, the model's and the input feed's) and writes them to
``REPRO_TRACE_PATH`` at the end (``python -m repro_torch.obs.report``
reads the file).

Usage:
  PYTHONPATH=src python -m repro_torch.launch.train --arch stablelm-3b \\
      --steps 4 --batch 8 --seq-len 2048
  PYTHONPATH=src python -m repro_torch.launch.train --arch stablelm-3b \\
      --smoke --device cpu --steps 50 --batch 8 --seq-len 128
  PYTHONPATH=src torchrun --nproc-per-node 4 -m repro_torch.launch.train \\
      --arch stablelm-3b --smoke --device cpu --mesh data=2,model=2 \\
      --steps 4 --batch 8 --seq-len 64
"""
from __future__ import annotations

import argparse
import time
from typing import Any, Dict, Optional

import numpy as np
import torch

from ..configs import ARCH_IDS, get_config
from ..data import InputPipeline, PipelineConfig, PrefetchQueue, make_lm_batch_fn
from ..models.layers import NO_RULES, resolve_device
from ..models.transformer import check_supported, init_params
from ..obs import trace
from ..train.checkpoint import (CheckpointManager, latest_step,
                                restore_checkpoint)
from ..train.fault import StragglerWatchdog
from ..train.optimizer import OptConfig, init_opt_state
from ..train.train_step import make_train_step, sharded_train_step


def _is_main() -> bool:
    """Rank 0 of a sharded run, or an unsharded one: the one that logs."""
    import torch.distributed as dist
    return not dist.is_initialized() or dist.get_rank() == 0


def build_state(cfg, seed: int = 0, device=None, mesh=None, specs=None):
    """(params from a ``torch.Generator`` seeded with ``seed``, zero opt
    state), on ``device`` (the card unless the caller asks for another).
    With a ``mesh``, DTensors placed by ``specs`` (the parameter spec
    tree): each rank keeps its shard of each leaf as it is drawn."""
    device = resolve_device(device)
    check_supported(cfg, device)
    place = None
    if mesh is not None:
        from ..train.sharding import distribute

        def place(path, x):
            spec = specs
            for part in path.split("."):
                spec = spec[part]
            return distribute(x, mesh, spec)
    params = init_params(cfg, seed=seed, device=device, place=place)
    return params, init_opt_state(params, cfg)


def sharded_setup(cfg, mesh, batch: int, seq_len: int):
    """(rules, limited param specs, limited batch specs) of the ``train``
    profile on ``mesh``."""
    from ..configs.base import ShapeConfig
    from .specs import cell_specs
    cell = cell_specs(cfg, ShapeConfig("train", seq_len, batch, "train",
                                       grad_accum=cfg.grad_accum), mesh)
    return cell["cfg"], cell["rules"], cell["param_specs"], \
        cell["batch_specs"]


def to_device(batch: Dict[str, np.ndarray], device) -> Dict[str, torch.Tensor]:
    """A host batch -> tensors on ``device`` (token ids as int64)."""
    return {k: torch.tensor(v, dtype=torch.long if v.dtype.kind == "i"
                            else None).to(device)
            for k, v in batch.items()}


def train_loop(cfg, *, steps: int, batch: int, seq_len: int,
               ckpt_dir: Optional[str] = None, ckpt_every: int = 50,
               resume: bool = False, log_every: int = 10,
               prefetch_depth: int = 2, seed: int = 0, rules=NO_RULES,
               device=None, ocfg: Optional[OptConfig] = None, mesh=None
               ) -> Dict[str, Any]:
    """Train ``steps`` steps (from the latest checkpoint with ``resume``).

    Returns {'losses', 'step_seconds', 'steps_done', 'tokens_per_s',
    'straggler_events', 'params', 'opt_state'}.  ``ocfg`` defaults to the
    reference's schedule for ``steps``.  A resumed run skips the batches
    the checkpointed steps consumed, so it sees the batches an
    uninterrupted run would (the reference's restarts its pipeline).

    ``mesh`` (a ``DeviceMesh``): the sharded step over it with the
    ``train`` profile's rules (``rules`` is then ignored); every rank runs
    the same input pipeline and the step places each microbatch.
    Checkpoints of a sharded run are not supported."""
    device = resolve_device(device)
    if ocfg is None:
        ocfg = OptConfig(total_steps=max(steps, 2),
                         warmup_steps=max(steps // 10, 1))
    if mesh is not None:
        if ckpt_dir:
            raise NotImplementedError("train_loop: checkpoints of a sharded "
                                      "run are not supported")
        cfg, rules, p_specs, b_specs = sharded_setup(cfg, mesh, batch,
                                                     seq_len)
        step_fn = sharded_train_step(cfg, ocfg, rules, p_specs, b_specs,
                                     mesh)
        params, opt_state = build_state(cfg, seed, device, mesh, p_specs)
    else:
        step_fn = make_train_step(cfg, ocfg, rules)
        params, opt_state = build_state(cfg, seed, device)
    start_step = 0
    manager = None
    if ckpt_dir:
        manager = CheckpointManager(ckpt_dir, every_steps=ckpt_every, keep=3)
        if resume and latest_step(ckpt_dir) is not None:
            state, meta = restore_checkpoint(
                ckpt_dir, {"params": params, "opt": opt_state})
            params, opt_state = state["params"], state["opt"]
            start_step = int(meta["step"])
            print(f"resumed from step {start_step}")

    with trace.run_scope(flow="train", arch=cfg.name) as tracer:
        pc = PipelineConfig(seq_len=seq_len, global_batch=batch,
                            vocab_size=cfg.vocab_size,
                            docs_per_window=max(batch * 16, 512),
                            prefetch_depth=prefetch_depth, seed=seed)
        to_model = make_lm_batch_fn(cfg)
        blocks = iter(InputPipeline(pc))
        for _ in range(start_step):
            next(blocks)
        feed = PrefetchQueue(blocks, depth=pc.prefetch_depth,
                             stage_fn=lambda blk: to_device(to_model(blk),
                                                            device))
        watchdog = StragglerWatchdog(window=16, threshold=3.0)
        losses, step_seconds = [], []
        t_start = time.perf_counter()
        try:
            with trace.measured(tracer):
                for step in range(start_step, steps):
                    t0 = time.perf_counter()
                    mb = next(feed)
                    params, opt_state, metrics = step_fn(params, opt_state,
                                                         mb)
                    loss = float(metrics["loss"])
                    losses.append(loss)
                    dt_step = time.perf_counter() - t0
                    step_seconds.append(dt_step)
                    watchdog.observe(step, dt_step)
                    if manager is not None:
                        manager.maybe_save(
                            step + 1, {"params": params, "opt": opt_state},
                            extra_meta={"arch": cfg.name})
                    if (step % log_every == 0 or step == steps - 1) \
                            and _is_main():
                        print(f"step {step:5d}  loss {loss:.4f}  "
                              f"lr {float(metrics['lr']):.2e}  "
                              f"gnorm {float(metrics['grad_norm']):.3f}  "
                              f"{dt_step*1e3:.0f} ms", flush=True)
        finally:
            feed.close()
        if manager is not None:
            manager.maybe_save(steps, {"params": params, "opt": opt_state},
                               extra_meta={"arch": cfg.name}, force=True)
            manager.wait()
        wall = time.perf_counter() - t_start
        done = steps - start_step
        if tracer is not None:
            trace.export_run(tracer, {
                "steps": done,
                "counters": tracer.metrics.snapshot()["counters"]})
    return {"losses": losses, "step_seconds": step_seconds,
            "steps_done": done,
            "tokens_per_s": done * batch * seq_len / max(wall, 1e-9),
            "straggler_events": len(watchdog.events),
            "params": params, "opt_state": opt_state}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", required=True, choices=ARCH_IDS)
    ap.add_argument("--smoke", action="store_true",
                    help="reduced same-family config (CPU-runnable)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card; 'cpu' runs the "
                         "kernels' plain versions)")
    ap.add_argument("--mesh", default=None,
                    help="shard over a mesh of the torchrun ranks: "
                         "data=D,model=M (and pod=P)")
    ap.add_argument("--dist-backend", default=None, choices=("nccl", "gloo"),
                    help="process group backend with --mesh (default: nccl "
                         "on the card, gloo on the CPU)")
    args = ap.parse_args()

    cfg = get_config(args.arch, smoke=args.smoke)
    if args.batch % max(cfg.grad_accum, 1):
        cfg = cfg.replace(grad_accum=1)
    mesh = None
    if args.mesh:
        import torch.distributed as dist
        from .mesh import init_distributed, make_mesh, parse_mesh
        sizes = parse_mesh(args.mesh)
        device = str(resolve_device(args.device))
        init_distributed(args.dist_backend, device)
        mesh = make_mesh(tuple(sizes.values()), tuple(sizes), device)
    try:
        res = train_loop(cfg, steps=args.steps, batch=args.batch,
                         seq_len=args.seq_len, ckpt_dir=args.ckpt_dir,
                         resume=args.resume, seed=args.seed,
                         device=args.device, mesh=mesh)
        if _is_main():
            print(f"done: {res['steps_done']} steps, "
                  f"{res['tokens_per_s']:.0f} tok/s, "
                  f"loss {res['losses'][0]:.4f} -> "
                  f"{res['losses'][-1]:.4f}")
    finally:
        if mesh is not None:
            dist.destroy_process_group()


if __name__ == "__main__":
    main()
