"""End-to-end training on the PyTorch/CUDA port: train a ~100M-parameter LM
for a few hundred steps, with every layer of the trainer engaged —

  ETL input pipeline (core engine: shared caches + Algorithm-2 prefetch)
  -> train_step (microbatch accumulation, per-period remat, the flash
     kernels forward and backward on the card, in-place AdamW)
  -> async CheckpointManager + StragglerWatchdog
  -> mid-run checkpoint-restart (simulated failure) proving resume.

  PYTHONPATH=src python examples/torch_train_lm.py [--steps 200] [--dim 512]
  PYTHONPATH=src python examples/torch_train_lm.py --device cpu --steps 20 \\
      --dim 64 --layers 2 --batch 4 --seq-len 32

Runs on the card unless ``--device`` names another; without a card the
default raises.  Both halves of the run follow the schedule of the whole
``--steps`` (a linear warmup over a tenth of them, then a cosine down to
a tenth of the rate), so the restart continues the run it interrupts.
"""
import argparse
import shutil
import sys
import tempfile

from repro_torch.configs import get_config
from repro_torch.launch.train import train_loop
from repro_torch.models.transformer import param_count
from repro_torch.train.optimizer import OptConfig


def model_config(dim: int = 512, layers: int = 8):
    """~100M params at the defaults: 8L x d512 (8 heads of 64) + a 32k
    vocabulary (tok_embed + head = 2 x 16.4M)."""
    return get_config("stablelm-3b", smoke=True).replace(
        name="lm-100m", n_layers=layers, d_model=dim, n_heads=8,
        n_kv_heads=8, d_ff=4 * dim, vocab_size=32_000, grad_accum=2)


def train(cfg, steps: int = 200, batch: int = 8, seq_len: int = 256,
          device=None, min_drop=0.5, log_every: int = 20,
          log=print) -> dict:
    """``steps // 2`` steps with a checkpoint every quarter of them, a
    simulated failure, then a restart from the last checkpoint to
    ``steps``, on ``device`` (the card when None).  With ``min_drop``, the
    last loss must lie more than that below the first.

    Returns ``{"losses" (both halves, one a step), "first", "last",
    "resumed_from", "step_seconds" (both halves), "tokens_per_s" (the
    second half's), "straggler_events"}``."""
    ocfg = OptConfig(total_steps=max(steps, 2),
                     warmup_steps=max(steps // 10, 1))
    ckpt_dir = tempfile.mkdtemp(prefix="train_lm_ckpt_")
    try:
        half = steps // 2
        log(f"— phase 1: steps 0..{half} (then simulated failure) —")
        r1 = train_loop(cfg, steps=half, batch=batch, seq_len=seq_len,
                        ckpt_dir=ckpt_dir, ckpt_every=max(half // 4, 1),
                        log_every=log_every, device=device, ocfg=ocfg)
        log(f"— phase 2: restart from checkpoint, continue to {steps} —")
        r2 = train_loop(cfg, steps=steps, batch=batch, seq_len=seq_len,
                        ckpt_dir=ckpt_dir, resume=True, log_every=log_every,
                        device=device, ocfg=ocfg)
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    losses = r1["losses"] + r2["losses"]
    first, last = losses[0], losses[-1]
    log(f"loss {first:.3f} -> {last:.3f} over {steps} steps "
        f"({r2['tokens_per_s']:.0f} tok/s phase-2)")
    if min_drop is not None:
        assert last < first - min_drop, "loss should drop substantially"
        log("OK")
    return {"losses": losses, "first": first, "last": last,
            "resumed_from": steps - r2["steps_done"],
            "step_seconds": r1["step_seconds"] + r2["step_seconds"],
            "tokens_per_s": r2["tokens_per_s"],
            "straggler_events": r1["straggler_events"]
            + r2["straggler_events"]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--dim", type=int, default=512)
    ap.add_argument("--layers", type=int, default=8)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=256)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    cfg = model_config(args.dim, args.layers)
    print(f"model: {param_count(cfg) / 1e6:.1f}M params")
    train(cfg, steps=args.steps, batch=args.batch, seq_len=args.seq_len,
          device=args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
