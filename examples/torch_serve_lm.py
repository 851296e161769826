"""Batched serving on the PyTorch/CUDA port: prefill + decode with the KV
cache written in place (the shared caching scheme applied to inference),
8 requests of 24-token prompts, 16 new tokens each, waves of 4, greedy.

  PYTHONPATH=src python examples/torch_serve_lm.py            # smoke mixtral
  PYTHONPATH=src python examples/torch_serve_lm.py --layers 2 # mixtral-8x7b,
                                                              # full width
  PYTHONPATH=src python examples/torch_serve_lm.py --device cpu

Runs on the card unless ``--device`` names another; without a card the
default raises.  ``--layers N`` serves mixtral-8x7b at its full published
width cut to its first N of 32 layers (random weights from seed 0; the
fp32 experts take about 5.6 GB a layer).
"""
import argparse
import sys
import time

from repro_torch.configs import get_config
from repro_torch.launch.serve import BatchedServer, make_requests

ARCH = "mixtral-8x7b"           # MoE + sliding window
TRAFFIC = dict(n=8, prompt_len=24, max_new=16)
BATCH = 4


def model_config(layers: int = 0):
    """The smoke config, or the full-width config at ``layers`` layers."""
    if layers:
        return get_config(ARCH).replace(n_layers=layers)
    return get_config(ARCH, smoke=True)


def serve(cfg, params=None, device=None, log=print) -> dict:
    """Serve ``TRAFFIC`` (prompts from numpy ``default_rng(0)``) through
    ``BatchedServer`` in waves of ``BATCH``, greedily, on ``device`` (the
    card when None); ``params``: weights on that device (seed-0 random
    weights when None).  Returns ``{"done": requests, "wall", "tokens",
    "tokens_per_s", "stats"}`` (``BatchedServer.stats``)."""
    reqs = make_requests(cfg, TRAFFIC["n"], TRAFFIC["prompt_len"],
                         TRAFFIC["max_new"], seed=0)
    server = BatchedServer(cfg, params=params, batch=BATCH, temperature=0.0,
                           device=device)
    t0 = time.perf_counter()
    done = server.run(reqs)
    wall = time.perf_counter() - t0
    n_tok = sum(len(r.out_tokens) for r in done)
    log(f"served {len(done)} requests / {n_tok} tokens in {wall:.2f}s "
        f"({n_tok / wall:.1f} tok/s; prefill {server.stats['prefill_s']:.3f}s"
        f" in {server.stats['prefills']} waves, decode "
        f"{server.stats['decode_s']:.3f}s in "
        f"{server.stats['decode_steps']} steps)")
    for r in done[:3]:
        log(f"  req {r.rid}: {r.out_tokens[:8]}...")
    assert done[0].out_tokens != [] and len(done) == TRAFFIC["n"]
    assert all(len(r.out_tokens) == r.max_new for r in done)
    log("OK")
    return {"done": done, "wall": wall, "tokens": n_tok,
            "tokens_per_s": n_tok / wall, "stats": dict(server.stats)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    ap.add_argument("--layers", type=int, default=0,
                    help=f"serve {ARCH} at full width with this many of its "
                         f"layers (default: the smoke config)")
    args = ap.parse_args(argv)
    cfg = model_config(args.layers)
    print(f"model: {cfg.name}, {cfg.n_layers} layers, d_model {cfg.d_model}, "
          f"{cfg.n_experts} experts")
    serve(cfg, device=args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
