"""Serving launcher: batched request serving on one card.

Requests are grouped into waves of ``batch`` same-length prompts; each wave
is prefilled once (flash-attention or selective-scan kernel), its cache
grown, and decoded greedily, with every decode step writing the cache in
place.

Usage (on a machine with a CUDA card; ``--device cpu`` runs the kernels'
plain torch versions on the CPU):
  PYTHONPATH=src python -m repro_torch.launch.serve --arch stablelm-3b
  PYTHONPATH=src python -m repro_torch.launch.serve --arch stablelm-3b \\
      --smoke --device cpu --requests 4 --prompt-len 32 --max-new 8
  PYTHONPATH=src torchrun --nproc-per-node 4 -m repro_torch.launch.serve \\
      --arch stablelm-3b --smoke --device cpu --mesh data=2,model=2

``--mesh`` serves through ``sharded_serve_steps`` with the decode
profile's rules (``nccl`` on the card, ``gloo`` on the CPU unless
``--dist-backend`` names one; under ``nccl`` a world larger than the
visible cards raises).
"""
from __future__ import annotations

import argparse
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np
import torch

from ..configs import ARCH_IDS, get_config
from ..models.layers import NO_RULES, resolve_device
from ..models.transformer import check_supported, grow_cache, init_params
from ..train.serve_step import make_serve_steps, sample_token
from ..train.sharding import full


@dataclass
class Request:
    rid: int
    prompt: np.ndarray                  # [prompt_len] int32
    max_new: int
    out_tokens: List[int] = field(default_factory=list)
    t_submit: float = 0.0
    t_done: float = 0.0


class BatchedServer:
    """Static-batch server: groups up to ``batch`` same-length requests,
    prefills once, decodes to the longest max_new.  Requests carry tokens
    only, as the reference's do: a vlm is served text-only, its
    cross-attention layers skipped.

    ``stats`` counts prefills and decode steps, and the host seconds spent
    up to each wave's first tokens (``prefill_s``) and after them
    (``decode_s``); both end when the sampled tokens reach the host."""

    def __init__(self, cfg, params=None, batch: int = 8, rules=NO_RULES,
                 temperature: float = 0.0, seed: int = 0,
                 device: Optional[str] = None, mesh=None):
        self.cfg = cfg
        self.rules = rules
        self.batch = batch
        self.temperature = temperature
        self.device = resolve_device(device)
        check_supported(cfg, self.device)
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(seed)
        place = None
        if mesh is not None:
            # the decode profile's rules and layout over the mesh; every
            # rank serves the same requests
            from ..train.serve_step import sharded_serve_steps
            from ..train.sharding import distribute, make_rules
            from .specs import limit_specs_tree
            from ..models.transformer import param_shapes, param_specs
            if not rules.mapping:
                self.rules = make_rules(mesh, "decode", cfg)
            specs = limit_specs_tree(param_specs(cfg, self.rules),
                                     param_shapes(cfg), mesh)

            def place(path, x):
                spec = specs
                for part in path.split("."):
                    spec = spec[part]
                return distribute(x, mesh, spec)
            # the cache's specs do not depend on its length
            self._prefill, self._decode = sharded_serve_steps(
                cfg, self.rules, specs, mesh, batch, 0)
        else:
            self._prefill, self._decode = make_serve_steps(cfg, rules)
        if params is None:
            params = init_params(cfg, seed=0, device=self.device,
                                 place=place)
        elif params["final_ln"].device != self.device:
            raise ValueError(f"params are on {params['final_ln'].device}, "
                             f"the server on {self.device}")
        self.params = params
        self.stats: Dict[str, float] = {"prefills": 0, "decode_steps": 0,
                                        "prefill_s": 0.0, "decode_s": 0.0}

    @torch.no_grad()
    def serve_batch(self, requests: List[Request]) -> List[Request]:
        if len(requests) > self.batch:
            raise ValueError(f"{len(requests)} requests in a wave of "
                             f"{self.batch}")
        t0 = time.perf_counter()
        prompts = np.stack([r.prompt for r in requests])
        max_new = max(r.max_new for r in requests)
        tokens = torch.tensor(prompts, dtype=torch.long, device=self.device)
        logits, cache = self._prefill(self.params, {"tokens": tokens})
        cache = grow_cache(cache, self.cfg, prompts.shape[1] + max_new)
        self.stats["prefills"] += 1
        tok = sample_token(full(logits), self.temperature, self.generator)
        for r, t in zip(requests, tok[:, 0].tolist()):
            r.out_tokens.append(t)
        t1 = time.perf_counter()
        self.stats["prefill_s"] += t1 - t0
        for _ in range(max_new - 1):
            logits, cache = self._decode(self.params, cache,
                                         {"tokens": tok})
            self.stats["decode_steps"] += 1
            tok = sample_token(full(logits), self.temperature,
                               self.generator)
            for r, t in zip(requests, tok[:, 0].tolist()):
                if len(r.out_tokens) < r.max_new:
                    r.out_tokens.append(t)
        now = time.perf_counter()
        self.stats["decode_s"] += now - t1
        for r in requests:
            r.t_done = time.time()
        return requests

    def run(self, requests: List[Request]) -> List[Request]:
        """Admission control: bounded wave scheduling over the request list
        (groups of ``batch``)."""
        done: List[Request] = []
        for i in range(0, len(requests), self.batch):
            done.extend(self.serve_batch(requests[i: i + self.batch]))
        return done


def make_requests(cfg, n: int, prompt_len: int, max_new: int,
                  seed: int = 0) -> List[Request]:
    """``n`` requests with prompts drawn by numpy from ``seed``."""
    rng = np.random.default_rng(seed)
    return [Request(rid=i,
                    prompt=rng.integers(2, cfg.vocab_size,
                                        prompt_len).astype(np.int32),
                    max_new=max_new, t_submit=time.time())
            for i in range(n)]


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", required=True, choices=ARCH_IDS)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--mesh", default=None,
                    help="shard over a mesh of the torchrun ranks: "
                         "data=D,model=M (and pod=P)")
    ap.add_argument("--dist-backend", default=None, choices=("nccl", "gloo"),
                    help="process group backend with --mesh (default: nccl "
                         "on the card, gloo on the CPU)")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch, smoke=args.smoke)
    if cfg.is_encoder:
        raise SystemExit(f"{args.arch} is encoder-only: no decode step")
    mesh = None
    if args.mesh:
        import torch.distributed as dist
        from .mesh import init_distributed, make_mesh, parse_mesh
        sizes = parse_mesh(args.mesh)
        device = str(resolve_device(args.device))
        init_distributed(args.dist_backend, device)
        mesh = make_mesh(tuple(sizes.values()), tuple(sizes), device)
    try:
        server = BatchedServer(cfg, batch=args.batch,
                               temperature=args.temperature,
                               device=args.device, mesh=mesh)
        reqs = make_requests(cfg, args.requests, args.prompt_len,
                             args.max_new)
        t0 = time.perf_counter()
        done = server.run(reqs)
        wall = time.perf_counter() - t0
        n_tok = sum(len(r.out_tokens) for r in done)
        if mesh is None or dist.get_rank() == 0:
            print(f"served {len(done)} requests, {n_tok} tokens in "
                  f"{wall:.2f}s ({n_tok / wall:.1f} tok/s) on "
                  f"{server.device}; prefills={server.stats['prefills']:.0f}"
                  f" decode_steps={server.stats['decode_steps']:.0f}")
    finally:
        if mesh is not None:
            dist.destroy_process_group()


if __name__ == "__main__":
    main()
