"""Serving: prefill + decode steps on a cache that decode updates in place.

Decode writes each token's k/v (or SSM state) into the grown cache's
memory: the reference's donated cache buffer, the paper's shared caching
scheme applied to serving, with no copy per token.  ``sharded_serve_steps``
runs both over a ``DeviceMesh`` (the reference's ``jit_serve_steps``).
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from ..models.layers import NO_RULES, Rules
from ..models.transformer import decode_step, forward_prefill, grow_cache


def make_serve_steps(cfg, rules: Rules = NO_RULES):
    """Returns (prefill_fn, decode_fn)."""

    def prefill(params, batch):
        return forward_prefill(params, batch, cfg, rules)

    def decode(params, cache, batch):
        return decode_step(params, cache, batch, cfg, rules)

    return prefill, decode


def sharded_serve_steps(cfg, rules: Rules, param_spec_tree, mesh,
                        batch: int, seq_len: int):
    """The counterpart of the reference's ``jit_serve_steps``: (prefill,
    decode) over ``mesh``, every rank calling them with the same
    arguments.

    Both place the params by ``param_spec_tree`` (a plain tensor is the
    whole value on each rank, which keeps its slice; a DTensor so placed is
    used as it is) and the tokens by the batch spec.  Prefill returns
    (logits, cache) as DTensors, the cache's layers placed as ``rules``
    make them; ``grow_cache`` keeps their placements.  Decode places the
    cache by ``make_cache_shapes(cfg, batch, seq_len, rules,
    as_spec=True)``, each spec limited to the dims it divides (the
    ``decode`` profile: kv heads over 'model', or the sequence when the
    heads do not divide it): a cache already so placed is written in place
    (the reference donates it), one placed otherwise is redistributed
    once, on its first step."""
    from ..models.transformer import make_cache_shapes
    from .sharding import distribute, distribute_tree
    prefill_fn, decode_fn = make_serve_steps(cfg, rules)
    cache_spec = make_cache_shapes(cfg, batch, seq_len, rules, as_spec=True)

    def place_batch(b):
        return {k: distribute(v, mesh, rules.spec("batch", None)
                              if k in ("tokens", "labels")
                              else rules.spec("batch", None, None))
                for k, v in b.items()}

    def prefill(params, b):
        params = distribute_tree(params, param_spec_tree, mesh)
        return prefill_fn(params, place_batch(b))

    def decode(params, cache, b):
        params = distribute_tree(params, param_spec_tree, mesh)
        cache = {k: (v if k == "pos_idx"
                     else distribute_tree(v, cache_spec[k], mesh))
                 for k, v in cache.items()}
        return decode_fn(params, cache, place_batch(b))

    return prefill, decode


def sample_token(logits: torch.Tensor, temperature: float = 0.0,
                 generator: Optional[torch.Generator] = None
                 ) -> torch.Tensor:
    """logits [B, 1, V] -> tokens [B, 1]: greedy at temperature 0, else a
    draw from softmax(logits / temperature) with ``generator``."""
    last = logits[:, -1].float()
    if temperature <= 0.0:
        return torch.argmax(last, dim=-1)[:, None]
    probs = torch.softmax(last / temperature, dim=-1)
    return torch.multinomial(probs, 1, generator=generator)


@torch.no_grad()
def generate(params, cfg, prompts: torch.Tensor, max_new_tokens: int,
             rules: Rules = NO_RULES, temperature: float = 0.0,
             generator: Optional[torch.Generator] = None,
             vision: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Batched greedy/temperature generation (the plain serving loop).
    prompts: [B, S] int on the parameters' device -> [B, max_new_tokens].
    ``vision`` [B, n_vision_tokens, d]: a vlm's patch embeddings, which the
    prefill's cross-attention reads and caches for decode."""
    batch: Dict[str, Any] = {"tokens": prompts}
    if vision is not None:
        batch["vision"] = vision
    logits, cache = forward_prefill(params, batch, cfg, rules)
    cache = grow_cache(cache, cfg, prompts.shape[1] + max_new_tokens)
    tok = sample_token(logits, temperature, generator)
    out = [tok]
    for _ in range(max_new_tokens - 1):
        logits, cache = decode_step(params, cache, {"tokens": tok}, cfg,
                                    rules)
        tok = sample_token(logits, temperature, generator)
        out.append(tok)
    return torch.cat(out, dim=1)
