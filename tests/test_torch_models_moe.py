"""The port's serving path on the MoE family (mixtral-8x7b and grok-1 smoke
configs) and the sliding-window cache, against the JAX reference; the
checks and their tolerances are in ``_torch_lm.py`` (fp32 within rtol 1e-4
/ atol 1e-4, bf16 within 5e-2, greedy tokens identical at fp32).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_lm import (as_np, cfgs, check_cache_shapes, check_decode,
                       check_generate, check_prefill, check_server, params,
                       teacher_forcing, tokens)
from repro.models import transformer as ref_tf
from repro_torch.models import transformer as tf

ARCHS = ["mixtral-8x7b", "grok-1-314b"]


@pytest.mark.parametrize("arch,kw", [
    pytest.param("mixtral-8x7b", {}, id="mixtral-8x7b-kw2"),
    pytest.param("stablelm-3b", dict(sliding_window=6), id="stablelm-3b-kw3")])
def test_cache_shapes_match_reference_and_the_grown_cache(arch, kw):
    check_cache_shapes(arch, kw)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_logits_and_cache_match_reference(arch, dtype):
    check_prefill(arch, dtype)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_reference_after_grow_cache(arch):
    ref_cfg, cfg = cfgs(arch, compute_dtype="float32")
    check_decode(ref_cfg, cfg, prompt=8, steps=4)


@pytest.mark.parametrize("arch,kw,prompt", [
    # the ring buffer wraps during decode; the prompts stay within the
    # window, where the reference's prefill cache is right (see below)
    pytest.param("stablelm-3b", dict(sliding_window=6), 4,
                 id="stablelm-3b-kw0"),
    pytest.param("qwen2.5-32b", dict(sliding_window=5, logit_softcap=20.0),
                 5, id="qwen2.5-32b-kw3"),
])
def test_decode_options_match_reference(arch, kw, prompt):
    ref_cfg, cfg = cfgs(arch, compute_dtype="float32", **kw)
    check_decode(ref_cfg, cfg, prompt=prompt, steps=7)


# Past a sliding window W the decode cache is a ring: position p at slot
# p mod W.  A prefill of S > W tokens keeps the last W keys; the reference
# leaves position S-W+j at slot j (repro/models/transformer.py:266-268),
# which is the ring's order only when W divides S, so its decode after such
# a prompt attends to misplaced keys.  The port rolls them into ring order.
LONG_PROMPTS = [("stablelm-3b", dict(sliding_window=6), 9),
                ("qwen2.5-32b", dict(sliding_window=5, logit_softcap=20.0),
                 13),
                ("mixtral-8x7b", {}, 36)]                  # window 32


def _window_decode_gap(prefill, decode, grow, p, toks, prompt):
    """Largest gap between decode after ``prompt`` tokens and a prefill one
    token longer, over decode steps to the end of ``toks``.  One prompt: a
    MoE group then holds the same tokens in both runs, so capacity drops
    are the same too."""
    _, cache = prefill(p, toks[:, :prompt])
    cache = grow(cache, toks.shape[1])
    gap = 0.0
    for t in range(prompt, toks.shape[1]):
        lg, cache = decode(p, cache, toks[:, t:t + 1])
        want, _ = prefill(p, toks[:, :t + 1])
        gap = max(gap, float(np.abs(as_np(lg) - as_np(want)).max()))
    return gap


@pytest.mark.parametrize("arch,kw,prompt", LONG_PROMPTS)
def test_window_decode_after_a_long_prompt_matches_a_longer_prefill(
        arch, kw, prompt):
    ref_cfg, cfg = cfgs(arch, compute_dtype="float32", **kw)
    assert prompt > cfg.sliding_window and prompt % cfg.sliding_window
    _, p = params(ref_cfg)
    toks = torch.from_numpy(tokens(cfg, 1, prompt + 4, seed=11)).long()
    gap = _window_decode_gap(
        lambda p_, t: tf.forward_prefill(p_, {"tokens": t}, cfg),
        lambda p_, c, t: tf.decode_step(p_, c, {"tokens": t}, cfg),
        lambda c, n: tf.grow_cache(c, cfg, n), p, toks, prompt)
    assert gap <= 1e-4


def test_reference_window_cache_defect_after_a_long_prompt():
    """Documents the reference defect the port routes around: its first
    decode step after the same long prompt is off by more than 1e-3."""
    arch, kw, prompt = LONG_PROMPTS[0]
    ref_cfg, cfg = cfgs(arch, compute_dtype="float32", **kw)
    ref_p, _ = params(ref_cfg)
    toks = jnp.asarray(tokens(cfg, 1, prompt + 1, seed=11))
    gap = _window_decode_gap(
        lambda p_, t: ref_tf.forward_prefill(p_, {"tokens": t}, ref_cfg),
        lambda p_, c, t: ref_tf.decode_step(p_, c, {"tokens": t}, ref_cfg),
        lambda c, n: ref_tf.grow_cache(c, ref_cfg, n), ref_p, toks, prompt)
    assert gap > 1e-3


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_teacher_forcing(arch):
    """prefill(prefix) + decode steps == prefill(longer), in bf16 (the
    reference's own check, tests/test_models.py).

    Teacher forcing is an identity only when no token is dropped: a group
    of the longer prefill holds other tokens, so a token it drops may be
    one decode keeps.  At a capacity factor of E / k the capacity is at
    least the group size, and nothing can be dropped."""
    _, cfg = cfgs(arch)
    cfg = cfg.replace(capacity_factor=cfg.n_experts / cfg.experts_per_token)
    p = tf.init_params(cfg, seed=1, device="cpu")
    toks = torch.from_numpy(tokens(cfg, 2, 12, seed=2)).long()
    got, want = teacher_forcing(cfg, p, toks)
    np.testing.assert_allclose(as_np(got), as_np(want), rtol=0.05,
                               atol=0.05)


@pytest.mark.parametrize("arch", ARCHS)
def test_greedy_generate_token_identical_to_reference(arch):
    check_generate(arch)


@pytest.mark.parametrize("arch", ["mixtral-8x7b"])
def test_batched_server_token_identical_to_reference(arch):
    check_server(arch)
