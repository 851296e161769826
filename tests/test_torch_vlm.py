"""The port's vlm family (llama-3.2-vision-11b's smoke config: 5 layers,
cross-attention at layer 3 over 17 stub vision tokens) against the JAX
reference, with every cross-attention gate nonzero (``_torch_lm.params``):
the prefill through flash's non-causal cross-attention, decode over the
cached vision K/V, generation with vision, and the text-only server.
Tolerances as in ``_torch_lm.py``.
"""
import numpy as np
import pytest
import torch

from _torch_lm import (FP32, as_np, batches, cfgs, check_cache_shapes,
                       check_decode, check_generate, check_prefill,
                       check_server, close_tree, params, teacher_forcing,
                       tokens, vision)
from repro.models import transformer as ref_tf
from repro_torch.models import transformer as tf

ARCH = "llama-3.2-vision-11b"


def test_cache_shapes_match_reference_and_the_grown_cache():
    check_cache_shapes(ARCH, {})


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_logits_and_cache_match_reference(dtype):
    """Logits and every cache leaf, the vision K/V (``xk``/``xv``) too."""
    check_prefill(ARCH, dtype)


def test_text_only_prefill_skips_the_cross_attention():
    """Without vision both packages skip the branch and cache no ``xk``;
    with it the logits move (the nonzero gates let the branch show)."""
    ref_cfg, cfg = cfgs(ARCH, compute_dtype="float32")
    ref_p, p = params(ref_cfg)
    ref_b, b = batches(cfg, 2, 16)
    with_vision, _ = tf.forward_prefill(p, b, cfg)
    del ref_b["vision"], b["vision"]
    want_lg, want_cache = ref_tf.forward_prefill(ref_p, ref_b, ref_cfg)
    lg, cache = tf.forward_prefill(p, b, cfg)
    np.testing.assert_allclose(as_np(lg), as_np(want_lg), **FP32)
    close_tree(cache, want_cache, FP32)
    assert all("xk" not in sub for k, sub in cache.items() if k != "pos_idx")
    assert float((with_vision - lg).abs().max()) > 1e-3


def test_grow_cache_pads_only_the_self_attention_cache():
    """Past the 17 vision tokens: ``k``/``v`` grow, ``xk``/``xv`` stay the
    prefill's tensors."""
    _, cfg = cfgs(ARCH, compute_dtype="float32")
    p = tf.init_params(cfg, device="cpu")
    _, cache = tf.forward_prefill(p, batches(cfg, 2, 8)[1], cfg)
    grown = tf.grow_cache(cache, cfg, 40)
    sub, big = cache["pos3"], grown["pos3"]
    assert big["k"].shape[2] == 40 and big["v"].shape[2] == 40
    assert big["xk"] is sub["xk"] and big["xv"] is sub["xv"]
    assert sub["xk"].shape[2] == cfg.n_vision_tokens


def test_decode_matches_reference_after_grow_cache():
    """Decode's cross-attention reads the cached vision K/V."""
    ref_cfg, cfg = cfgs(ARCH, compute_dtype="float32")
    check_decode(ref_cfg, cfg, prompt=8, steps=4)


def test_decode_matches_teacher_forcing():
    """prefill(prefix) + decode steps over the cached vision K/V ==
    prefill(longer) through the cross-attention's flash route, in bf16
    within 0.05 (the reference's own check, tests/test_models.py)."""
    _, cfg = cfgs(ARCH)
    p = tf.init_params(cfg, seed=1, device="cpu")
    for sub in p["blocks"].values():
        if "xattn" in sub:
            sub["xattn"]["gate"].fill_(0.75)
    toks = torch.from_numpy(tokens(cfg, 2, 12, seed=2)).long()
    got, want = teacher_forcing(cfg, p, toks,
                                extra={"vision": torch.from_numpy(
                                    vision(cfg, 2))})
    np.testing.assert_allclose(as_np(got), as_np(want), rtol=0.05,
                               atol=0.05)


def test_greedy_generate_with_vision_token_identical_to_reference():
    check_generate(ARCH, with_vision=True)


def test_batched_server_text_only_token_identical_to_reference():
    """The server takes tokens only, as the reference's: text-only."""
    check_server(ARCH)
