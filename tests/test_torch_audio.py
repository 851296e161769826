"""The port's audio family (hubert-xlarge's smoke config: an encoder over
stub frame embeddings, non-causal attention, a gelu MLP) against the JAX
reference: the prefill's logits and cache and the hidden state at every
position.  Tolerances as in ``_torch_lm.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_lm import (BF16, FP32, as_np, batches, cfgs, check_cache_shapes,
                       check_prefill, params)
from repro.models import transformer as ref_tf
from repro_torch.launch.serve import main as serve_main
from repro_torch.models import transformer as tf

ARCH = "hubert-xlarge"


def test_cache_shapes_match_reference_and_the_grown_cache():
    check_cache_shapes(ARCH, {})


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_logits_and_cache_match_reference(dtype):
    check_prefill(ARCH, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_hidden_state_at_every_position_matches_reference(dtype):
    """The backbone's output at all positions, on both port routes: an
    encoder's earlier positions see later frames, so a causal mask left on
    shows there and not in the last position's logits."""
    ref_cfg, cfg = cfgs(ARCH, compute_dtype=dtype)
    ref_p, p = params(ref_cfg)
    ref_b, b = batches(cfg, 2, 32)
    x = ref_tf._embed(ref_p, ref_b, ref_cfg, ref_tf.NO_RULES)
    pos = jnp.arange(32)
    want, _, _ = ref_tf.backbone(ref_p, x, ref_cfg, ref_tf.NO_RULES,
                                 "prefill", pos, pos)
    tol = FP32 if dtype == "float32" else BF16
    for impl in ("auto", "reference"):
        run_cfg = cfg.replace(attn_impl=impl)
        xt = tf._embed(p, b, run_cfg, tf.NO_RULES)
        post = torch.arange(32)
        got, _, _ = tf.backbone(p, xt, run_cfg, tf.NO_RULES, "prefill",
                                post, post)
        assert got.shape == (2, 32, cfg.d_model)
        assert got.dtype == getattr(torch, dtype)
        np.testing.assert_allclose(as_np(got), as_np(want), **tol)


def test_server_refuses_an_encoder():
    """No decode step for an encoder, as in the reference's launcher."""
    with pytest.raises(SystemExit, match="encoder-only"):
        serve_main(["--arch", ARCH, "--smoke", "--device", "cpu"])
