"""qwen2-72b's serving path against the JAX reference on its smoke config
(``qwen2-smoke``: QKV bias, GQA over 2 kv heads, the config's
``seq_shard`` and bf16 accumulator, which serving does not read), as
``test_torch_models.py`` holds the other dense configs: the cache's
shapes, prefill logits and cache on both port routes (fp32 within rtol
1e-4 / atol 1e-4, bf16 within 5e-2), decode after ``grow_cache`` step by
step against the reference's jitted decode step, decode against teacher
forcing in bf16 (within 5e-2), and greedy tokens through ``generate``
and ``BatchedServer`` identical to the reference's at fp32 (the checks of
``_torch_lm.py``).
"""
import numpy as np
import pytest
import torch

from _torch_lm import (as_np, cfgs, check_cache_shapes, check_decode,
                       check_generate, check_prefill, check_server,
                       teacher_forcing, tokens)
from repro_torch.models import transformer as tf

ARCH = "qwen2-72b"


def test_cache_shapes_match_reference_and_the_grown_cache():
    check_cache_shapes(ARCH, {})


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_logits_and_cache_match_reference(dtype):
    check_prefill(ARCH, dtype)


def test_decode_matches_reference_after_grow_cache():
    ref_cfg, cfg = cfgs(ARCH, compute_dtype="float32")
    check_decode(ref_cfg, cfg, prompt=8, steps=4)


def test_decode_matches_teacher_forcing():
    """prefill(prefix) + decode steps == prefill(longer), in bf16 (the
    reference's own check, tests/test_models.py)."""
    _, cfg = cfgs(ARCH)
    p = tf.init_params(cfg, seed=1, device="cpu")
    toks = torch.from_numpy(tokens(cfg, 2, 12, seed=2)).long()
    got, want = teacher_forcing(cfg, p, toks)
    np.testing.assert_allclose(as_np(got), as_np(want), rtol=0.05,
                               atol=0.05)


def test_greedy_generate_token_identical_to_reference():
    check_generate(ARCH)


def test_batched_server_token_identical_to_reference():
    check_server(ARCH)
