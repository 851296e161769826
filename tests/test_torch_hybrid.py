"""The port's hybrid family (jamba's smoke config: a period of 8 layers,
attention at offset 4, Mamba elsewhere, a MoE FFN every 2nd layer) against
the JAX reference on the CPU: the prefill's logits and its cache, which
mixes ``k``/``v`` and ``conv``/``h`` in one period, decode after
``grow_cache``, and greedy generation.  Prompts are multiples of the smoke
config's ``ssm_chunk`` (16), where the reference's chunked scan is right.
The card refusal is ``test_torch_models.py::test_unsupported_families_raise``.
Tolerances as in ``_torch_lm.py``.
"""
import numpy as np
import pytest
import torch

from _torch_lm import (as_np, cfgs, check_cache_shapes, check_decode,
                       check_generate, check_prefill, teacher_forcing, tokens)
from repro_torch.models import transformer as tf

ARCH = "jamba-1.5-large-398b"


def test_period_mixes_attention_mamba_and_moe():
    _, cfg = cfgs(ARCH)
    assert tf.period(cfg) == 8
    assert [cfg.layer_kind(i) for i in range(8)] == ["mamba"] * 4 + [
        "attn"] + ["mamba"] * 3
    assert [cfg.ffn_kind(i) for i in range(8)] == ["dense", "moe"] * 4


def test_cache_shapes_match_reference_and_the_grown_cache():
    check_cache_shapes(ARCH, {})


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_logits_and_cache_match_reference(dtype):
    check_prefill(ARCH, dtype)


def test_decode_matches_reference_after_grow_cache():
    ref_cfg, cfg = cfgs(ARCH, compute_dtype="float32")
    check_decode(ref_cfg, cfg, prompt=16, steps=4)


def test_decode_matches_teacher_forcing():
    """prefill(prefix) + 4 decode steps == prefill(longer), in bf16 within
    0.05, at batch 1 with the decoded tokens in a MoE group of their own:
    the prefix is two full groups of 32, which the longer prefill groups
    the same way (the same drops), and decode never drops a slot."""
    _, cfg = cfgs(ARCH)
    p = tf.init_params(cfg, seed=1, device="cpu")
    toks = torch.from_numpy(tokens(cfg, 1, 2 * cfg.moe_group_size + 4,
                                   seed=2)).long()
    got, want = teacher_forcing(cfg, p, toks)
    np.testing.assert_allclose(as_np(got), as_np(want), rtol=0.05,
                               atol=0.05)


def test_greedy_generate_token_identical_to_reference():
    check_generate(ARCH)
