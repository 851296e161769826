"""The port's LM serving path (``repro_torch.models``, ``.train.serve_step``,
``.launch.serve``) against the JAX reference, on the smoke configs of the
dense and SSM families, with the reference's weights carried across by
``params_from_numpy``; the parameter trees of all ten archs; the card
refusal of the hybrid family; serving and conversion on the CPU.

The MoE family and the sliding-window cache are in
``test_torch_models_moe.py``, vlm, audio and hybrid in
``test_torch_{vlm,audio,hybrid}.py``; the checks and their tolerances are
in ``_torch_lm.py`` (fp32 within rtol 1e-4 / atol 1e-4, bf16 within 5e-2,
greedy tokens identical at fp32).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_lm import (BF16, FP32, as_np, cfgs, check_cache_shapes,
                       check_decode, check_generate, check_prefill,
                       check_server, params, teacher_forcing, tokens)
from repro import configs as ref_configs
from repro.models import transformer as ref_tf
from repro_torch import configs
from repro_torch.launch import serve
from repro_torch.launch.serve import BatchedServer
from repro_torch.models import transformer as tf
from repro_torch.models.convert import (cache_from_numpy, params_from_numpy,
                                        tensor_from_numpy)

ARCHS = ["stablelm-3b", "qwen2.5-32b", "granite-20b", "falcon-mamba-7b"]


# --------------------------------------------------------------- structure
@pytest.mark.parametrize("arch", configs.ARCH_IDS)
def test_param_tree_shapes_and_count_match_reference(arch):
    ref_cfg = ref_configs.get_config(arch, smoke=True)
    cfg = configs.get_config(arch, smoke=True)
    want = jax.tree_util.tree_flatten_with_path(ref_tf.param_shapes(ref_cfg))
    got = {}

    def walk(t, path):
        if isinstance(t, dict):
            for k, v in t.items():
                walk(v, path + (k,))
        else:
            got[path] = t
    walk(tf.param_shapes(cfg), ())
    want_map = {tuple(p.key for p in path): leaf for path, leaf in want[0]}
    assert set(got) == set(want_map)
    for path, leaf in want_map.items():
        assert tuple(got[path].shape) == leaf.shape, path
        assert str(got[path].dtype).split(".")[-1] == str(leaf.dtype), path
    assert tf.param_count(cfg) == ref_tf.param_count(ref_cfg)
    assert tf.param_count(cfg) == cfg.param_count()


@pytest.mark.parametrize("arch", ["jamba-1.5-large-398b"])
def test_unsupported_families_raise(arch, monkeypatch):
    """The hybrid family runs on the CPU only: on a CUDA device the model and
    the server refuse it, naming the 77 GB reason, before they allocate
    anything there (this container has no card: the refusal comes first)."""
    cfg = configs.get_config(arch, smoke=True)
    with pytest.raises(NotImplementedError, match="77 GB.*ROADMAP"):
        tf.check_supported(cfg, torch.device("cuda", 0))
    with pytest.raises(NotImplementedError, match="77 GB.*ROADMAP"):
        tf.init_params(cfg, device="cuda")
    monkeypatch.setattr(serve, "resolve_device",
                        lambda device=None: torch.device("cuda", 0))
    with pytest.raises(NotImplementedError, match="77 GB.*ROADMAP"):
        BatchedServer(cfg)
    tf.check_supported(cfg, torch.device("cpu"))          # the CPU runs it
    assert tf.init_params(cfg, device="cpu")["head_w"].device.type == "cpu"


def test_init_params_matches_reference_structure_and_constants():
    ref_cfg, cfg = cfgs("falcon-mamba-7b")
    ref = jax.tree.map(np.asarray, ref_tf.init_params(ref_cfg,
                                                      jax.random.PRNGKey(0)))
    got = tf.init_params(cfg, seed=0, device="cpu")
    blk, ref_blk = got["blocks"]["pos0"]["mamba"], ref["blocks"]["pos0"]["mamba"]
    for name in ("A_log", "D", "dt_bias", "conv_b"):
        np.testing.assert_allclose(blk[name].numpy(), ref_blk[name],
                                   rtol=1e-6)
    w = blk["in_proj"]
    assert w.dtype == torch.float32 and abs(float(w.std()) - 0.02) < 2e-3
    again = tf.init_params(cfg, seed=0, device="cpu")
    assert torch.equal(again["head_w"], got["head_w"])


@pytest.mark.parametrize("arch,kw", [
    pytest.param("stablelm-3b", {}, id="stablelm-3b-kw0"),
    pytest.param("falcon-mamba-7b", {}, id="falcon-mamba-7b-kw1"),
    pytest.param("qwen2.5-32b", dict(kv_repeat=2), id="qwen2.5-32b-kw4")])
def test_cache_shapes_match_reference_and_the_grown_cache(arch, kw):
    check_cache_shapes(arch, kw)


# ------------------------------------------------------------------ prefill
@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_logits_and_cache_match_reference(arch, dtype):
    check_prefill(arch, dtype)


# -------------------------------------------------------------- mamba block
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mamba_block_matches_reference(dtype):
    """The port's ``mamba_block`` on its kernel route (on the CPU, the
    scan's plain version) and the reference's on the same numpy weights
    and input."""
    from repro.models.mamba import mamba_block as ref_block
    from repro.models.layers import NO_RULES as REF_RULES
    from repro_torch.models.layers import NO_RULES
    from repro_torch.models.mamba import mamba_block
    ref_cfg, cfg = cfgs("falcon-mamba-7b", compute_dtype=dtype)
    ref_p, p = params(ref_cfg)
    ref_blk = jax.tree.map(lambda a: a[0], ref_p["blocks"]["pos0"]["mamba"])
    blk = {k: v[0] for k, v in p["blocks"]["pos0"]["mamba"].items()}
    x = np.random.default_rng(4).normal(size=(2, 32, cfg.d_model)).astype(
        np.float32)
    want, (want_conv, want_h) = ref_block(jnp.asarray(x), ref_blk, ref_cfg,
                                          REF_RULES)
    got, (conv, h) = mamba_block(torch.from_numpy(x), blk, cfg, NO_RULES)
    tol = FP32 if dtype == "float32" else BF16
    assert got.dtype == getattr(torch, dtype)
    np.testing.assert_allclose(as_np(got), as_np(want), **tol)
    np.testing.assert_allclose(as_np(conv), as_np(want_conv), **tol)
    np.testing.assert_allclose(as_np(h), as_np(want_h), **tol)


def test_reference_one_token_prefill_leaves_no_mamba_state():
    """A 1-token prompt: one recurrence step from zero states, the same
    output as the reference's, and, as the reference's
    (``src/repro/models/mamba.py:171``), no (conv, h) state for decode
    (ROADMAP "Known defects")."""
    from repro.models.mamba import mamba_block as ref_block
    from repro.models.layers import NO_RULES as REF_RULES
    from repro_torch.models.layers import NO_RULES
    from repro_torch.models.mamba import mamba_block
    ref_cfg, cfg = cfgs("falcon-mamba-7b", compute_dtype="float32")
    ref_p, p = params(ref_cfg)
    ref_blk = jax.tree.map(lambda a: a[0], ref_p["blocks"]["pos0"]["mamba"])
    blk = {k: v[0] for k, v in p["blocks"]["pos0"]["mamba"].items()}
    x = np.random.default_rng(6).normal(size=(2, 1, cfg.d_model)).astype(
        np.float32)
    want, want_state = ref_block(jnp.asarray(x), ref_blk, ref_cfg, REF_RULES)
    got, state = mamba_block(torch.from_numpy(x), blk, cfg, NO_RULES)
    np.testing.assert_allclose(as_np(got), as_np(want), **FP32)
    assert state is None and want_state is None


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mamba_block_hands_the_scan_compute_dtype_inputs(dtype, monkeypatch):
    """On the kernel route delta and x reach the scan in the compute dtype,
    contiguous and with no float32 copies of bf16; the block's output is
    bit for bit what widening them first gives."""
    import repro_torch.models.mamba as mm
    from repro_torch.models.layers import NO_RULES
    _, cfg = cfgs("falcon-mamba-7b", compute_dtype=dtype)
    p = tf.init_params(cfg, seed=2, device="cpu")
    blk = {k: v[0] for k, v in p["blocks"]["pos0"]["mamba"].items()}
    x = torch.from_numpy(np.random.default_rng(6).normal(
        size=(2, 24, cfg.d_model)).astype(np.float32))
    real, seen = mm.mamba_scan, []

    def spy(delta, xs, *rest, widen=False, **kw):
        seen.append((delta.dtype, xs.dtype, delta.is_contiguous(),
                     xs.is_contiguous()))
        if widen:
            delta, xs = delta.float(), xs.float()
        return real(delta, xs, *rest, **kw)

    monkeypatch.setattr(mm, "mamba_scan", spy)
    got, (_, h) = mm.mamba_block(x, blk, cfg, NO_RULES)
    cdt = getattr(torch, dtype)
    assert seen == [(cdt, cdt, True, True)]
    monkeypatch.setattr(mm, "mamba_scan",
                        lambda *a, **kw: spy(*a, widen=True, **kw))
    want, (_, want_h) = mm.mamba_block(x, blk, cfg, NO_RULES)
    assert torch.equal(got, want) and torch.equal(h, want_h)


# ------------------------------------------------------------------- decode
@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_reference_after_grow_cache(arch):
    ref_cfg, cfg = cfgs(arch, compute_dtype="float32")
    check_decode(ref_cfg, cfg, prompt=8, steps=4)


@pytest.mark.parametrize("arch,kw,prompt", [
    pytest.param("qwen2.5-32b", dict(kv_repeat=2), 9,    # kv heads replicated
                 id="qwen2.5-32b-kw1"),
    pytest.param("granite-20b", dict(logit_softcap=30.0), 9,
                 id="granite-20b-kw2"),
])
def test_decode_options_match_reference(arch, kw, prompt):
    ref_cfg, cfg = cfgs(arch, compute_dtype="float32", **kw)
    check_decode(ref_cfg, cfg, prompt=prompt, steps=7)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_teacher_forcing(arch):
    """prefill(prefix) + decode steps == prefill(longer), in bf16 (the
    reference's own check, tests/test_models.py)."""
    _, cfg = cfgs(arch)
    p = tf.init_params(cfg, seed=1, device="cpu")
    toks = torch.from_numpy(tokens(cfg, 2, 12, seed=2)).long()
    got, want = teacher_forcing(cfg, p, toks)
    np.testing.assert_allclose(as_np(got), as_np(want), rtol=0.05,
                               atol=0.05)


# ---------------------------------------------------------------- serving
@pytest.mark.parametrize("arch", ARCHS)
def test_greedy_generate_token_identical_to_reference(arch):
    check_generate(arch)


@pytest.mark.parametrize("arch", ["stablelm-3b", "falcon-mamba-7b"])
def test_batched_server_token_identical_to_reference(arch):
    check_server(arch)


def test_server_refuses_to_drop_to_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = configs.get_config("stablelm-3b", smoke=True)
    with pytest.raises(RuntimeError, match="CUDA"):
        BatchedServer(cfg)
    p = tf.init_params(cfg, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        BatchedServer(cfg, params=p)


def test_serve_main_runs_on_the_cpu(capsys):
    from repro_torch.launch.serve import main
    main(["--arch", "falcon-mamba-7b", "--smoke", "--device", "cpu",
          "--requests", "3", "--batch", "2", "--prompt-len", "8",
          "--max-new", "4"])
    out = capsys.readouterr().out
    assert "served 3 requests, 12 tokens" in out and "prefills=2" in out


# ------------------------------------------------------------- conversion
def test_params_from_numpy_copies_and_keeps_bf16():
    a = np.arange(6, dtype=np.float32).reshape(2, 3)
    b = np.asarray(jnp.asarray([1.5, -2.25, 3.0], jnp.bfloat16))
    t = params_from_numpy({"x": {"a": a}, "b": b}, device="cpu")
    a[0, 0] = 99.0
    assert t["x"]["a"][0, 0] == 0.0                       # a copy, no alias
    assert t["b"].dtype == torch.bfloat16
    assert t["b"].float().tolist() == [1.5, -2.25, 3.0]
    c = cache_from_numpy({"pos0": {"h": a}, "pos_idx": np.int32(7)},
                         device="cpu")
    assert c["pos_idx"] == 7 and isinstance(c["pos_idx"], int)
    assert tensor_from_numpy(np.float32(2.0), device="cpu").shape == ()


def test_conversion_defaults_to_the_card(monkeypatch):
    """Without a device the trees go to the card, and without a card that
    raises instead of landing on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    a = np.zeros((2, 3), np.float32)
    for fn, arg in ((tensor_from_numpy, a), (params_from_numpy, {"a": a}),
                    (cache_from_numpy, {"pos0": {"h": a}, "pos_idx": 1})):
        with pytest.raises(RuntimeError, match="CUDA"):
            fn(arg)
        assert fn(arg, device="cpu") is not None
