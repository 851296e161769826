"""The port's LM serving path (``repro_torch.models``, ``.train.serve_step``,
``.launch.serve``) against the JAX reference, on the smoke configs of the
dense, MoE and SSM families, with the reference's weights carried across by
``params_from_numpy``.

The reference runs its flash-attention Pallas body in interpret mode
(``attn_impl="interpret"``) and its plain scan (``ssm_impl="reference"``);
the port runs its default ``auto`` route, which on the CPU is each kernel's
plain torch version, and its ``reference`` route.  Tolerances: compute in
float32 within rtol 1e-4 / atol 1e-4 (fp32 sums in other orders over a few
layers); bfloat16 within rtol 5e-2 / atol 5e-2 (the frameworks round
matmul outputs to bf16 at different points); greedy tokens identical at
float32.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as ref_configs
from repro.launch.serve import BatchedServer as RefServer
from repro.launch.serve import Request as RefRequest
from repro.models import transformer as ref_tf
from repro.train.serve_step import generate as ref_generate
from repro_torch import configs
from repro_torch.kernels import launch_counts, reset_launches
from repro_torch.launch.serve import BatchedServer, Request
from repro_torch.models import transformer as tf
from repro_torch.models.convert import (cache_from_numpy, params_from_numpy,
                                        tensor_from_numpy)
from repro_torch.train.serve_step import generate, make_serve_steps

ARCHS = ["stablelm-3b", "qwen2.5-32b", "granite-20b", "falcon-mamba-7b",
         "mixtral-8x7b", "grok-1-314b"]
FP32 = dict(rtol=1e-4, atol=1e-4)
BF16 = dict(rtol=5e-2, atol=5e-2)


def _cfgs(arch, **kw):
    """(reference cfg, port cfg) for the smoke config of ``arch``."""
    ref = ref_configs.get_config(arch, smoke=True).replace(
        attn_impl="interpret", ssm_impl="reference", **kw)
    port = configs.get_config(arch, smoke=True).replace(**kw)
    return ref, port


def _params(ref_cfg):
    p = ref_tf.init_params(ref_cfg, jax.random.PRNGKey(0))
    return p, params_from_numpy(jax.tree.map(np.asarray, p), device="cpu")


def _tokens(cfg, B, S, seed=3):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (B, S)).astype(np.int32)


def _np(t):
    return t.float().numpy() if isinstance(t, torch.Tensor) else np.asarray(
        t, np.float32)


def _close_tree(got, want, tol, path=""):
    if isinstance(want, dict):
        assert set(got) == set(want), path
        for k in want:
            _close_tree(got[k], want[k], tol, f"{path}.{k}")
    elif path.endswith("pos_idx"):
        assert int(got) == int(want)
    else:
        np.testing.assert_allclose(_np(got), _np(want), err_msg=path, **tol)


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


@pytest.mark.parametrize("arch", ["jamba-1.5-large-398b",
                                  "llama-3.2-vision-11b", "hubert-xlarge"])
def test_unsupported_families_raise(arch):
    cfg = configs.get_config(arch, smoke=True)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tf.init_params(cfg, device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tf.forward_prefill({}, {"tokens": torch.zeros((1, 4), dtype=torch.long)},
                           cfg)


def test_init_params_matches_reference_structure_and_constants():
    ref_cfg, cfg = _cfgs("falcon-mamba-7b")
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


@pytest.mark.parametrize("arch,kw", [("stablelm-3b", {}),
                                     ("falcon-mamba-7b", {}),
                                     ("mixtral-8x7b", {}),
                                     ("stablelm-3b", dict(sliding_window=6)),
                                     ("qwen2.5-32b", dict(kv_repeat=2))])
def test_cache_shapes_match_reference_and_the_grown_cache(arch, kw):
    ref_cfg, cfg = _cfgs(arch, **kw)
    want = ref_tf.make_cache_shapes(ref_cfg, 2, 12, ref_tf.NO_RULES)
    got = tf.make_cache_shapes(cfg, 2, 12)
    p = tf.init_params(cfg, device="cpu")
    _, cache = tf.forward_prefill(
        p, {"tokens": torch.from_numpy(_tokens(cfg, 2, 8)).long()}, cfg)
    cache = tf.grow_cache(cache, cfg, 12)
    assert set(got) == set(want) == set(cache)
    for key, sub in want.items():
        if key == "pos_idx":
            assert got[key].shape == () and cache[key] == 8
            continue
        for name, leaf in sub.items():
            assert tuple(got[key][name].shape) == leaf.shape, (key, name)
            assert tuple(cache[key][name].shape) == leaf.shape, (key, name)
            assert cache[key][name].dtype == got[key][name].dtype
            assert str(got[key][name].dtype).split(".")[-1] == str(leaf.dtype)


# ------------------------------------------------------------------ prefill
@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_logits_and_cache_match_reference(arch, dtype):
    ref_cfg, cfg = _cfgs(arch, compute_dtype=dtype)
    ref_p, p = _params(ref_cfg)
    # 32 tokens: a multiple of the smoke configs' ssm_chunk (16), because
    # the reference's chunked scan fails on a padded last chunk
    toks = _tokens(cfg, 2, 32)
    want_lg, want_cache = ref_tf.forward_prefill(
        ref_p, {"tokens": jnp.asarray(toks)}, ref_cfg)
    tol = FP32 if dtype == "float32" else BF16
    for impl in ("auto", "reference"):
        run_cfg = cfg.replace(attn_impl=impl, ssm_impl=impl)
        lg, cache = tf.forward_prefill(
            p, {"tokens": torch.from_numpy(toks).long()}, run_cfg)
        assert lg.dtype == getattr(torch, dtype) and lg.shape == (2, 1, 256)
        np.testing.assert_allclose(_np(lg), _np(want_lg), **tol)
        _close_tree(cache, want_cache, tol)


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
    ref_cfg, cfg = _cfgs("falcon-mamba-7b", compute_dtype=dtype)
    ref_p, p = _params(ref_cfg)
    ref_blk = jax.tree.map(lambda a: a[0], ref_p["blocks"]["pos0"]["mamba"])
    blk = {k: v[0] for k, v in p["blocks"]["pos0"]["mamba"].items()}
    x = np.random.default_rng(4).normal(size=(2, 32, cfg.d_model)).astype(
        np.float32)
    want, (want_conv, want_h) = ref_block(jnp.asarray(x), ref_blk, ref_cfg,
                                          REF_RULES)
    got, (conv, h) = mamba_block(torch.from_numpy(x), blk, cfg, NO_RULES)
    tol = FP32 if dtype == "float32" else BF16
    assert got.dtype == getattr(torch, dtype)
    np.testing.assert_allclose(_np(got), _np(want), **tol)
    np.testing.assert_allclose(_np(conv), _np(want_conv), **tol)
    np.testing.assert_allclose(_np(h), _np(want_h), **tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mamba_block_hands_the_scan_compute_dtype_inputs(dtype, monkeypatch):
    """On the kernel route delta and x reach the scan in the compute dtype,
    contiguous and with no float32 copies of bf16; the block's output is
    bit for bit what widening them first gives."""
    import repro_torch.models.mamba as mm
    from repro_torch.models.layers import NO_RULES
    _, cfg = _cfgs("falcon-mamba-7b", compute_dtype=dtype)
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
def _decode_parity(ref_cfg, cfg, prompt, steps, seed=5):
    ref_p, p = _params(ref_cfg)
    toks = _tokens(cfg, 2, prompt + steps, seed)
    lg_r, c_r = ref_tf.forward_prefill(
        ref_p, {"tokens": jnp.asarray(toks[:, :prompt])}, ref_cfg)
    lg, c = tf.forward_prefill(
        p, {"tokens": torch.from_numpy(toks[:, :prompt]).long()}, cfg)
    c_r = ref_tf.grow_cache(c_r, ref_cfg, prompt + steps)
    c = tf.grow_cache(c, cfg, prompt + steps)
    _close_tree(c, c_r, FP32)
    for t in range(prompt, prompt + steps):
        lg_r, c_r = ref_tf.decode_step(
            ref_p, c_r, {"tokens": jnp.asarray(toks[:, t:t + 1])}, ref_cfg)
        lg, c = tf.decode_step(
            p, c, {"tokens": torch.from_numpy(toks[:, t:t + 1]).long()}, cfg)
        np.testing.assert_allclose(_np(lg), _np(lg_r), err_msg=f"step {t}",
                                   **FP32)
    _close_tree(c, c_r, FP32)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_reference_after_grow_cache(arch):
    ref_cfg, cfg = _cfgs(arch, compute_dtype="float32")
    _decode_parity(ref_cfg, cfg, prompt=8, steps=4)


@pytest.mark.parametrize("arch,kw,prompt", [
    # the ring buffer wraps during decode; the prompts stay within the
    # window, where the reference's prefill cache is right (see below)
    pytest.param("stablelm-3b", dict(sliding_window=6), 4,
                 id="stablelm-3b-kw0"),
    pytest.param("qwen2.5-32b", dict(kv_repeat=2), 9,    # kv heads replicated
                 id="qwen2.5-32b-kw1"),
    pytest.param("granite-20b", dict(logit_softcap=30.0), 9,
                 id="granite-20b-kw2"),
    pytest.param("qwen2.5-32b", dict(sliding_window=5, logit_softcap=20.0),
                 5, id="qwen2.5-32b-kw3"),
])
def test_decode_options_match_reference(arch, kw, prompt):
    ref_cfg, cfg = _cfgs(arch, compute_dtype="float32", **kw)
    _decode_parity(ref_cfg, cfg, prompt=prompt, steps=7)


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
        gap = max(gap, float(np.abs(_np(lg) - _np(want)).max()))
    return gap


@pytest.mark.parametrize("arch,kw,prompt", LONG_PROMPTS)
def test_window_decode_after_a_long_prompt_matches_a_longer_prefill(
        arch, kw, prompt):
    ref_cfg, cfg = _cfgs(arch, compute_dtype="float32", **kw)
    assert prompt > cfg.sliding_window and prompt % cfg.sliding_window
    _, p = _params(ref_cfg)
    toks = torch.from_numpy(_tokens(cfg, 1, prompt + 4, seed=11)).long()
    gap = _window_decode_gap(
        lambda p_, t: tf.forward_prefill(p_, {"tokens": t}, cfg),
        lambda p_, c, t: tf.decode_step(p_, c, {"tokens": t}, cfg),
        lambda c, n: tf.grow_cache(c, cfg, n), p, toks, prompt)
    assert gap <= 1e-4


def test_reference_window_cache_defect_after_a_long_prompt():
    """Documents the reference defect the port routes around: its first
    decode step after the same long prompt is off by more than 1e-3."""
    arch, kw, prompt = LONG_PROMPTS[0]
    ref_cfg, cfg = _cfgs(arch, compute_dtype="float32", **kw)
    ref_p, _ = _params(ref_cfg)
    toks = jnp.asarray(_tokens(cfg, 1, prompt + 1, seed=11))
    gap = _window_decode_gap(
        lambda p_, t: ref_tf.forward_prefill(p_, {"tokens": t}, ref_cfg),
        lambda p_, c, t: ref_tf.decode_step(p_, c, {"tokens": t}, ref_cfg),
        lambda c, n: ref_tf.grow_cache(c, ref_cfg, n), ref_p, toks, prompt)
    assert gap > 1e-3


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_teacher_forcing(arch):
    """prefill(prefix) + decode steps == prefill(longer), in bf16 (the
    reference's own check, tests/test_models.py)."""
    _, cfg = _cfgs(arch)
    if cfg.n_experts:
        # teacher forcing is an identity only when no token is dropped: a
        # group of the longer prefill holds other tokens, so a token it
        # drops may be one decode keeps.  At a capacity factor of E / k the
        # capacity is at least the group size, and nothing can be dropped
        cfg = cfg.replace(
            capacity_factor=cfg.n_experts / cfg.experts_per_token)
    prefill, decode = make_serve_steps(cfg)
    p = tf.init_params(cfg, seed=1, device="cpu")
    toks = torch.from_numpy(_tokens(cfg, 2, 12, seed=2)).long()
    lg, cache = prefill(p, {"tokens": toks[:, :8]})
    cache = tf.grow_cache(cache, cfg, 12)
    for t in range(8, 12):
        lg, cache = decode(p, cache, {"tokens": toks[:, t:t + 1]})
    lg_ref, _ = prefill(p, {"tokens": toks})
    np.testing.assert_allclose(_np(lg[:, 0]), _np(lg_ref[:, 0]), rtol=0.05,
                               atol=0.05)


# ---------------------------------------------------------------- serving
@pytest.mark.parametrize("arch", ARCHS)
def test_greedy_generate_token_identical_to_reference(arch):
    ref_cfg, cfg = _cfgs(arch, compute_dtype="float32")
    ref_p, p = _params(ref_cfg)
    prompts = _tokens(cfg, 3, 16, seed=7)
    want = ref_generate(ref_p, ref_cfg, jnp.asarray(prompts), 8)
    reset_launches()
    got = generate(p, cfg, torch.from_numpy(prompts).long(), 8)
    assert got.shape == (3, 8)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert launch_counts()["flash_attention"] == 0        # CPU: plain only
    assert launch_counts()["mamba_scan"] == 0


@pytest.mark.parametrize("arch", ["stablelm-3b", "falcon-mamba-7b",
                                  "mixtral-8x7b"])
def test_batched_server_token_identical_to_reference(arch):
    ref_cfg, cfg = _cfgs(arch, compute_dtype="float32")
    ref_p, p = _params(ref_cfg)
    prompts = _tokens(cfg, 5, 12, seed=9)
    ref_reqs = [RefRequest(rid=i, prompt=prompts[i], max_new=6 - (i % 2))
                for i in range(5)]
    reqs = [Request(rid=i, prompt=prompts[i], max_new=6 - (i % 2))
            for i in range(5)]
    RefServer(ref_cfg, params=ref_p, batch=2).run(ref_reqs)
    server = BatchedServer(cfg, params=p, batch=2, device="cpu")
    done = server.run(reqs)
    assert [r.out_tokens for r in done] == [r.out_tokens for r in ref_reqs]
    assert [len(r.out_tokens) for r in done] == [6, 5, 6, 5, 6]
    assert server.stats["prefills"] == 3 and server.stats["decode_steps"] == 15


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
