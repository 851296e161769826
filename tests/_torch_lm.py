"""Shared parts of the port's LM tests (``test_torch_models*.py``,
``test_torch_vlm.py``, ``test_torch_audio.py``, ``test_torch_hybrid.py``):
the smoke configs of both packages, the reference's weights carried across
by ``params_from_numpy``, inputs drawn from numpy seeds, and the parity
checks those files parametrize over their architectures.

The reference runs its flash-attention Pallas body in interpret mode
(``attn_impl="interpret"``) and its plain scan (``ssm_impl="reference"``);
the port runs its default ``auto`` route, which on the CPU is each kernel's
plain torch version, and its ``reference`` route.  Tolerances: compute in
float32 within rtol 1e-4 / atol 1e-4 (fp32 sums in other orders over a few
layers); bfloat16 within rtol 5e-2 / atol 5e-2 (the frameworks round
matmul outputs to bf16 at different points); greedy tokens identical at
float32.  Training (``check_forward_train``): the loss within rtol 1e-5
and each gradient leaf within 1e-4 of its largest reference value plus
rtol 1e-3 (fp32 sums in other orders, forward and backward, over a few
layers).

A vlm's cross-attention gate is initialised to zero, and ``tanh(0) * out``
would hide the whole branch from every check, so ``params`` sets each
``xattn.gate`` to a nonzero value drawn from a numpy seed, the same in the
reference's tree and the port's.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro import configs as ref_configs
from repro.launch.serve import BatchedServer as RefServer
from repro.launch.serve import Request as RefRequest
from repro.models import transformer as ref_tf
from repro.train.serve_step import generate as ref_generate
from repro_torch import configs
from repro_torch.kernels import launch_counts, reset_launches
from repro_torch.kernels.flash_attention import (flash_attention_backward_ref,
                                                 flash_attention_ref)
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.mamba_scan import (mamba_scan_backward_ref,
                                            mamba_scan_ref)
from repro_torch.kernels.mamba_scan import ops as scan_ops
from repro_torch.launch.serve import BatchedServer, Request
from repro_torch.models import transformer as tf
from repro_torch.models.convert import params_from_numpy
from repro_torch.train.serve_step import generate, make_serve_steps

FP32 = dict(rtol=1e-4, atol=1e-4)
BF16 = dict(rtol=5e-2, atol=5e-2)


def cfgs(arch, **kw):
    """(reference cfg, port cfg) for the smoke config of ``arch``."""
    ref = ref_configs.get_config(arch, smoke=True).replace(
        attn_impl="interpret", ssm_impl="reference", **kw)
    port = configs.get_config(arch, smoke=True).replace(**kw)
    return ref, port


def set_gates(tree, seed=13):
    """Every ``xattn.gate`` of a numpy parameter tree set, in place, to a
    value in [0.5, 1) from numpy ``seed``."""
    rng = np.random.default_rng(seed)
    for sub in tree["blocks"].values():
        if "xattn" in sub:
            g = sub["xattn"]["gate"]
            sub["xattn"]["gate"] = rng.uniform(0.5, 1.0, g.shape).astype(
                g.dtype)
    return tree


def params(ref_cfg):
    """The reference's seeded parameters and the port's copy of them, with
    nonzero cross-attention gates."""
    p = set_gates(jax.tree.map(np.asarray, ref_tf.init_params(
        ref_cfg, jax.random.PRNGKey(0))))
    return jax.tree.map(jnp.asarray, p), params_from_numpy(p, device="cpu")


def tokens(cfg, B, S, seed=3):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (B, S)).astype(np.int32)


def vision(cfg, B, seed=17):
    """Stub patch embeddings [B, n_vision_tokens, d_model]."""
    return np.random.default_rng(seed).normal(
        size=(B, cfg.n_vision_tokens, cfg.d_model)).astype(np.float32)


def frames(cfg, B, T, seed=19):
    """Stub frame embeddings [B, T, d_model]."""
    return np.random.default_rng(seed).normal(
        size=(B, T, cfg.d_model)).astype(np.float32)


def batches(cfg, B, S, seed=3):
    """(reference batch, port batch) of the same numpy inputs: ``frames``
    for audio, else ``tokens``, plus ``vision`` for a vlm."""
    if cfg.family == "audio":
        arrays = {"frames": frames(cfg, B, S, seed)}
    else:
        arrays = {"tokens": tokens(cfg, B, S, seed)}
        if cfg.family == "vlm":
            arrays["vision"] = vision(cfg, B, seed + 1)
    ref = {k: jnp.asarray(v) for k, v in arrays.items()}
    port = {k: torch.from_numpy(v).long() if k == "tokens"
            else torch.from_numpy(v) for k, v in arrays.items()}
    return ref, port


def as_np(t):
    return t.float().numpy() if isinstance(t, torch.Tensor) else np.asarray(
        t, np.float32)


def close_tree(got, want, tol, path=""):
    if isinstance(want, dict):
        assert set(got) == set(want), path
        for k in want:
            close_tree(got[k], want[k], tol, f"{path}.{k}")
    elif path.endswith("pos_idx"):
        assert int(got) == int(want)
    else:
        np.testing.assert_allclose(as_np(got), as_np(want), err_msg=path,
                                   **tol)


# ------------------------------------------------------------------ checks
def check_cache_shapes(arch, kw):
    """make_cache_shapes equals the reference's, and a prefill's grown
    cache has those shapes and dtypes (a vlm's prefill with vision)."""
    ref_cfg, cfg = cfgs(arch, **kw)
    want = ref_tf.make_cache_shapes(ref_cfg, 2, 12, ref_tf.NO_RULES)
    got = tf.make_cache_shapes(cfg, 2, 12)
    p = tf.init_params(cfg, device="cpu")
    _, cache = tf.forward_prefill(p, batches(cfg, 2, 8)[1], cfg)
    cache = tf.grow_cache(cache, cfg, 12)
    assert set(got) == set(want) == set(cache)
    for key, sub in want.items():
        if key == "pos_idx":
            assert got[key].shape == () and cache[key] == 8
            continue
        assert set(got[key]) == set(sub) == set(cache[key]), key
        for name, leaf in sub.items():
            assert tuple(got[key][name].shape) == leaf.shape, (key, name)
            assert tuple(cache[key][name].shape) == leaf.shape, (key, name)
            assert cache[key][name].dtype == got[key][name].dtype
            assert str(got[key][name].dtype).split(".")[-1] == str(leaf.dtype)


def check_prefill(arch, dtype, **kw):
    """Last-position logits and the whole cache on both port routes."""
    ref_cfg, cfg = cfgs(arch, compute_dtype=dtype, **kw)
    ref_p, p = params(ref_cfg)
    # 32 tokens: a multiple of the smoke configs' ssm_chunk (16), because
    # the reference's chunked scan fails on a padded last chunk
    ref_b, b = batches(cfg, 2, 32)
    want_lg, want_cache = ref_tf.forward_prefill(ref_p, ref_b, ref_cfg)
    tol = FP32 if dtype == "float32" else BF16
    for impl in ("auto", "reference"):
        run_cfg = cfg.replace(attn_impl=impl, ssm_impl=impl)
        lg, cache = tf.forward_prefill(p, b, run_cfg)
        assert lg.dtype == getattr(torch, dtype)
        assert lg.shape == (2, 1, cfg.vocab_size)
        np.testing.assert_allclose(as_np(lg), as_np(want_lg), **tol)
        close_tree(cache, want_cache, tol)


def check_decode(ref_cfg, cfg, prompt, steps, seed=5):
    """Prefill, grow_cache and ``steps`` decode steps, each step's logits
    and the final cache against the reference's, in fp32."""
    ref_p, p = params(ref_cfg)
    toks = tokens(cfg, 2, prompt + steps, seed)
    ref_b, b = batches(cfg, 2, prompt, seed)
    ref_b["tokens"] = jnp.asarray(toks[:, :prompt])
    b["tokens"] = torch.from_numpy(toks[:, :prompt]).long()
    lg_r, c_r = ref_tf.forward_prefill(ref_p, ref_b, ref_cfg)
    lg, c = tf.forward_prefill(p, b, cfg)
    c_r = ref_tf.grow_cache(c_r, ref_cfg, prompt + steps)
    c = tf.grow_cache(c, cfg, prompt + steps)
    close_tree(c, c_r, FP32)
    # jitted, as the reference's own serving loop runs it
    ref_decode = jax.jit(lambda p_, c_, b_: ref_tf.decode_step(p_, c_, b_,
                                                               ref_cfg))
    for t in range(prompt, prompt + steps):
        lg_r, c_r = ref_decode(
            ref_p, c_r, {"tokens": jnp.asarray(toks[:, t:t + 1])})
        lg, c = tf.decode_step(
            p, c, {"tokens": torch.from_numpy(toks[:, t:t + 1]).long()}, cfg)
        np.testing.assert_allclose(as_np(lg), as_np(lg_r),
                                   err_msg=f"step {t}", **FP32)
    close_tree(c, c_r, FP32)


def teacher_forcing(cfg, p, toks, steps=4, extra=None):
    """(logits after prefill(all but ``steps`` tokens) + ``steps`` decode
    steps, logits of prefill(all)), each [B, V].  ``extra``: more batch
    entries for both prefills (a vlm's vision)."""
    prefill, decode = make_serve_steps(cfg)
    S = toks.shape[1]
    lg, cache = prefill(p, dict(extra or {}, tokens=toks[:, :S - steps]))
    cache = tf.grow_cache(cache, cfg, S)
    for t in range(S - steps, S):
        lg, cache = decode(p, cache, {"tokens": toks[:, t:t + 1]})
    lg_ref, _ = prefill(p, dict(extra or {}, tokens=toks))
    return lg[:, 0], lg_ref[:, 0]


def check_generate(arch, with_vision=False):
    """Greedy tokens identical to the reference's, in fp32, with no kernel
    launched on the CPU."""
    ref_cfg, cfg = cfgs(arch, compute_dtype="float32")
    ref_p, p = params(ref_cfg)
    prompts = tokens(cfg, 3, 16, seed=7)
    ref_kw, kw = {}, {}
    if with_vision:
        v = vision(cfg, 3)
        ref_kw, kw = {"vision": jnp.asarray(v)}, {"vision": torch.from_numpy(v)}
    want = ref_generate(ref_p, ref_cfg, jnp.asarray(prompts), 8, **ref_kw)
    reset_launches()
    got = generate(p, cfg, torch.from_numpy(prompts).long(), 8, **kw)
    assert got.shape == (3, 8)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert launch_counts()["flash_attention"] == 0        # CPU: plain only
    assert launch_counts()["mamba_scan"] == 0


def check_server(arch):
    """``BatchedServer`` token-identical to the reference's (5 requests in
    waves of 2, ragged max_new)."""
    ref_cfg, cfg = cfgs(arch, compute_dtype="float32")
    ref_p, p = params(ref_cfg)
    prompts = tokens(cfg, 5, 12, seed=9)
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


# ------------------------------------------------------------------ training
def train_batches(cfg, B, S, seed=3):
    """``batches`` plus, for audio, ``labels`` [B, S] from numpy."""
    ref, port = batches(cfg, B, S, seed)
    if cfg.family == "audio":
        lab = np.random.default_rng(seed + 2).integers(
            0, cfg.vocab_size, (B, S)).astype(np.int32)
        ref["labels"] = jnp.asarray(lab)
        port["labels"] = torch.from_numpy(lab).long()
    return ref, port


def grad_tree(tree):
    if isinstance(tree, dict):
        return {k: grad_tree(v) for k, v in tree.items()}
    return tree.grad if tree.grad is not None else torch.zeros_like(tree)


def close_grads(got, want, path=""):
    """Leaf by leaf: |got - want| <= 1e-4 * max|want| + 1e-3 * |want|."""
    if isinstance(want, dict):
        assert set(got) == set(want), path
        for k in want:
            close_grads(got[k], want[k], f"{path}.{k}")
        return
    g, w = as_np(got), as_np(want)
    assert g.shape == w.shape, path
    np.testing.assert_allclose(g, w, rtol=1e-3,
                               atol=1e-4 * float(np.abs(w).max()) + 1e-12,
                               err_msg=path)


@functools.lru_cache(maxsize=None)
def reference_train(arch, **kw):
    """(port cfg, params as numpy, port batch, reference loss, metrics and
    gradients): ``jax.value_and_grad`` of the reference's
    ``forward_train`` at fp32 on its plain attention, batch 2 x 32;
    ``kw``: config fields set in both packages."""
    ref_cfg, cfg = cfgs(arch, compute_dtype="float32", **kw)
    ref_cfg = ref_cfg.replace(attn_impl="reference")
    ref_p, _ = params(ref_cfg)
    ref_b, b = train_batches(cfg, 2, 32)
    (loss, mets), grads = jax.value_and_grad(
        lambda pp: ref_tf.forward_train(pp, ref_b, ref_cfg), has_aux=True)(
            ref_p)
    return cfg, jax.tree.map(np.asarray, ref_p), b, loss, mets, grads


def standin_kernels(monkeypatch):
    """The plain versions in place of the CUDA launches, forward and
    backward (``attn_impl`` / ``ssm_impl = "cuda"`` then runs the card's
    Functions on the CPU), each call counted."""
    counts = {"flash": 0, "flash_bwd": 0, "scan": 0, "scan_bwd": 0}

    def counted(name, fn):
        def call(*a, **kw):
            counts[name] += 1
            return fn(*a, **kw)
        return call
    for mod, name, key, fn in (
            (flash_ops, "flash_attention_cuda", "flash", flash_attention_ref),
            (flash_ops, "flash_attention_backward_cuda", "flash_bwd",
             flash_attention_backward_ref),
            (scan_ops, "mamba_scan_cuda", "scan", mamba_scan_ref),
            (scan_ops, "mamba_scan_backward_cuda", "scan_bwd",
             mamba_scan_backward_ref)):
        monkeypatch.setattr(mod, name, counted(key, fn))
    return counts


def check_forward_train(arch, route, monkeypatch, **kw):
    """The port's ``forward_train`` loss and every gradient leaf against
    the reference's, on route ``route`` ('cuda': the kernels' Functions
    over stand-in kernels, each forward launched once a layer forward and
    once in the period's recompute, each backward once a layer; vision
    counts as a layer's second attention)."""
    counts = standin_kernels(monkeypatch)
    cfg, p_np, b, ref_loss, ref_m, ref_g = reference_train(arch, **kw)
    cfg = cfg.replace(attn_impl=route, ssm_impl=route)
    p = params_from_numpy(p_np, device="cpu")
    p = jax.tree.map(lambda t: t.requires_grad_(True), p)
    loss, mets = tf.forward_train(p, b, cfg)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(ref_loss), rtol=1e-5)
    for k in ("ce", "aux"):
        np.testing.assert_allclose(mets[k].item(), float(ref_m[k]),
                                   rtol=1e-5, atol=1e-7)
    close_grads(grad_tree(p), ref_g)
    layers = range(cfg.n_layers)
    n_flash = sum(cfg.layer_kind(i) == "attn" for i in layers)
    if "vision" in b:
        n_flash += sum(cfg.has_cross_attn(i) for i in layers)
    n_ssm = sum(cfg.layer_kind(i) == "mamba" for i in layers)
    on = route == "cuda"
    assert counts["flash"] == (2 * n_flash if on else 0)
    assert counts["scan"] == (2 * n_ssm if on else 0)
    assert counts["flash_bwd"] == (n_flash if on else 0)
    assert counts["scan_bwd"] == (n_ssm if on else 0)
    return mets
