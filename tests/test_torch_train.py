"""The port's training side (``repro_torch.train``, ``forward_train`` and
the kernels' autograd Functions) against the JAX reference on the same
numpy inputs, weights and optimizer state.

On the CPU the Functions run with the plain forward and backward in place
of the kernels (``FlashAttentionFunction.apply(..., flash_attention_ref,
flash_attention_backward_ref)``), and the model's card route is rehearsed
by standing the plain versions in for ``flash_attention_cuda`` /
``mamba_scan_cuda`` and their backward launches (``attn_impl`` /
``ssm_impl = "cuda"``): the same Functions, remat and launch counts as on
the card.  The reference differentiates its plain versions
(``attn_impl="reference"``; it cannot differentiate its Pallas kernels).

Tolerances, all fp32: the schedule within rtol 1e-6 (fp32 math in the
same order); AdamW within rtol 1e-5 / atol 1e-7 (the global norm sums the
leaves in another order); gradients and first moments as
``_torch_lm.close_grads`` holds them (within 1e-4 of the leaf's largest
reference value plus rtol 1e-3: fp32 sums in other orders over two
layers), losses within rtol 1e-5; parameters after two
train steps within rtol 1e-4 / atol 1e-2 * lr (Adam's first steps move
each weight by about lr whatever the size of its gradient, so a gradient
near eps = 1e-8, whose fp32 rounding differs by a few percent between the
frameworks, moves its weight by a visible share of lr: one wv element of
the smoke model, 0.5% of lr; every other agrees to rtol 1e-4).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_lm import (batches, cfgs, check_forward_train, close_grads,
                       params, standin_kernels)
from repro.kernels.flash_attention.ref import flash_attention_ref as ref_flash
from repro.kernels.mamba_scan import mamba_scan_ref as ref_scan
from repro.train import compression as ref_comp
from repro.train.optimizer import OptConfig as RefOptConfig
from repro.train.optimizer import adamw_update as ref_adamw
from repro.train.optimizer import init_opt_state as ref_init_opt
from repro.train.optimizer import lr_at as ref_lr_at
from repro.train.train_step import make_train_step as ref_make_step
from repro_torch.kernels.flash_attention import (FlashAttentionFunction,
                                                 flash_attention_backward_ref,
                                                 flash_attention_ref)
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.mamba_scan import (MambaScanFunction,
                                            mamba_scan_backward_ref,
                                            mamba_scan_chunked,
                                            mamba_scan_ref)
from repro_torch.models import transformer as tf
from repro_torch.models.convert import opt_state_from_numpy
from repro_torch.train import compression as comp
from repro_torch.train.optimizer import (OptConfig, adamw_update,
                                         init_opt_state, lr_at)
from repro_torch.train.train_step import make_train_step

RNG = np.random.default_rng(23)


def _np(t):
    return t.detach().float().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t, np.float32)


def close_tree(got, want, rtol, atol, path=""):
    if isinstance(want, dict):
        assert set(got) == set(want), path
        for k in want:
            close_tree(got[k], want[k], rtol, atol, f"{path}.{k}")
        return
    np.testing.assert_allclose(_np(got), _np(want), rtol=rtol, atol=atol,
                               err_msg=path)


def _requires_grad(tree):
    if isinstance(tree, dict):
        return {k: _requires_grad(v) for k, v in tree.items()}
    return tree.requires_grad_(True)


# ------------------------------------------------------------ optimizer
@pytest.mark.parametrize("warmup,total,min_frac", [
    (10, 100, 0.1), (1, 4, 0.1), (100, 10_000, 0.0)])
def test_lr_at_matches_reference(warmup, total, min_frac):
    kw = dict(lr=3e-4, warmup_steps=warmup, total_steps=total,
              min_lr_frac=min_frac)
    ocfg, ref = OptConfig(**kw), RefOptConfig(**kw)
    for s in sorted({0, 1, warmup - 1, warmup, warmup + 1, total // 2,
                     total - 1, total, total + 7}):
        got = lr_at(torch.tensor(s, dtype=torch.int32), ocfg)
        want = ref_lr_at(jnp.asarray(s, jnp.int32), ref)
        assert got.dtype == torch.float32
        np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


def _opt_tree(scale):
    """Parameters and gradients of every kind the model has: a stacked
    matrix [L, a, b], a stacked norm [L, d], a matrix and a vector."""
    shapes = {"blocks": {"pos0": {"w": (3, 5, 4), "ln": (3, 4)}},
              "head_w": (4, 6), "final_ln": (4,)}

    def draw(t, s):
        if isinstance(t, dict):
            return {k: draw(v, s) for k, v in t.items()}
        return RNG.normal(scale=s, size=t).astype(np.float32)
    return draw(shapes, 1.0), [draw(shapes, scale) for _ in range(3)]


@pytest.mark.parametrize("grad_scale,clip,dtype", [
    (0.01, 1.0, "float32"), (3.0, 1.0, "float32"), (0.5, 0.0, "float32"),
    (0.5, 1.0, "bfloat16")])
def test_adamw_update_matches_reference(grad_scale, clip, dtype):
    """Three in-place updates against the reference's three functional
    ones, from the same state: params, moments, step and stats.  bf16:
    params and moments stored in bf16 (the giant archs' policy)."""
    ref_cfg, cfg = cfgs("stablelm-3b", param_dtype=dtype,
                        opt_state_dtype=dtype)
    kw = dict(lr=1e-2, warmup_steps=2, total_steps=10, grad_clip=clip)
    ocfg, ref_ocfg = OptConfig(**kw), RefOptConfig(**kw)
    p_np, grads = _opt_tree(grad_scale)
    jdt = jnp.dtype(dtype)
    ref_p = jax.tree.map(lambda a: jnp.asarray(a, jdt), p_np)
    ref_opt = ref_init_opt(ref_p, ref_cfg)
    p = jax.tree.map(lambda a: torch.from_numpy(np.array(a)).to(
        getattr(torch, dtype)), p_np)
    opt = init_opt_state(p, cfg)
    assert opt["step"].dtype == torch.int32
    tol = (dict(rtol=1e-5, atol=1e-7) if dtype == "float32"
           else dict(rtol=1e-2, atol=1e-3))
    for g in grads:
        ref_p, ref_opt, ref_stats = ref_adamw(
            jax.tree.map(lambda a: jnp.asarray(a, jdt), g), ref_p, ref_opt,
            ref_ocfg, ref_cfg)
        before = p["head_w"]
        stats = adamw_update(jax.tree.map(
            lambda a: torch.from_numpy(np.array(a)).to(getattr(torch, dtype)),
            g), p, opt, ocfg, cfg)
        assert p["head_w"] is before            # in place
        assert p["head_w"].dtype == getattr(torch, dtype)
        assert opt["m"]["head_w"].dtype == getattr(torch, dtype)
        close_tree(p, ref_p, **tol)
        close_tree(opt["m"], ref_opt["m"], **tol)
        close_tree(opt["v"], ref_opt["v"], **tol)
        assert int(opt["step"]) == int(ref_opt["step"])
        np.testing.assert_allclose(float(stats["lr"]),
                                   float(ref_stats["lr"]), rtol=1e-6)
        np.testing.assert_allclose(float(stats["grad_norm"]),
                                   float(ref_stats["grad_norm"]), rtol=1e-5)


# ------------------------------------------------- the kernels' Functions
@pytest.mark.parametrize("B,Sq,Skv,Kh,G,hd,causal,window,softcap", [
    (2, 24, 24, 2, 2, 16, True, 0, 0.0),        # causal GQA
    (1, 32, 32, 1, 4, 8, True, 7, 5.0),         # sliding window, softcap
    (2, 17, 29, 1, 2, 8, False, 0, 0.0),        # cross-attention shapes
])
def test_flash_function_gradients_match_reference(B, Sq, Skv, Kh, G, hd,
                                                  causal, window, softcap):
    q = RNG.normal(size=(B, Sq, Kh, G, hd)).astype(np.float32)
    k = RNG.normal(size=(B, Skv, Kh, hd)).astype(np.float32)
    v = RNG.normal(size=(B, Skv, Kh, hd)).astype(np.float32)
    w = RNG.normal(size=q.shape).astype(np.float32)
    opts = dict(causal=causal, window=window, softcap=softcap)

    def ref_loss(q_, k_, v_):
        return jnp.sum(ref_flash(q_, k_, v_, **opts) * w)
    want = jax.grad(ref_loss, argnums=(0, 1, 2))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    calls = []

    def forward(*args, **kw):
        calls.append(kw)
        return flash_attention_ref(*args, **kw)

    def backward(*args, **kw):
        calls.append(kw)
        return flash_attention_backward_ref(*args, **kw)
    qt, kt, vt = (torch.from_numpy(a).requires_grad_(True)
                  for a in (q, k, v))
    out = FlashAttentionFunction.apply(qt, kt, vt, causal, window, softcap,
                                       forward, backward)
    (out * torch.from_numpy(w)).sum().backward()
    assert calls == [dict(opts, return_lse=True), opts]
    for got, ref in zip((qt.grad, kt.grad, vt.grad), want):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-4,
                                   atol=1e-5)


def _scan_inputs(Bt, T, d, N):
    delta = np.log1p(np.exp(RNG.normal(size=(Bt, T, d)))) * 0.1
    x = RNG.normal(size=(Bt, T, d))
    Bm = RNG.normal(size=(Bt, T, N))
    C = RNG.normal(size=(Bt, T, N))
    A = -np.exp(RNG.normal(size=(d, N)) * 0.5)
    h0 = RNG.normal(size=(Bt, d, N))
    return [a.astype(np.float32) for a in (delta, x, Bm, C, A, h0)]


@pytest.mark.parametrize("Bt,T,d,N,chunk", [
    (2, 32, 6, 4, 8), (1, 21, 5, 3, 8), (2, 16, 4, 2, 128)])
def test_scan_function_gradients_match_reference(Bt, T, d, N, chunk):
    """All six gradients (delta, x, B, C, A and a nonzero h0) of a loss
    over y and hT; carries every ``chunk`` steps for the backward, a short
    last chunk included."""
    arrs = _scan_inputs(Bt, T, d, N)
    wy = RNG.normal(size=(Bt, T, d)).astype(np.float32)
    wh = RNG.normal(size=(Bt, d, N)).astype(np.float32)

    def ref_loss(*a):
        y, hT = ref_scan(*a)
        return jnp.sum(y * wy) + jnp.sum(hT * wh)
    want = jax.grad(ref_loss, argnums=tuple(range(6)))(
        *map(jnp.asarray, arrs))
    ts = [torch.from_numpy(a).requires_grad_(True) for a in arrs]
    y, hT = MambaScanFunction.apply(
        *ts, functools.partial(mamba_scan_ref, chunk=chunk),
        functools.partial(mamba_scan_backward_ref, chunk=chunk))
    ((y * torch.from_numpy(wy)).sum()
     + (hT * torch.from_numpy(wh)).sum()).backward()
    for t, ref, name in zip(ts, want, ("delta", "x", "B", "C", "A", "h0")):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(ref),
                                   rtol=1e-4, atol=1e-4, err_msg=name)


def test_scan_function_bf16_inputs_get_bf16_gradients():
    """The model hands the kernel bf16 delta and x: their gradients come
    back in bf16, the fp32 gradients rounded."""
    arrs = _scan_inputs(1, 16, 4, 2)
    f32 = [torch.from_numpy(a).requires_grad_(True) for a in arrs]
    bf = [torch.from_numpy(a).to(torch.bfloat16 if i < 2 else torch.float32)
          .requires_grad_(True) for i, a in enumerate(arrs)]
    wide = [t.detach().float().requires_grad_(True) for t in bf]
    for ts in (bf, wide):
        y, hT = MambaScanFunction.apply(*ts, mamba_scan_ref,
                                        mamba_scan_backward_ref)
        (y.sum() + hT.sum()).backward()
    for a, b in zip(bf, wide):
        assert a.grad.dtype == a.dtype
        torch.testing.assert_close(a.grad, b.grad.to(a.dtype))
    del f32


def test_chunked_scan_matches_the_per_step_scan():
    arrs = [torch.from_numpy(a) for a in _scan_inputs(2, 37, 5, 4)]
    want = mamba_scan_ref(*arrs)
    for fused in (False, True):
        got = mamba_scan_chunked(*arrs, chunk=16, fused=fused)
        for g, w in zip(got, want):
            torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-5)


# ------------------------------------------------------------ forward_train
@pytest.mark.parametrize("arch", ["stablelm-3b", "falcon-mamba-7b"])
@pytest.mark.parametrize("route", ["auto", "cuda", "reference"])
def test_forward_train_matches_value_and_grad(arch, route, monkeypatch):
    """The loss and every gradient leaf at fp32, T = 32 (ssm_chunk 16), on
    the plain routes and the card's Functions over stand-in kernels."""
    check_forward_train(arch, route, monkeypatch)


def test_forward_train_without_remat_launches_once_a_layer(monkeypatch):
    counts = standin_kernels(monkeypatch)
    _, cfg = cfgs("stablelm-3b", compute_dtype="float32",
                  remat_policy="none")
    cfg = cfg.replace(attn_impl="cuda")
    p = _requires_grad(tf.init_params(cfg, device="cpu"))
    loss, _ = tf.forward_train(p, batches(cfg, 2, 16)[1], cfg)
    loss.backward()
    assert counts["flash"] == cfg.n_layers
    assert p["blocks"]["pos0"]["attn"]["wq"].grad is not None


# ------------------------------------------------------------ train step
@pytest.mark.parametrize("accum", [1, 2])
def test_two_train_steps_match_reference(accum):
    """Two steps of ``make_train_step`` from the reference's weights and
    opt state: params and metrics after each."""
    ref_cfg, cfg = cfgs("stablelm-3b", compute_dtype="float32",
                        grad_accum=accum)
    ref_cfg = ref_cfg.replace(attn_impl="reference")
    ref_p, p = params(ref_cfg)
    ref_opt = ref_init_opt(ref_p, ref_cfg)
    opt = opt_state_from_numpy(jax.tree.map(np.asarray, ref_opt),
                               device="cpu")
    kw = dict(lr=1e-2, warmup_steps=1, total_steps=10)
    ref_step = jax.jit(ref_make_step(ref_cfg, RefOptConfig(**kw)))
    step = make_train_step(cfg, OptConfig(**kw))
    for seed in (3, 4):
        ref_b, b = batches(cfg, 4, 32, seed=seed)
        ref_p, ref_opt, ref_m = ref_step(ref_p, ref_opt, ref_b)
        p, opt, m = step(p, opt, b)
        for k in ("loss", "ce", "aux", "lr", "grad_norm"):
            np.testing.assert_allclose(float(m[k]), float(ref_m[k]),
                                       rtol=1e-5, atol=1e-7, err_msg=k)
        close_tree(p, ref_p, rtol=1e-4, atol=1e-2 * kw["lr"])
        close_grads(opt["m"], ref_opt["m"])      # a sum of gradients
        assert int(opt["step"]) == int(ref_opt["step"])
    for t in jax.tree.leaves(p):
        assert not t.requires_grad and t.grad is None


def test_train_step_accumulates_in_the_accumulator_dtype():
    """grad_accum 2 of bf16 params with an fp32 accumulator: the same
    update as one microbatch of the whole batch, within bf16 rounding."""
    _, cfg = cfgs("stablelm-3b", param_dtype="bfloat16",
                  opt_state_dtype="bfloat16", grad_accum_dtype="float32")
    seen = []

    def capture(g):
        seen.append(g)
        return g
    b = batches(cfg, 4, 16)[1]
    out = {}
    for m in (1, 2):
        p = tf.init_params(cfg, device="cpu")
        opt = init_opt_state(p, cfg)
        step = make_train_step(cfg.replace(grad_accum=m), OptConfig(),
                               grad_transform=capture)
        out[m] = step(p, opt, b)[2]
    assert seen[0]["head_w"].dtype == torch.bfloat16     # one microbatch
    assert seen[1]["head_w"].dtype == torch.float32      # accumulated
    np.testing.assert_allclose(float(out[1]["loss"]), float(out[2]["loss"]),
                               rtol=1e-2)


# ------------------------------------------------------------ compression
def test_compression_matches_reference():
    g_np = {"a": RNG.normal(size=(64,)).astype(np.float32),
            "b": {"c": RNG.normal(scale=3.0, size=(8, 8)).astype(np.float32)}}
    g = jax.tree.map(torch.from_numpy, g_np)
    ref_g = jax.tree.map(jnp.asarray, g_np)
    close_tree(comp.bf16_compress(g), ref_comp.bf16_compress(ref_g), 0, 0)
    q, s = comp.int8_quantize(g["a"])
    rq, rs = ref_comp.int8_quantize(ref_g["a"])
    assert q.dtype == torch.int8
    np.testing.assert_array_equal(q.numpy(), np.asarray(rq))
    np.testing.assert_allclose(float(s), float(rs), rtol=1e-7)
    np.testing.assert_array_equal(
        comp.int8_dequantize(q, s, torch.float32).numpy(),
        np.asarray(ref_comp.int8_dequantize(rq, rs, jnp.float32)))
    err = comp.make_error_feedback_state(g)
    ref_err = ref_comp.make_error_feedback_state(ref_g)
    for _ in range(4):
        out, err = comp.compress_tree_int8(g, err)
        ref_out, ref_err = ref_comp.compress_tree_int8(ref_g, ref_err)
        close_tree(out, ref_out, rtol=1e-6, atol=1e-7)
        close_tree(err, ref_err, rtol=1e-5, atol=1e-7)
    deq, e = comp.int8_roundtrip_with_feedback(g["a"], err["a"])
    rdeq, re = ref_comp.int8_roundtrip_with_feedback(ref_g["a"],
                                                     ref_err["a"])
    np.testing.assert_allclose(deq.numpy(), np.asarray(rdeq), rtol=1e-6,
                               atol=1e-7)
    np.testing.assert_allclose(e.numpy(), np.asarray(re), rtol=1e-5,
                               atol=1e-7)


def test_a_failing_kernel_aborts_the_train_step(monkeypatch):
    """On the card route a kernel that fails raises out of the step, with
    no plain forward in its place and the parameters untouched."""
    def broken(*a, **kw):
        raise RuntimeError("CUDA error 7 (too many resources requested)")
    monkeypatch.setattr(flash_ops, "flash_attention_cuda", broken)
    _, cfg = cfgs("stablelm-3b", compute_dtype="float32")
    cfg = cfg.replace(attn_impl="cuda")
    p = tf.init_params(cfg, device="cpu")
    before = [t.clone() for t in jax.tree.leaves(p)]
    opt = init_opt_state(p, cfg)
    with pytest.raises(RuntimeError, match="CUDA error 7"):
        make_train_step(cfg, OptConfig())(p, opt, batches(cfg, 4, 16)[1])
    assert all(torch.equal(a, b) for a, b in zip(jax.tree.leaves(p), before))
    assert int(opt["step"]) == 0
