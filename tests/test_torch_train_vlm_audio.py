"""Training of the vlm and audio families (llama-3.2-vision-11b's and
hubert-xlarge's smoke configs) against the JAX reference, on the CPU.

``make_train_step``: two steps of ``grad_accum`` 2 from the reference's
weights and optimizer state against the reference's jitted step, as
``test_torch_train.py`` holds stablelm (losses and the global gradient norm
within rtol 1e-5; parameters within rtol 1e-4 / atol 1e-2 * lr; the first
moments as ``_torch_lm.close_grads`` holds gradients).  The vlm's batch
carries vision embeddings and its cross-attention gates are set nonzero
from a numpy seed (at zero they would hide the branch and zero its
weights' gradients); the encoder's carries frames and ``labels`` at every
position.

``launch.train.train_loop``: three steps of each smoke config on the
card's route (``attn_impl="cuda"``: the kernels' autograd Functions over
stand-in kernels, the plain versions, each call counted): finite losses
that fall, and each forward launched twice a microbatch (forward and the
period's remat recompute) a self-attention layer and a cross-attention
layer, each backward once.  Its own init leaves the gates at zero, as the
reference's does.
"""
import jax
import numpy as np
import pytest

from _torch_lm import (cfgs, close_grads, close_tree, params,
                       standin_kernels, train_batches)
from repro.train.optimizer import OptConfig as RefOptConfig
from repro.train.optimizer import init_opt_state as ref_init_opt
from repro.train.train_step import make_train_step as ref_make_step
from repro_torch.launch.train import train_loop
from repro_torch.models.convert import opt_state_from_numpy
from repro_torch.train.optimizer import OptConfig
from repro_torch.train.train_step import make_train_step

ARCHS = ["llama-3.2-vision-11b", "hubert-xlarge"]


@pytest.mark.parametrize("arch", ARCHS)
def test_two_train_steps_match_reference(arch):
    ref_cfg, cfg = cfgs(arch, compute_dtype="float32", grad_accum=2)
    ref_cfg = ref_cfg.replace(attn_impl="reference")
    ref_p, p = params(ref_cfg)
    ref_opt = ref_init_opt(ref_p, ref_cfg)
    opt = opt_state_from_numpy(jax.tree.map(np.asarray, ref_opt),
                               device="cpu")
    kw = dict(lr=1e-2, warmup_steps=1, total_steps=10)
    ref_step = jax.jit(ref_make_step(ref_cfg, RefOptConfig(**kw)))
    step = make_train_step(cfg, OptConfig(**kw))
    for seed in (3, 4):
        ref_b, b = train_batches(cfg, 4, 32, seed=seed)
        ref_p, ref_opt, ref_m = ref_step(ref_p, ref_opt, ref_b)
        p, opt, m = step(p, opt, b)
        for k in ("loss", "ce", "aux", "lr", "grad_norm"):
            np.testing.assert_allclose(float(m[k]), float(ref_m[k]),
                                       rtol=1e-5, atol=1e-7, err_msg=k)
        close_tree(p, ref_p, dict(rtol=1e-4, atol=1e-2 * kw["lr"]))
        close_grads(opt["m"], ref_opt["m"])
        assert int(opt["step"]) == int(ref_opt["step"])
    if cfg.family == "vlm":
        # the branch trained: its gate and weights moved off the init
        _, p0 = params(ref_cfg)
        for sub, sub0 in zip(p["blocks"].values(), p0["blocks"].values()):
            for name, t in sub.get("xattn", {}).items():
                assert not bool((t == sub0["xattn"][name]).all()), name


@pytest.mark.parametrize("arch", ARCHS)
def test_train_loop_on_the_card_route(arch, monkeypatch):
    counts = standin_kernels(monkeypatch)
    cfg = cfgs(arch)[1].replace(attn_impl="cuda")
    steps, accum = 3, cfg.grad_accum
    res = train_loop(cfg, steps=steps, batch=4, seq_len=32, log_every=100,
                     device="cpu")
    losses = res["losses"]
    assert len(losses) == steps and all(np.isfinite(losses))
    assert all(b < a for a, b in zip(losses, losses[1:])), losses
    layers = range(cfg.n_layers)
    calls = cfg.n_layers + sum(cfg.has_cross_attn(i) for i in layers)
    assert counts["flash"] == steps * accum * 2 * calls
    assert counts["flash_bwd"] == steps * accum * calls
    assert counts["scan"] == counts["scan_bwd"] == 0
    assert (counts["flash"], counts["flash_bwd"]) == {
        "vlm": (72, 36), "audio": (24, 12)}[cfg.family]
