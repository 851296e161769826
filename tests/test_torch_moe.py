"""The port's MoE FFN (``repro_torch.models.moe``) against the JAX
reference's (``repro.models.moe``), on the smoke configs of the moe family
with weights and inputs made from a numpy seed.

Both run in plain code (the reference computes the block outside any Pallas
kernel).  Beside ``out`` and ``aux``, the router's decisions must be equal:
the top-k experts of every token, padded ones included, and which slots
kept a capacity slot.  The reference's are read where it makes them, by
wrapping ``jax.lax.top_k`` and ``jax.nn.one_hot`` for the call.
Tolerances: float32 within rtol 1e-4 / atol 1e-4; bfloat16 within rtol
5e-2 / atol 5e-2 (the frameworks round the expert products to bf16 at
different points).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as ref_configs
from repro.models import moe as ref_moe
from repro.models.layers import NO_RULES as REF_RULES
from repro_torch import configs
from repro_torch.models import moe
from repro_torch.models import moe_block
from repro_torch.models.convert import params_from_numpy
from repro_torch.models.layers import NO_RULES

FP32 = dict(rtol=1e-4, atol=1e-4)
BF16 = dict(rtol=5e-2, atol=5e-2)

# (arch, config overrides, batch, seq): the smoke configs group 32 tokens
CASES = {
    "fp32": ("mixtral-8x7b", dict(compute_dtype="float32"), 2, 32),
    "bf16": ("mixtral-8x7b", dict(compute_dtype="bfloat16"), 2, 32),
    "grok fp32": ("grok-1-314b", dict(compute_dtype="float32"), 2, 32),
    "padded": ("mixtral-8x7b", dict(compute_dtype="float32"), 2, 37),
    "drops": ("mixtral-8x7b", dict(compute_dtype="float32",
                                   capacity_factor=0.25), 2, 40),
    "gelu": ("grok-1-314b", dict(compute_dtype="float32", mlp_kind="gelu"),
             2, 37),
    "top-1": ("mixtral-8x7b", dict(compute_dtype="float32",
                                   experts_per_token=1), 3, 24),
    "one token": ("mixtral-8x7b", dict(compute_dtype="float32"), 1, 1),
}


def _weights(cfg, seed):
    """Router logits of a few units, so the top-k picks are clear; expert
    weights scaled to keep the output near 1."""
    rng = np.random.default_rng(seed)
    d, E, f = cfg.d_model, cfg.n_experts, cfg.d_ff
    return {"router": rng.normal(0, 1.0 / np.sqrt(d), (d, E)),
            "wg": rng.normal(0, 1.0 / np.sqrt(d), (E, d, f)),
            "wu": rng.normal(0, 1.0 / np.sqrt(d), (E, d, f)),
            "wd": rng.normal(0, 1.0 / np.sqrt(f), (E, f, d))}


def _reference(monkeypatch, ref_cfg, x, w, C):
    """The reference's (out, aux, topi, keep), with topi [Gn, Gs, k] and
    keep [Gn, Gs, k] read from its own top_k and capacity one_hot calls."""
    seen = {"pos": []}
    top_k, one_hot = jax.lax.top_k, jax.nn.one_hot

    def spy_top_k(a, k):
        v, i = top_k(a, k)
        seen["topi"] = np.asarray(i)
        return v, i

    def spy_one_hot(a, n, **kw):
        if n == C:                          # where(keep, pos, -1) of a slot
            seen["pos"].append(np.asarray(a))
        return one_hot(a, n, **kw)

    monkeypatch.setattr(jax.lax, "top_k", spy_top_k)
    monkeypatch.setattr(jax.nn, "one_hot", spy_one_hot)
    cdt = jnp.dtype(ref_cfg.compute_dtype)
    out, aux = ref_moe.moe_block(jnp.asarray(x, cdt),
                                 {k: jnp.asarray(v, jnp.float32)
                                  for k, v in w.items()}, ref_cfg, REF_RULES)
    monkeypatch.undo()
    keep = np.stack([(p >= 0).any(-1) for p in seen["pos"]], -1)
    return np.asarray(out, np.float32), float(aux), seen["topi"], keep


def _port(monkeypatch, cfg, x, w):
    seen = {}
    real = moe.route

    def spy(*a, **kw):
        seen["r"] = real(*a, **kw)
        return seen["r"]

    monkeypatch.setattr(moe, "route", spy)
    out, aux = moe_block(torch.from_numpy(x).to(getattr(torch,
                                                        cfg.compute_dtype)),
                         params_from_numpy(w, device="cpu"), cfg, NO_RULES)
    monkeypatch.undo()
    return out, aux, seen["r"]


@pytest.mark.parametrize("case", list(CASES))
def test_moe_block_matches_reference(case, monkeypatch):
    arch, kw, B, S = CASES[case]
    ref_cfg = ref_configs.get_config(arch, smoke=True).replace(**kw)
    cfg = configs.get_config(arch, smoke=True).replace(**kw)
    w = {k: v.astype(np.float32) for k, v in _weights(cfg, 1).items()}
    x = np.random.default_rng(2).normal(size=(B, S, cfg.d_model)).astype(
        np.float32)
    T = B * S
    Gs = min(cfg.moe_group_size, T)
    k, E = cfg.experts_per_token, cfg.n_experts
    C = moe._capacity(Gs, k, E, cfg.capacity_factor)
    assert C != E                   # tells the capacity one_hot from E's
    want, want_aux, want_topi, want_keep = _reference(monkeypatch, ref_cfg,
                                                      x, w, C)
    got, aux, r = _port(monkeypatch, cfg, x, w)

    assert got.shape == (B, S, cfg.d_model)
    assert got.dtype == getattr(torch, cfg.compute_dtype)
    np.testing.assert_array_equal(r.topi.numpy(), want_topi)
    np.testing.assert_array_equal(r.keep.numpy(), want_keep)
    assert r.combine.shape[-1] == C
    tol = BF16 if cfg.compute_dtype == "bfloat16" else FP32
    np.testing.assert_allclose(got.float().numpy(), want, **tol)
    np.testing.assert_allclose(float(aux), want_aux, **tol)

    valid = r.keep.new_zeros(r.keep.shape[:2]).flatten()
    valid[:T] = True
    kept = r.keep[valid.view(r.keep.shape[:2])]
    if case == "drops":
        assert not bool(kept.all())             # some slots were dropped
        assert int(r.load.max()) > C
    elif case != "top-1":
        assert bool(kept.all()) and int(r.load.max()) <= C
    assert not bool(r.keep[~valid.view(r.keep.shape[:2])].any())


@pytest.mark.parametrize("n", [1, 7, 24, 32, 100, 1024, 4096])
@pytest.mark.parametrize("k,E,factor", [(2, 8, 1.25), (1, 4, 1.0),
                                        (2, 4, 0.25), (2, 16, 2.0)])
def test_capacity_matches_reference(n, k, E, factor):
    assert moe._capacity(n, k, E, factor) == ref_moe._capacity(n, k, E,
                                                               factor)


def test_router_ties_go_to_the_lower_expert():
    """jax.lax.top_k breaks ties toward the lower index; the port's stable
    sort does the same (a padded token's zero input ties every expert)."""
    x = torch.zeros((1, 3, 8))
    x[0, 1, 0] = 1.0
    router = torch.zeros((8, 4))
    router[0] = torch.tensor([0.0, 1.0, 0.0, 1.0])
    r = moe.route(x, torch.ones((1, 3), dtype=torch.bool), router, k=2,
                  capacity=8)
    want = jax.lax.top_k(jnp.asarray(r.probs.numpy()), 2)[1]
    np.testing.assert_array_equal(r.topi.numpy(), np.asarray(want))
    assert r.topi[0, 0].tolist() == [0, 1] and r.topi[0, 1].tolist() == [1, 3]


def test_dropped_slots_add_nothing():
    """A slot over capacity has no combine weight (the reference's one_hot
    of an index past C is a zero row), and a token whose slots all drop
    gets a zero output."""
    cfg = configs.get_config("mixtral-8x7b", smoke=True).replace(
        compute_dtype="float32", experts_per_token=1, capacity_factor=0.01,
        moe_group_size=16)
    w = params_from_numpy({k: v.astype(np.float32)
                           for k, v in _weights(cfg, 3).items()},
                          device="cpu")
    w["router"] = torch.zeros_like(w["router"])     # every token to expert 0
    x = torch.from_numpy(np.random.default_rng(4).normal(
        size=(1, 16, cfg.d_model)).astype(np.float32))
    out, _ = moe_block(x, w, cfg, NO_RULES)
    assert moe._capacity(16, 1, cfg.n_experts, 0.01) == 8
    assert bool((out[0, :8].abs().sum(-1) > 0).all())
    assert bool((out[0, 8:] == 0).all())

