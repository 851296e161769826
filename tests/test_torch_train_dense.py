"""Training of the configs the card trains beside stablelm-3b and falcon:
``forward_train`` of qwen2.5-32b (QKV bias), qwen2-72b (QKV bias, a bf16
gradient accumulator), granite-20b (MQA: one kv head; a gelu MLP) and
grok-1-314b (MoE, the tanh softcap in the attention) against
``jax.value_and_grad`` of the reference's, at fp32 on the smoke configs,
as ``_torch_lm.check_forward_train`` holds them (loss within rtol 1e-5;
each gradient leaf within 1e-4 of its largest reference value plus rtol
1e-3), on the plain routes and the card's Functions over stand-in kernels
('cuda'); qwen2.5-32b also over query chunks of 8 on the plain route.

Then two steps of ``make_train_step`` against the reference's jitted step
from the reference's weights and opt state, where the step keeps state
in bf16: qwen2-smoke's bf16 accumulator over 2 microbatches, and
grok1-smoke with bf16 parameters and AdamW moments (and so a bf16
accumulator).  A bf16 value that the two frameworks round from fp32 sums
taken in other orders may land one bf16 step apart; the accumulated
gradient rounds three times (each microbatch's cast, the sum, the
division by 2).  So bf16 state (grok's parameters, both configs'
moments) within rtol 3 x 2^-8 = 1.2e-2 plus one bf16 step of the leaf's
largest value (2^-8 of it), and the gradient norm within 1.2e-2;
qwen2's fp32 parameters as ``test_torch_train.py`` holds them (rtol
1e-4, 1e-2 x lr); losses within rtol 1e-5.

The embedding's gradient (``transformer.EmbedRows``) sums repeated ids
in fp32 and rounds to the table's dtype once, as the reference's: a bf16
table's gradient within one bf16 step of ``jax.grad`` of the reference's
cast-then-gather, a token repeated 64 times included.

Last, AdamW and the global norm taken in pieces of at most
``optimizer.PIECE`` elements (so that a 1.25e9-element leaf's fp32
temporaries fit beside the state on one card; AdamW a layer of a stacked
leaf at a time) give the bits of one whole-leaf pass; the two train
steps above take that route too.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_lm import batches, cfgs, check_forward_train, params
from repro.train.optimizer import OptConfig as RefOptConfig
from repro.train.optimizer import init_opt_state as ref_init_opt
from repro.train.train_step import make_train_step as ref_make_step
from repro_torch.models.convert import opt_state_from_numpy
from repro_torch.models.transformer import EmbedRows
from repro_torch.train import optimizer
from repro_torch.train.optimizer import OptConfig, adamw_update, global_norm
from repro_torch.train.train_step import make_train_step

ARCHS = ["qwen2.5-32b", "qwen2-72b", "granite-20b", "grok-1-314b"]
#: bf16 state against the reference's (the module docstring): rtol, and
#: the share of the leaf's largest value
BF16_RTOL, BF16_STEP = 1.2e-2, 2.0 ** -8


def _np(t):
    return t.detach().float().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t, np.float32)


def close_tree(got, want, rtol, atol=0.0, step=0.0, path=""):
    """Leaf by leaf within ``rtol`` plus ``atol`` plus ``step`` of the
    leaf's largest reference value."""
    if isinstance(want, dict):
        assert set(got) == set(want), path
        for k in want:
            close_tree(got[k], want[k], rtol, atol, step, f"{path}.{k}")
        return
    w = _np(want)
    np.testing.assert_allclose(_np(got), w, rtol=rtol,
                               atol=atol + step * float(np.abs(w).max()),
                               err_msg=path)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("route", ["auto", "cuda", "reference"])
def test_forward_train_matches_value_and_grad(arch, route, monkeypatch):
    mets = check_forward_train(arch, route, monkeypatch)
    if arch == "grok-1-314b":
        assert mets["aux"].item() > 0.5      # E * sum f_e P_e, about 1 a layer


def test_forward_train_over_query_chunks_matches_value_and_grad(
        monkeypatch):
    check_forward_train("qwen2.5-32b", "reference", monkeypatch,
                        attn_q_chunk=8)


@pytest.mark.parametrize("arch,kw", [
    pytest.param("qwen2-72b", {}, id="qwen2-72b-bf16-accumulator"),
    pytest.param("grok-1-314b", dict(param_dtype="bfloat16",
                                     opt_state_dtype="bfloat16"),
                 id="grok-1-314b-bf16-state")])
def test_two_bf16_state_train_steps_match_reference(arch, kw, monkeypatch):
    """Two steps from the reference's weights and opt state: metrics,
    parameters and both moments after each, the state in its dtypes.
    AdamW and the global norm run in pieces (PIECE 1000: every matrix, a
    layer of the stacked experts in 33 flat runs, head_w in 17), the
    route a full-width leaf takes on the card."""
    monkeypatch.setattr(optimizer, "PIECE", 1000)
    ref_cfg, cfg = cfgs(arch, compute_dtype="float32", **kw)
    assert cfg.grad_accum == 2
    acc = cfg.grad_accum_dtype or cfg.opt_state_dtype
    assert acc == "bfloat16"
    ref_cfg = ref_cfg.replace(attn_impl="reference")
    ref_p, p = params(ref_cfg)
    ref_opt = ref_init_opt(ref_p, ref_cfg)
    opt = opt_state_from_numpy(jax.tree.map(np.asarray, ref_opt),
                               device="cpu")
    seen = []

    def capture(g):
        seen.append(g["head_w"].dtype)
        return g
    kw = dict(lr=1e-2, warmup_steps=1, total_steps=10)
    ref_step = jax.jit(ref_make_step(ref_cfg, RefOptConfig(**kw)))
    step = make_train_step(cfg, OptConfig(**kw), grad_transform=capture)
    fp32_params = cfg.param_dtype == "float32"
    split = [n for n in ("head_w", "tok_embed")
             if len(list(optimizer._pieces(p[n]))) > 1]
    assert split == ["head_w", "tok_embed"]
    for seed in (3, 4):
        ref_b, b = batches(cfg, 4, 32, seed=seed)
        ref_p, ref_opt, ref_m = ref_step(ref_p, ref_opt, ref_b)
        p, opt, m = step(p, opt, b)
        for k in ("loss", "ce", "aux"):
            np.testing.assert_allclose(float(m[k]), float(ref_m[k]),
                                       rtol=1e-5, atol=1e-7, err_msg=k)
        np.testing.assert_allclose(float(m["lr"]), float(ref_m["lr"]),
                                   rtol=1e-6)
        np.testing.assert_allclose(float(m["grad_norm"]),
                                   float(ref_m["grad_norm"]), rtol=BF16_RTOL)
        if fp32_params:
            close_tree(p, ref_p, rtol=1e-4, atol=1e-2 * kw["lr"])
        else:
            close_tree(p, ref_p, rtol=BF16_RTOL, step=BF16_STEP)
        for name in ("m", "v"):
            close_tree(opt[name], ref_opt[name], rtol=BF16_RTOL,
                       step=BF16_STEP)
        assert int(opt["step"]) == int(ref_opt["step"])
    assert seen == [torch.bfloat16] * 2
    leaf = p["blocks"]["pos0"]["attn"]["wq"]
    assert leaf.dtype == getattr(torch, cfg.param_dtype)
    assert opt["m"]["head_w"].dtype == getattr(torch, cfg.opt_state_dtype)


def test_embedding_gradient_sums_repeats_in_fp32():
    """A bf16 table, 64 repeats of one id among others, fp32 rows out:
    the rows equal the table's, and the table's gradient is within one
    bf16 step of the reference's (cast then gather: an fp32 sum, rounded
    once)."""
    rng = np.random.default_rng(7)
    table = rng.normal(scale=0.02, size=(32, 16)).astype(np.float32)
    idx = np.concatenate([np.full(64, 5), rng.integers(0, 32, 64)]
                         ).reshape(4, 32).astype(np.int32)
    g = rng.normal(size=(4, 32, 16)).astype(np.float32)
    want = jax.grad(lambda t: (t.astype(jnp.float32)[idx] * g).sum())(
        jnp.asarray(table, jnp.bfloat16))
    tt = torch.from_numpy(table).to(torch.bfloat16).requires_grad_(True)
    rows = EmbedRows.apply(tt, torch.from_numpy(idx).long(), torch.float32)
    assert rows.dtype == torch.float32
    assert torch.equal(rows, tt.detach()[torch.from_numpy(idx).long()]
                       .float())
    rows.backward(torch.from_numpy(g))
    assert tt.grad.dtype == torch.bfloat16
    close_tree(tt.grad, want, rtol=BF16_STEP)


# ------------------------------------------------- AdamW a piece at a time
def _state(seed, dtype):
    """Parameters, gradients and moments of every kind the model has (a
    stacked matrix, a stacked norm, a matrix, a vector), the moments
    after a few steps so none is zero; one gradient leaf transposed (not
    contiguous)."""
    rng = np.random.default_rng(seed)
    shapes = {"blocks": {"pos0": {"w": (3, 5, 4), "ln": (3, 4)}},
              "head_w": (6, 7), "final_ln": (9,)}

    def draw(scale):
        return jax.tree.map(
            lambda s: torch.from_numpy(rng.normal(scale=scale, size=s)
                                       .astype(np.float32)).to(dtype),
            shapes, is_leaf=lambda s: isinstance(s, tuple))
    p, g = draw(1.0), draw(0.3)
    g["head_w"] = g["head_w"].t().contiguous().t()      # column-major
    opt = {"m": draw(0.1), "v": jax.tree.map(torch.abs, draw(0.01)),
           "step": torch.tensor(3, dtype=torch.int32)}
    return p, g, opt


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_adamw_in_pieces_gives_the_whole_update(dtype, monkeypatch):
    """PIECE 7 cuts every leaf into pieces (the stacked matrix a layer
    at a time, each layer in flat runs; the column-major gradient's leaf
    by rows; the 9-element norm in two runs): the
    same parameters and moments bit for bit, the same global norm within
    fp32 rounding of the sums' order."""
    ocfg = OptConfig(lr=1e-2, warmup_steps=2, total_steps=10)
    _, cfg = cfgs("stablelm-3b", param_dtype="float32")
    out = {}
    for piece in (optimizer.PIECE, 7):
        monkeypatch.setattr(optimizer, "PIECE", piece)
        p, g, opt = _state(5, dtype)
        stats = adamw_update(g, p, opt, ocfg, cfg)
        out[piece] = (p, opt, float(stats["grad_norm"]),
                      float(global_norm(g)))
    (p1, o1, n1, g1), (p2, o2, n2, g2) = out.values()
    for a, b in zip(jax.tree.leaves((p1, o1)), jax.tree.leaves((p2, o2))):
        assert a.dtype == b.dtype and torch.equal(a, b)
    np.testing.assert_allclose(n2, n1, rtol=1e-6)
    np.testing.assert_allclose(g2, g1, rtol=1e-6)


def test_pieces_cover_each_leaf_once(monkeypatch):
    """Aligned pieces of at most PIECE elements that cover every element
    once: flat runs of contiguous tensors, rows where one is not; by
    layer, no piece spans two layers of a stacked leaf."""
    monkeypatch.setattr(optimizer, "PIECE", 6)
    a = torch.arange(40.).reshape(2, 4, 5)
    b = a.transpose(1, 2).contiguous().transpose(1, 2)    # same values
    flat = list(optimizer._pieces(a, a.clone()))
    assert [x.numel() for x, _ in flat] == [6] * 6 + [4]
    layers = list(optimizer._pieces(a, a.clone(), by_layer=True))
    assert [x.numel() for x, _ in layers] == [6, 6, 6, 2] * 2
    assert torch.equal(torch.cat([x.reshape(-1) for x, _ in layers]),
                       a.reshape(-1))
    rows = list(optimizer._pieces(a, b))
    assert all(x.numel() <= 6 and torch.equal(x, y) for x, y in rows)
    assert torch.equal(torch.cat([x.reshape(-1) for x, _ in rows]),
                       a.reshape(-1))
    assert [t.numel() for t, in optimizer._pieces(a[0, 0])] == [5]
    assert float(optimizer.square_sum(a)) == float((a * a).sum())
    monkeypatch.setattr(optimizer, "PIECE", 20)
    assert [x.shape for x, in optimizer._pieces(a, by_layer=True)] == \
        [(4, 5)] * 2                       # one layer each, as before
    assert [x.shape for x, in optimizer._pieces(a)] == [(20,)] * 2
