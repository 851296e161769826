"""AI21-Jamba2-3B's stack in the port: the hybrid family without experts
(Mamba-1 mixers with weighted RMSNorms on dt, B and C, attention layers
with one KV head and no positional encoding, a head tied to the
embedding), held on the CPU against the benchmark's plain float32
reference (``portbench/reference/hybrid_lm.py``), which imports nothing of
the port.  Both take the same seeded weights (``portbench/weights.py``).

Smoke widths (d 64, 4 query heads of 16 over 1 KV head, d_inner 128,
state 8, dt rank 4, MLP 128, vocabulary 256) over two periods of four
layers, attention at ``i % 4 == 1``; the span test keeps the published
pattern whole: 28 layers, attention at ``i % 14 == 7``.

Tolerances: float32 compute, the loss within 1e-5 of the reference's and
every gradient leaf (a layer of a stacked leaf alone) within 1e-5 of its
largest reference value, elementwise: float32 sums in other orders (the
port's plain scan in chunks of 16 steps, the reference's in blocks; the
attention's softmax whole against blocks of queries), measured at 1.5e-6.
bfloat16 compute: the loss within 5e-4 (the benchmark's smoke cells'
``loss_gap``), each leaf's gradient norm within 1e-2 of the larger of the
reference's and the median leaf's (the smoke cells' ``grad_gap`` is 5e-3;
x_proj's gradient reads 5.7e-3 here, its bf16 rounding scaled by the
dt/B/C norms' 1/rms in their backward, which the smoke cells' models do
not have).
"""
import statistics
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from portbench.reference import hybrid_lm  # noqa: E402
from portbench.weights import layer_slices, make_leaves, stacked  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.models import transformer as tf  # noqa: E402
from repro_torch.obs import trace  # noqa: E402
from repro_torch.train.optimizer import OptConfig, init_opt_state  # noqa: E402
from repro_torch.train.train_step import make_train_step  # noqa: E402

SEED = 2**31 + 29
FP32_LOSS, FP32_GRAD = 1e-5, 1e-5
BF16_LOSS, BF16_GRAD = 5e-4, 1e-2
FLIPS = {"mixer_norms": False, "use_rope": True, "tie_embeddings": False}


def smoke_cj(layers=8, period=4, offset=1, compute="float32"):
    return {"as_run": {"num_hidden_layers": layers, "hidden_size": 64,
                       "num_attention_heads": 4, "num_key_value_heads": 1,
                       "head_dim": 16, "intermediate_size": 128,
                       "vocab_size": 256, "rms_norm_eps": 1e-6,
                       "attn_layer_period": period,
                       "attn_layer_offset": offset, "mamba_d_state": 8,
                       "mamba_d_conv": 4, "mamba_expand": 2,
                       "mamba_dt_rank": 4, "dt_bias_init": -4.6},
            "dtypes": {"param": "float32", "compute": compute,
                       "opt_state": "float32", "grad_accum": "float32"}}


def port_cfg(cj, **over):
    return configs.get_config("jamba-1.5-large-398b").replace(
        **hybrid_lm.port_fields(cj)).replace(**over)


def _flat(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, f"{prefix}{k}.")
        else:
            yield prefix + k, v


def _assign(tree, path, val):
    *parents, last = path.split(".")
    for p in parents:
        tree = tree.setdefault(p, {})
    tree[last] = val


def weights(cj, cfg, seed=SEED):
    """(the port's tree, the reference's params) from one seed; a leaf the
    port has and the reference lacks (``head_w`` untied) is drawn from
    N(0, 0.02), one the reference has and the port lacks is left out."""
    want = dict(_flat(tf.param_shapes(cfg)))
    tree, ref = {}, {}
    for path, x in make_leaves(hybrid_lm.leaf_specs(cj), seed, "cpu"):
        ref[path] = ([t.clone().requires_grad_(True)
                      for _, t in layer_slices(path, x)] if stacked(path)
                     else x.clone().requires_grad_(True))
        if path in want:
            _assign(tree, path, x.clone().requires_grad_(True))
            del want[path]
    gen = torch.Generator().manual_seed(seed)
    for path, meta in want.items():
        _assign(tree, path, (torch.randn(meta.shape, generator=gen) * 0.02)
                .requires_grad_(True))
    return tree, ref


def tokens(cj, rows=2, seq=40, seed=SEED):
    g = torch.Generator().manual_seed(seed)
    return torch.randint(0, cj["as_run"]["vocab_size"], (rows, seq),
                         generator=g)


def run_both(cj, cfg, tok):
    """(port loss, {leaf: gradient}, reference loss, {leaf: gradient}), a
    layer of a stacked leaf a leaf of its own."""
    tree, ref = weights(cj, cfg)
    loss, _ = tf.forward_train(tree, {"tokens": tok}, cfg)
    loss.backward()
    ref_loss = hybrid_lm.loss(ref, tok, cj, "fp32")
    ref_loss.backward()
    pg = {n: t for path, x in _flat(tree)
          for n, t in layer_slices(path, x.grad)}
    rg = {}
    for path, x in ref.items():
        for i, t in enumerate(x if isinstance(x, list) else [x]):
            rg[f"{path}[{i}]" if isinstance(x, list) else path] = t.grad
    return float(loss.detach()), pg, float(ref_loss.detach()), rg


def fp32_gaps(cj, cfg, tok):
    """(the loss's relative gap, over the leaves both sides have the worst
    leaf's largest elementwise gap over its largest reference value, the
    leaves one side alone has)."""
    loss, pg, ref_loss, rg = run_both(cj, cfg, tok)
    grad = max(float((pg[n] - g).abs().max() / g.abs().max())
               for n, g in rg.items() if n in pg)
    return abs(loss - ref_loss) / abs(ref_loss), grad, set(pg) ^ set(rg)


def test_fp32_loss_and_every_gradient_match_the_reference():
    cj = smoke_cj()
    loss, grad, alone = fp32_gaps(
        cj, port_cfg(cj, compute_dtype="float32"), tokens(cj))
    assert loss <= FP32_LOSS and grad <= FP32_GRAD, (loss, grad)
    assert not alone


def test_bf16_loss_and_gradient_norms_match_the_reference():
    cj = smoke_cj(compute="bfloat16")
    loss, pg, ref_loss, rg = run_both(cj, port_cfg(cj), tokens(cj))
    assert set(pg) == set(rg)
    pn = {n: float(g.norm()) for n, g in pg.items()}
    rn = {n: float(g.norm()) for n, g in rg.items()}
    med = statistics.median(rn.values())
    grad = max(abs(pn[n] - rn[n]) / max(rn[n], med) for n in rn)
    assert abs(loss - ref_loss) / abs(ref_loss) <= BF16_LOSS
    assert grad <= BF16_GRAD, grad


@pytest.mark.parametrize("flag", sorted(FLIPS))
def test_each_jamba_flag_matters(flag):
    """The comparison fails with the flag flipped in the port alone, by
    far on the leaves both sides have."""
    cj = smoke_cj()
    cfg = port_cfg(cj, compute_dtype="float32", **{flag: FLIPS[flag]})
    loss, grad, _ = fp32_gaps(cj, cfg, tokens(cj))
    assert grad > 100 * FP32_GRAD, (loss, grad)


@pytest.mark.parametrize("compute", ["float32", "bfloat16"])
def test_per_layer_checkpoint_is_bitwise_no_checkpoint(compute):
    cj = smoke_cj(compute=compute)
    out = {}
    for remat in ("full", "none"):
        cfg = port_cfg(cj, remat_policy=remat)
        tree, _ = weights(cj, cfg)
        loss, _ = tf.forward_train(tree, {"tokens": tokens(cj)}, cfg)
        loss.backward()
        out[remat] = (loss.detach(), {p: x.grad for p, x in _flat(tree)})
    (lf, gf), (ln, gn) = out["full"], out["none"]
    assert torch.equal(lf, ln)
    assert gf.keys() == gn.keys()
    assert all(torch.equal(gf[p], gn[p]) for p in gf)


@pytest.mark.parametrize("flags", [{}, {"mixer_norms": False},
                                   {"tie_embeddings": False},
                                   {"mixer_norms": False,
                                    "tie_embeddings": False}])
def test_param_count_agrees_with_the_leaves(flags):
    for cj in (smoke_cj(), smoke_cj(layers=28, period=14, offset=7)):
        cfg = port_cfg(cj, **flags)
        assert cfg.param_count() == tf.param_count(cfg)
    cfg = port_cfg(smoke_cj())
    shapes = dict(_flat(tf.param_shapes(cfg)))
    assert "head_w" not in shapes
    assert shapes["blocks.pos0.mamba.dt_norm"].shape == (2, 4)
    assert shapes["blocks.pos0.mamba.b_norm"].shape == (2, 8)
    assert "mamba" not in tf.param_shapes(cfg)["blocks"]["pos1"]


def test_full_size_counts_match_the_published_model():
    """At the published widths: 3.03B parameters, the reference's count
    of what a token runs through, 2 attention and 26 Mamba layers."""
    cj = {"as_run": {"num_hidden_layers": 28, "hidden_size": 2560,
                     "num_attention_heads": 20, "num_key_value_heads": 1,
                     "head_dim": 128, "intermediate_size": 8192,
                     "vocab_size": 65536, "rms_norm_eps": 1e-6,
                     "attn_layer_period": 14, "attn_layer_offset": 7,
                     "mamba_d_state": 16, "mamba_d_conv": 4,
                     "mamba_expand": 2, "mamba_dt_rank": 160,
                     "dt_bias_init": -4.6},
          "dtypes": smoke_cj()["dtypes"]}
    cfg = port_cfg(cj)
    assert cfg.param_count() == tf.param_count(cfg) \
        == hybrid_lm.params_per_token(cj)
    assert 3.02e9 < cfg.param_count() < 3.04e9
    kinds = [cfg.layer_kind(i) for i in range(cfg.n_layers)]
    assert kinds == hybrid_lm.kinds(cj)
    assert (kinds.count("attn"), kinds.count("mamba")) == (2, 26)
    assert [i for i, k in enumerate(kinds) if k == "attn"] == [7, 21]
    assert (cfg.dt_rank, cfg.d_inner, cfg.hd, tf.period(cfg)) == \
        (160, 5120, 128, 14)


def test_check_supported_lets_the_expert_free_hybrid_onto_the_card():
    cuda = torch.device("cuda", 0)
    tf.check_supported(port_cfg(smoke_cj()), cuda)
    large = configs.get_config("jamba-1.5-large-398b", smoke=True)
    with pytest.raises(NotImplementedError, match="77 GB.*ROADMAP"):
        tf.check_supported(large, cuda)


def _within(inner, outer):
    return (outer["ts"] <= inner["ts"]
            and inner["ts"] + inner["dur"] <= outer["ts"] + outer["dur"])


def test_layer_spans_and_counters_of_one_step():
    """One traced step at the published depth and pattern: each layer's
    forward, recompute and backward once, in the period's order of kinds,
    the recompute inside the backward, the backwards last layer first,
    and ``attn_layers`` / ``mamba_layers`` at 2 / 26."""
    cj = smoke_cj(layers=28, period=14, offset=7)
    cfg = port_cfg(cj, grad_accum=1)
    params = tf.init_params(cfg, seed=0, device="cpu")
    step = make_train_step(cfg, OptConfig())
    tr = trace.Tracer(measuring=True)
    with trace.trace_scope(tr):
        step(params, init_opt_state(params, cfg),
             {"tokens": tokens(cj, rows=1, seq=24)})
    layers = [e for e in tr.events if e["name"] == "model.layer"]
    by = {ph: [e for e in layers if e["args"]["phase"] == ph]
          for ph in ("forward", "recompute", "backward")}
    kinds = [cfg.layer_kind(i) for i in range(28)]
    assert len(layers) == 3 * 28
    assert [e["args"]["layer"] for e in by["forward"]] == list(range(28))
    for ph in ("recompute", "backward"):
        assert sorted(e["args"]["layer"] for e in by[ph]) == list(range(28))
    assert [e["args"]["layer"] for e in sorted(
        by["backward"], key=lambda e: e["ts"])] == list(range(27, -1, -1))
    for e in layers:
        assert e["cat"] == "model" and e["args"]["step"] == 0
        assert e["args"]["kind"] == kinds[e["args"]["layer"]]
    (fwd,) = [e for e in tr.events if e["name"] == "model.forward"]
    (bwd,) = [e for e in tr.events if e["name"] == "model.backward"]
    back = {e["args"]["layer"]: e for e in by["backward"]}
    assert all(_within(e, fwd) for e in by["forward"])
    assert all(_within(e, bwd) for e in by["backward"])
    assert all(_within(e, back[e["args"]["layer"]]) for e in by["recompute"])
    c = tr.metrics.snapshot()["counters"]
    assert (c["attn_layers"], c["mamba_layers"]) == (2, 26)
