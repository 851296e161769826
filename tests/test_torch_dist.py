"""The port's sharded steps (``sharded_train_step``,
``sharded_serve_steps``, ``gpipe_spmd``, ``cross_pod_psum_int8``) on 4
``gloo`` ranks of the CPU against the port's unsharded steps on the same
seeded weights and inputs.

One spawn runs every sharded case (``_torch_dist_jobs.port_suite``, about
25 s here) while this process computes the unsharded ones; each
comparison is its own test.  Mesh (data 2, model 2) with the real
``make_rules``; the smoke configs in fp32.  Tolerances: ``loss``, ``ce``,
``aux``, ``lr`` and ``grad_norm`` within rtol 1e-5 (fp32 sums split over
ranks, in other orders); each step's gradients and the first moments by
``_torch_lm.close_grads``; params within rtol 1e-4 / atol 1e-2 * lr (as
``test_torch_train.py`` holds two steps against the reference), with
AdamW's eps at 1e-6 (``_torch_dist_jobs.OCFG`` says why); logits within 1e-5; the pipeline
within 1e-5 of the sequential composition; the int8 all-reduce equal to
the reference's semantics simulated in numpy.
"""
import numpy as np
import pytest
import torch

import _torch_dist_jobs as J
from _torch_dist import start_ranks
from _torch_lm import close_grads
from repro_torch.models import transformer as tf
from repro_torch.train.compression import int8_quantize
from repro_torch.train.optimizer import OptConfig, init_opt_state
from repro_torch.train.train_step import make_train_step

METRICS = ("loss", "ce", "aux", "lr", "grad_norm")


def _unsharded_train(arch, accum, kw):
    cfg = J.train_cfg(arch, accum, **kw)
    p = tf.init_params(cfg, device="cpu")
    opt = init_opt_state(p, cfg)
    grads = []
    step = make_train_step(cfg, OptConfig(**J.OCFG),
                           grad_transform=lambda g: J.keep(grads, g))
    mets = []
    for seed in (3, 4):
        b = {"tokens": torch.from_numpy(J.train_tokens(seed, cfg))}
        p, opt, m = step(p, opt, b)
        mets.append({k: float(v) for k, v in m.items()})
    return {"metrics": mets, "params": J.to_np(p), "m": J.to_np(opt["m"]),
            "grads": grads, "step": int(opt["step"])}


@torch.no_grad()
def _unsharded_serve(arch, kw):
    cfg = J.serve_cfg(arch, **kw)
    p = tf.init_params(cfg, device="cpu")
    toks = torch.from_numpy(J.serve_tokens(cfg))
    lg, cache = tf.forward_prefill(p, {"tokens": toks[:, :J.PROMPT]}, cfg)
    out = [lg.numpy()]
    cache = tf.grow_cache(cache, cfg, toks.shape[1])
    for t in range(J.PROMPT, toks.shape[1]):
        lg, cache = tf.decode_step(p, cache, {"tokens": toks[:, t:t + 1]},
                                   cfg)
        out.append(lg.numpy())
    return out


@torch.no_grad()
def _unsharded_prefill1():
    cfg = J.serve_cfg("falcon-mamba-7b")
    p = tf.init_params(cfg, device="cpu")
    toks = torch.from_numpy(J.serve_tokens(cfg)[:, :1])
    lg, cache = tf.forward_prefill(p, {"tokens": toks}, cfg)
    return lg.numpy(), cache is not None


def _simulate_int8(g, spec):
    """The reference's cross_pod_psum_int8 on a (pod 2, data 2) mesh, in
    numpy: each device's block quantized with its own scale, int32 sums
    and MAX scales over 'pod', the result assembled from the blocks."""
    shape = {"pod": 2, "data": 2}
    g = np.asarray(g, np.float32)

    def block(p, d):
        idx = []
        for n, entry in zip(g.shape, tuple(spec) + (None,) * g.ndim):
            axes = () if entry is None else (
                entry if isinstance(entry, tuple) else (entry,))
            coord = {"pod": p, "data": d}
            k, parts = 0, 1
            for a in axes:
                k, parts = k * shape[a] + coord[a], parts * shape[a]
            size = n // parts
            idx.append(slice(k * size, (k + 1) * size))
        return tuple(idx[:g.ndim])
    out = np.zeros_like(g)
    for p in range(2):
        for d in range(2):
            qs, scales = [], []
            for pp in range(2):
                q, s = int8_quantize(torch.from_numpy(g[block(pp, d)]))
                qs.append(q.numpy().astype(np.int32))
                scales.append(float(s))
            out[block(p, d)] = (sum(qs).astype(np.float32)
                                * np.float32(max(scales)))
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    wait = start_ranks(J.port_suite, 4, tmp_path_factory.mktemp("dist"))
    want = {"train": {k: _unsharded_train(*v) for k, v in J.TRAIN.items()},
            "serve": {k: _unsharded_serve(*v) for k, v in J.SERVE.items()}}
    want["train"]["stablelm-cuda-route"] = want["train"]["stablelm-a2"]
    want["prefill1"] = _unsharded_prefill1()
    got = wait()[0]
    return got, want


def _close_params(got, want, lr):
    for path in want:
        if isinstance(want[path], dict):
            _close_params(got[path], want[path], lr)
        else:
            np.testing.assert_allclose(got[path], want[path], rtol=1e-4,
                                       atol=1e-2 * lr, err_msg=path)


@pytest.mark.parametrize("case", list(J.TRAIN) + ["stablelm-cuda-route"])
def test_sharded_train_steps_equal_the_unsharded(runs, case):
    """Two steps at (data 2, model 2): each step's gradients and metrics,
    then params and moments; every leaf a DTensor, updated in place."""
    got, want = J.ok(runs[0]["train"][case]), runs[1]["train"][case]
    for g, w in zip(got["grads"], want["grads"]):
        close_grads(g, w)
    for g, w in zip(got["metrics"], want["metrics"]):
        for k in METRICS:
            np.testing.assert_allclose(g[k], w[k], rtol=1e-5, atol=1e-7,
                                       err_msg=k)
    _close_params(got["params"], want["params"], J.OCFG["lr"])
    close_grads(got["m"], want["m"])
    assert got["step"] == want["step"] == 2
    assert got["all_dtensor"]


def test_a_microbatch_the_data_axis_does_not_divide_is_split(runs):
    """mixtral at 4 microbatches of 1 sequence over data 2: two
    microbatches a pass, each rank one sequence of it (its share, not the
    whole pass), and the steps equal the unsharded ones (above)."""
    got = J.ok(runs[0]["train"]["mixtral-a4"])
    assert got["local_rows"] == [1] * 4           # 2 passes a step, 2 steps
    assert J.ok(runs[0]["train"]["mixtral"])["local_rows"] == [1] * 4


def test_flash_runs_on_each_ranks_shards(runs):
    """attn_impl 'cuda' (the kernels' plain versions standing in for the
    launches): FlashAttentionFunction under local_map, on every rank the
    forward twice a layer a microbatch (the forward and the remat
    recompute) and the backward once."""
    got = J.ok(runs[0]["train"]["stablelm-cuda-route"])
    cfg = J.train_cfg("stablelm-3b", 2)
    assert got["launches"] == [2 * cfg.n_layers * cfg.grad_accum] * 2
    assert got["backward_launches"] == [cfg.n_layers * cfg.grad_accum] * 2


@pytest.mark.parametrize("case", list(J.SERVE))
def test_sharded_serve_steps_equal_the_unsharded(runs, case):
    """Prefill and 4 decode steps: logits within 1e-5; the decode cache
    written in place in the decode profile's layout (kv heads over 'model'
    when they divide it, else the sequence; Mamba states over d_inner)."""
    got, want = J.ok(runs[0]["serve"][case]), runs[1]["serve"][case]
    assert len(got["logits"]) == len(want) == 1 + J.STEPS
    for g, w in zip(got["logits"], want):
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-5)
    assert got["in_place"] and got["pos_idx"] == J.PROMPT + J.STEPS
    layout = {"stablelm": "S(3)", "stablelm-kv1": "S(2)"}
    for name, plc in got["layout"].items():
        assert plc[0] == "S(1)", (name, plc)          # batch over data
        if case in layout:
            assert plc[1] == layout[case], (name, plc)
        else:                                         # conv / h: d_inner
            assert plc[1] == ("S(3)" if name.endswith("conv") else "S(2)")


def test_one_token_sharded_prefill_equals_the_unsharded(runs):
    """falcon-mamba's prefill of a 1-token prompt: the recurrence's single
    step from zero states on each rank's channels, as unsharded."""
    got, want = J.ok(runs[0]["prefill1"]), runs[1]["prefill1"]
    np.testing.assert_allclose(got[0], want[0], rtol=1e-5, atol=1e-5)
    assert got[1] == want[1]


def test_gpipe_equals_the_sequential_composition(runs):
    ws, xs = J.gpipe_inputs()
    want = xs
    for w in ws:
        want = np.tanh(want @ w)
    np.testing.assert_allclose(J.ok(runs[0]["gpipe"]), want, atol=1e-5)


def test_cross_pod_psum_int8_has_the_reference_semantics(runs):
    got = J.ok(runs[0]["int8"])
    for name, g in J.int8_grads().items():
        want = _simulate_int8(g, J.INT8_SPECS[name])
        np.testing.assert_allclose(got[name], want, rtol=1e-6, atol=0,
                                   err_msg=name)
    # the pod-split leaf: its two pods' blocks end equal, and not a plain
    # sum of the gradient (int8 rounding with a shared scale)
    c = got["c"].reshape(2, 2, 3)
    np.testing.assert_array_equal(c[0], c[1])


def test_a_mesh_larger_than_the_world_raises(runs):
    assert runs[0]["too_small"] == "need 8 devices, have 4"
    # a smaller one takes the first ranks, as the reference's takes the
    # first devices
    assert runs[0]["sub_mesh"] == ((2,), [0])
