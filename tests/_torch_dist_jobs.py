"""The jobs the port's multi-process tests run in each of their ranks
(``_torch_dist.run_ranks``): the port's sharded train and serve steps,
``gpipe_spmd`` and ``cross_pod_psum_int8`` on 4 ``gloo`` ranks of the CPU,
each returning numpy results (whole tensors, gathered on every rank) for
the tests to hold against the port's unsharded steps
(``test_torch_dist.py``) or the reference's sharded ones
(``test_torch_dist_ref.py``).  This module imports the port and numpy
only.

Configurations are the smoke configs in fp32; weights come from the
port's seeded ``init_params`` (``port_suite``) or from the reference's
numpy trees (``ref_suite``), carried in by ``params_from_numpy`` with the
mesh and specs, so each rank copies only its slice.
"""
import pickle

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.kernels.flash_attention import (flash_attention_backward_ref,
                                                 flash_attention_ref)
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.launch.mesh import make_host_mesh, make_mesh
from repro_torch.launch.specs import cell_specs, limit_specs_tree
from repro_torch.models import transformer as tf
from repro_torch.models.convert import params_from_numpy
from repro_torch.train.compression import cross_pod_psum_int8
from repro_torch.train.optimizer import OptConfig, init_opt_state, tree_map
from repro_torch.train.pipeline_parallel import gpipe_spmd, stack_stage_params
from repro_torch.train.serve_step import sharded_serve_steps
from repro_torch.train.sharding import distribute, full, make_rules
from repro_torch.train import train_step as train_step_mod
from repro_torch.train.train_step import sharded_train_step

#: the schedule of ``test_torch_train.py``'s two steps, with AdamW's eps
#: at 1e-6: at the default 1e-8 a gradient near eps moves its weight by
#: about 0.6 lr, so the fp32 rounding of such a gradient (a sum that
#: cancels to ~1e-8, added in another order over the ranks) moves the
#: weight by more than the 1e-2 * lr the params are held to (one tok_embed
#: element of stablelm's smoke model: 1.09e-2 * lr, its gradient -1.67e-8);
#: the gradients themselves are held directly as well
OCFG = dict(lr=1e-2, warmup_steps=1, total_steps=10, eps=1e-6)
#: train cases: (arch, grad_accum, config fields)
TRAIN = {"stablelm-a1": ("stablelm-3b", 1, {}),
         "stablelm-a2": ("stablelm-3b", 2, {}),
         "mixtral": ("mixtral-8x7b", 2, {}),
         "mixtral-ep": ("mixtral-8x7b", 2, {"expert_parallel": True}),
         "falcon": ("falcon-mamba-7b", 2, {}),
         # microbatches of 1 sequence over 2 data ranks: two a pass
         "mixtral-a4": ("mixtral-8x7b", 4, {})}
#: serve cases: (arch, config fields); stablelm's 4 kv heads divide the
#: model axis (the decode cache's heads over 'model'), one kv head does not
#: (its sequence over 'model'), falcon's states go over d_inner
SERVE = {"stablelm": ("stablelm-3b", {}),
         "stablelm-kv1": ("stablelm-3b", {"n_kv_heads": 1}),
         "falcon": ("falcon-mamba-7b", {})}
B, S, PROMPT, STEPS = 4, 32, 8, 4
GPIPE = dict(n_stages=4, m=6, mb=2, d=16)
INT8_SPECS = {"a": ("data", None), "b": (None,), "c": (("pod", "data"),)}


def train_cfg(arch, accum, **kw):
    return get_config(arch, smoke=True).replace(
        compute_dtype="float32", grad_accum=accum, **kw)


def serve_cfg(arch, **kw):
    return get_config(arch, smoke=True).replace(compute_dtype="float32",
                                                **kw)


def train_tokens(seed, cfg):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (B, S)).astype(np.int64)


def serve_tokens(cfg):
    return np.random.default_rng(5).integers(
        0, cfg.vocab_size, (B, PROMPT + STEPS)).astype(np.int64)


def gpipe_inputs():
    d = GPIPE["d"]
    ws = [(np.random.default_rng(i).normal(size=(d, d)) * 0.5).astype(
        np.float32) for i in range(GPIPE["n_stages"])]
    xs = np.random.default_rng(99).normal(
        size=(GPIPE["m"], GPIPE["mb"], d)).astype(np.float32)
    return ws, xs


def int8_grads():
    return {"a": np.random.default_rng(1).normal(size=(8, 6)),
            "b": np.random.default_rng(2).normal(size=(10,)),
            "c": np.random.default_rng(3).normal(scale=3.0, size=(12,))}


def to_np(tree):
    return tree_map(lambda t: full(t).detach().float().numpy(), tree)


# ------------------------------------------------------------------ pieces
def run_train(mesh, cfg, params_np, batches, counts=None):
    """Two sharded steps from ``params_np`` and a zero opt state ->
    {metrics a step, params, m, step, flash forward and backward launches
    a step}."""
    shape = ShapeConfig("t", seq_len=S, global_batch=B, kind="train",
                        grad_accum=cfg.grad_accum)
    sp = cell_specs(cfg, shape, mesh)
    cfg = sp["cfg"]
    p = params_from_numpy(params_np, device="cpu", mesh=mesh,
                          specs=sp["param_specs"])
    opt = init_opt_state(p, cfg)
    grads = []
    step = sharded_train_step(cfg, OptConfig(**OCFG), sp["rules"],
                              sp["param_specs"], sp["batch_specs"], mesh,
                              grad_transform=lambda g: keep(grads, g))
    mets, launches, bwd_launches, rows = [], [], [], []
    fwd = train_step_mod.forward_train

    def spy(params, batch, cfg, rules, **kw):
        rows.append(batch["tokens"].to_local().shape[0])
        return fwd(params, batch, cfg, rules, **kw)
    for toks in batches:
        before = dict(counts or {})
        train_step_mod.forward_train = spy
        try:
            p2, opt2, m = step(p, opt, {"tokens": torch.from_numpy(toks)})
        finally:
            train_step_mod.forward_train = fwd
        assert all(a is b for a, b in zip(tree_leaves(p2), tree_leaves(p)))
        p, opt = p2, opt2
        mets.append({k: float(v) for k, v in m.items()})
        if counts is not None:
            launches.append(counts["flash"] - before["flash"])
            bwd_launches.append(counts["flash_bwd"] - before["flash_bwd"])
    placed = all(type(t).__name__ == "DTensor" for t in tree_leaves(p))
    return {"metrics": mets, "params": to_np(p), "m": to_np(opt["m"]),
            "grads": grads, "step": int(full(opt["step"])),
            "launches": launches, "backward_launches": bwd_launches,
            "all_dtensor": placed, "local_rows": rows}


def keep(store, grads):
    """A ``grad_transform`` that records the step's gradients (whole, as
    numpy) and passes them on."""
    store.append(to_np(grads))
    return grads


def tree_leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    return [tree]


def run_serve(mesh, cfg, params_np, toks, profile="decode", prompt=PROMPT):
    """Sharded prefill of the first PROMPT tokens, the cache grown to all
    of them, a decode step a token -> logits [prefill, step...], the
    decode cache's placements, whether decode wrote it in place."""
    rules = make_rules(mesh, profile, cfg)
    p_spec = limit_specs_tree(tf.param_specs(cfg, rules),
                              tf.param_shapes(cfg), mesh)
    p = params_from_numpy(params_np, device="cpu", mesh=mesh, specs=p_spec)
    total = toks.shape[1]
    prefill, decode = sharded_serve_steps(cfg, rules, p_spec, mesh, B, total)
    with torch.no_grad():
        lg, cache = prefill(p, {"tokens": torch.from_numpy(
            toks[:, :prompt])})
        out = [full(lg).numpy()]
        cache = tf.grow_cache(cache, cfg, total)
        kept, layout = None, {}
        for t in range(prompt, total):
            lg, cache = decode(p, cache, {"tokens": torch.from_numpy(
                toks[:, t:t + 1])})
            leaves = [v for k, sub in sorted(cache.items()) if k != "pos_idx"
                      for _, v in sorted(sub.items())]
            if kept is None:
                kept = [t_.to_local().data_ptr() for t_ in leaves]
            in_place = kept == [t_.to_local().data_ptr() for t_ in leaves]
            out.append(full(lg).numpy())
        for k, sub in cache.items():
            if k != "pos_idx":
                layout.update({f"{k}.{n}": tuple(str(x) for x in v.placements)
                               for n, v in sub.items()})
    return {"logits": out, "layout": layout, "in_place": in_place,
            "pos_idx": cache["pos_idx"]}


def run_prefill(mesh, cfg, params_np, toks):
    """Sharded prefill alone (a 1-token prompt leaves a Mamba model no
    cache) -> (logits, whether a cache came back)."""
    rules = make_rules(mesh, "decode", cfg)
    p_spec = limit_specs_tree(tf.param_specs(cfg, rules),
                              tf.param_shapes(cfg), mesh)
    p = params_from_numpy(params_np, device="cpu", mesh=mesh, specs=p_spec)
    prefill, _ = sharded_serve_steps(cfg, rules, p_spec, mesh, B,
                                     toks.shape[1])
    with torch.no_grad():
        lg, cache = prefill(p, {"tokens": torch.from_numpy(toks)})
    return full(lg).numpy(), cache is not None


def run_gpipe(ws, xs):
    mesh = make_mesh((GPIPE["n_stages"],), ("stage",), device="cpu")
    stacked = stack_stage_params([torch.from_numpy(w) for w in ws])
    stacked = distribute(stacked, mesh, ("stage",))
    pipelined = gpipe_spmd(lambda w, h: torch.tanh(h @ w), mesh,
                           GPIPE["n_stages"], GPIPE["m"], axis="stage")
    return pipelined(stacked, torch.from_numpy(xs)).numpy()


def run_int8(grads_np):
    mesh = make_mesh((2, 2), ("pod", "data"), device="cpu")
    grads = {k: distribute(torch.from_numpy(np.asarray(v, np.float32)), mesh,
                           INT8_SPECS[k]) for k, v in grads_np.items()}
    out = cross_pod_psum_int8(mesh, INT8_SPECS)(grads)
    return {k: full(v).numpy() for k, v in out.items()}


def counting_flash():
    """The plain versions in place of the flash kernels' launches, forward
    and backward (the card's route through ``FlashAttentionFunction`` on
    the CPU), each call counted."""
    counts = {"flash": 0, "flash_bwd": 0}

    def flash(*a, **kw):
        counts["flash"] += 1
        return flash_attention_ref(*a, **kw)

    def flash_bwd(*a, **kw):
        counts["flash_bwd"] += 1
        return flash_attention_backward_ref(*a, **kw)
    flash_ops.flash_attention_cuda = flash
    flash_ops.flash_attention_backward_cuda = flash_bwd
    return counts


# ------------------------------------------------------------------ suites
def guarded(fn, *args, **kw):
    """("ok", fn(...)) or ("error", its traceback): one case that fails
    (on every rank alike) leaves the other cases their results."""
    import traceback
    from _torch_dist import progress
    cfg = args[1] if len(args) > 1 else None
    progress(f"{fn.__name__}:{getattr(cfg, 'name', '')}")
    try:
        return ("ok", fn(*args, **kw))
    except Exception:
        return ("error", traceback.format_exc())


def ok(res):
    """The value of a ``guarded`` case; its traceback fails the test."""
    status, val = res
    if status != "ok":
        raise AssertionError(f"the case failed on the ranks:\n{val}")
    return val


def port_suite(rank, world):
    """The port's sharded steps at (data 2, model 2) on the port's own
    seeded weights, for ``test_torch_dist.py``."""
    mesh = make_host_mesh(2, 2, device="cpu")
    out = {"train": {}, "serve": {}}
    for name, (arch, accum, kw) in TRAIN.items():
        cfg = train_cfg(arch, accum, **kw)
        p = tree_map(lambda t: t.numpy(), tf.init_params(cfg, device="cpu"))
        out["train"][name] = guarded(
            run_train, mesh, cfg, p, [train_tokens(s, cfg) for s in (3, 4)])
    counts = counting_flash()
    cfg = train_cfg("stablelm-3b", 2, attn_impl="cuda")
    p = tree_map(lambda t: t.numpy(), tf.init_params(cfg, device="cpu"))
    out["train"]["stablelm-cuda-route"] = guarded(
        run_train, mesh, cfg, p, [train_tokens(s, cfg) for s in (3, 4)],
        counts)
    for name, (arch, kw) in SERVE.items():
        cfg = serve_cfg(arch, **kw)
        p = tree_map(lambda t: t.numpy(), tf.init_params(cfg, device="cpu"))
        out["serve"][name] = guarded(run_serve, mesh, cfg, p,
                                     serve_tokens(cfg))
    cfg = serve_cfg("falcon-mamba-7b")
    p = tree_map(lambda t: t.numpy(), tf.init_params(cfg, device="cpu"))
    out["prefill1"] = guarded(run_prefill, mesh, cfg, p,
                              serve_tokens(cfg)[:, :1])
    out["gpipe"] = guarded(run_gpipe, *gpipe_inputs())
    out["int8"] = guarded(run_int8, int8_grads())
    try:
        make_host_mesh(4, 2, device="cpu")
        out["too_small"] = None
    except ValueError as e:
        out["too_small"] = str(e)
    sub = make_host_mesh(2, None, device="cpu")       # the first 2 ranks
    coord = sub.get_coordinate()                      # None off the mesh
    out["sub_mesh"] = (tuple(sub.shape), coord and list(coord))
    return out if rank == 0 else None


def ref_suite(rank, world, inp_path):
    """The port's sharded pieces on the reference's inputs (weights,
    batches, schedule) from ``inp_path``, for ``test_torch_dist_ref.py``."""
    with open(inp_path, "rb") as f:
        inp = pickle.load(f)
    mesh = make_host_mesh(2, 2, device="cpu")
    out = {}
    for name, case in inp["train"].items():
        cfg = train_cfg(case["arch"], case["accum"])
        out[name] = guarded(run_train, mesh, cfg, case["params"],
                            [b.astype(np.int64) for b in case["batches"]])
    s = inp["serve"]
    out["serve"] = guarded(run_serve, mesh, serve_cfg(s["arch"]),
                           s["params"], s["tokens"].astype(np.int64),
                           prompt=s["prompt"])
    out["gpipe"] = guarded(run_gpipe, inp["gpipe"]["ws"], inp["gpipe"]["xs"])
    out["int8"] = guarded(run_int8, inp["int8"]["grads"])
    return out if rank == 0 else None
