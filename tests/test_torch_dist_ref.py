"""The slice as a whole against the JAX package: the port's sharded train
and serve steps, ``gpipe_spmd`` and ``cross_pod_psum_int8`` on 4 ``gloo``
ranks of the CPU against the reference's ``jit_train_step``,
``jit_serve_steps``, ``gpipe_spmd`` and ``cross_pod_psum_int8`` on 4 XLA
host devices, from the same numpy weights, batches and schedule.

The reference runs in a subprocess (``XLA_FLAGS=
--xla_force_host_platform_device_count=4``, as ``test_dryrun_path.py``
runs it), which keeps this process at one device and the reference's
``shard_map`` DeprecationWarning out of the suite's filter; its train step
is ``cell_specs``' shardings on a (data 2, model 2) mesh, executed.  The
port's ranks (``_torch_dist_jobs.ref_suite``) run meanwhile.  Weights: the
reference's ``init_params`` at fp32, carried across by
``params_from_numpy`` with the mesh and specs.

Tolerances as ``test_torch_train.py::test_two_train_steps_match_reference``
holds two unsharded steps: metrics within rtol 1e-5, params within rtol
1e-4 / atol 1e-2 * lr, first moments by ``close_grads`` (the schedule is
``_torch_dist_jobs.OCFG``); serving logits as the LM tests hold fp32
(rtol 1e-4 / atol 1e-4); the pipeline within 1e-5; the int8 all-reduce
within rtol 1e-6 (the same int8 values, scales and products).
"""
import os
import pickle
import subprocess
import sys
import textwrap

import jax
import numpy as np
import pytest

import _torch_dist_jobs as J
from _torch_dist import start_ranks
from _torch_lm import FP32, close_grads
from repro.configs import get_config as ref_get_config
from repro.models import transformer as ref_tf

REF_PROG = textwrap.dedent("""
    import os, pickle, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import jax, jax.numpy as jnp, numpy as np
    from jax.sharding import NamedSharding, PartitionSpec as P
    from repro.configs import get_config
    from repro.configs.base import ShapeConfig
    from repro.launch.jax_compat import make_mesh, set_mesh
    from repro.launch.specs import cell_specs, limit_specs_tree
    from repro.models import transformer as tf
    from repro.train.compression import cross_pod_psum_int8
    from repro.train.optimizer import OptConfig, init_opt_state
    from repro.train.pipeline_parallel import gpipe_spmd, stack_stage_params
    from repro.train.serve_step import jit_serve_steps
    from repro.train.sharding import make_rules
    from repro.train.train_step import jit_train_step

    inp = pickle.load(open(sys.argv[1], "rb"))
    out = {}
    mesh = make_mesh((2, 2), ("data", "model"), devices=jax.devices()[:4])
    for name, case in inp["train"].items():
        cfg = get_config(case["arch"], smoke=True).replace(
            compute_dtype="float32", grad_accum=case["accum"])
        shape = ShapeConfig("t", seq_len=case["seq"],
                            global_batch=case["batch"], kind="train",
                            grad_accum=case["accum"])
        sp = cell_specs(cfg, shape, mesh)
        cfg = sp["cfg"]
        with set_mesh(mesh):
            step = jit_train_step(
                cfg, OptConfig(**inp["ocfg"]), sp["rules"],
                sp["param_specs"],
                jax.tree.map(lambda s: s.spec, sp["batch_shardings"]), mesh)
            p = jax.device_put(jax.tree.map(jnp.asarray, case["params"]),
                               sp["param_shardings"])
            opt = jax.device_put(init_opt_state(p, cfg), sp["opt_shardings"])
            mets = []
            for b in case["batches"]:
                p, opt, m = step(p, opt, {"tokens": jnp.asarray(b)})
                mets.append({k: float(v) for k, v in m.items()})
        out[name] = {"metrics": mets, "params": jax.tree.map(np.asarray, p),
                     "m": jax.tree.map(np.asarray, opt["m"]),
                     "step": int(opt["step"])}
    s = inp["serve"]
    cfg = get_config(s["arch"], smoke=True).replace(compute_dtype="float32")
    rules = make_rules(mesh, "decode", cfg)
    p_spec = limit_specs_tree(tf.param_specs(cfg, rules),
                              tf.param_shapes(cfg), mesh)
    toks = s["tokens"]
    with set_mesh(mesh):
        jp, jd = jit_serve_steps(cfg, rules, p_spec, mesh, toks.shape[0],
                                 toks.shape[1])
        params = jax.tree.map(jnp.asarray, s["params"])
        lg, cache = jp(params, {"tokens": jnp.asarray(toks[:, :s["prompt"]])})
        lgs = [np.asarray(lg)]
        cache = tf.grow_cache(cache, cfg, toks.shape[1])
        for t in range(s["prompt"], toks.shape[1]):
            lg, cache = jd(params, cache,
                           {"tokens": jnp.asarray(toks[:, t:t + 1])})
            lgs.append(np.asarray(lg))
    out["serve"] = lgs
    g = inp["gpipe"]
    smesh = make_mesh((4,), ("stage",), devices=jax.devices()[:4])
    pipelined = gpipe_spmd(lambda w, h: jnp.tanh(h @ w), smesh, 4, g["m"],
                           axis="stage")
    with set_mesh(smesh):
        out["gpipe"] = np.asarray(jax.jit(pipelined)(
            stack_stage_params([jnp.asarray(w) for w in g["ws"]]),
            jnp.asarray(g["xs"])))
    c = inp["int8"]
    pmesh = make_mesh((2, 2), ("pod", "data"), devices=jax.devices()[:4])
    specs = {k: P(*v) for k, v in c["specs"].items()}
    with set_mesh(pmesh):
        grads = {k: jax.device_put(jnp.asarray(v, jnp.float32),
                                   NamedSharding(pmesh, specs[k]))
                 for k, v in c["grads"].items()}
        res = jax.jit(cross_pod_psum_int8(pmesh, specs))(grads)
    out["int8"] = {k: np.asarray(v) for k, v in res.items()}
    pickle.dump(out, open(sys.argv[2], "wb"))
    print("REF_DIST_OK")
""")

#: the reference's side of each train case: (arch, grad_accum)
TRAIN = {"stablelm": ("stablelm-3b", 2), "mixtral": ("mixtral-8x7b", 2)}
SERVE_PROMPT, SERVE_STEPS = 8, 2


def _ref_params(arch):
    cfg = ref_get_config(arch, smoke=True).replace(compute_dtype="float32")
    return jax.tree.map(np.asarray, ref_tf.init_params(
        cfg, jax.random.PRNGKey(0)))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dist_ref")
    cfg = J.train_cfg("stablelm-3b", 2)
    batches = [J.train_tokens(s, cfg).astype(np.int32) for s in (3, 4)]
    ws, xs = J.gpipe_inputs()
    inp = {"ocfg": J.OCFG,
           "train": {name: dict(arch=arch, accum=accum, seq=J.S, batch=J.B,
                                params=_ref_params(arch), batches=batches)
                     for name, (arch, accum) in TRAIN.items()},
           "serve": dict(arch="stablelm-3b", prompt=SERVE_PROMPT,
                         params=_ref_params("stablelm-3b"),
                         tokens=J.serve_tokens(cfg)[
                             :, :SERVE_PROMPT + SERVE_STEPS].astype(np.int32)),
           "gpipe": dict(m=J.GPIPE["m"], ws=ws, xs=xs),
           "int8": dict(specs=J.INT8_SPECS, grads=J.int8_grads())}
    inp_path, out_path = tmp / "inp.pkl", tmp / "ref_out.pkl"
    with open(inp_path, "wb") as f:
        pickle.dump(inp, f)
    ref = subprocess.Popen(
        [sys.executable, "-c", REF_PROG, str(inp_path), str(out_path)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env={**os.environ, "PYTHONPATH": "src", "JAX_PLATFORMS": "cpu"})
    wait = start_ranks(J.ref_suite, 4, tmp, str(inp_path))
    try:
        stdout, stderr = ref.communicate(timeout=600)
    finally:
        ref.kill()
    got = wait()[0]
    assert "REF_DIST_OK" in stdout, stdout + stderr
    with open(out_path, "rb") as f:
        want = pickle.load(f)
    return got, want


def _close_params(got, want, lr, path=""):
    if isinstance(want, dict):
        assert set(got) == set(want), path
        for k in want:
            _close_params(got[k], want[k], lr, f"{path}.{k}")
        return
    np.testing.assert_allclose(got, np.asarray(want, np.float32), rtol=1e-4,
                               atol=1e-2 * lr, err_msg=path)


@pytest.mark.parametrize("case", list(TRAIN))
def test_sharded_train_steps_match_the_reference(runs, case):
    """Two steps of ``sharded_train_step`` against two of the reference's
    ``jit_train_step`` at (data 2, model 2), grad_accum 2: metrics, params,
    first moments and the step."""
    got, want = J.ok(runs[0][case]), runs[1][case]
    for g, w in zip(got["metrics"], want["metrics"]):
        for k in ("loss", "ce", "aux", "lr", "grad_norm"):
            np.testing.assert_allclose(g[k], w[k], rtol=1e-5, atol=1e-7,
                                       err_msg=k)
    _close_params(got["params"], want["params"], J.OCFG["lr"])
    close_grads(got["m"], want["m"])
    assert got["step"] == want["step"] == 2


def test_sharded_serve_steps_match_the_reference(runs):
    """Prefill and 2 decode steps against ``jit_serve_steps`` (the decode
    profile's layout on both sides)."""
    got, want = J.ok(runs[0]["serve"])["logits"], runs[1]["serve"]
    assert len(got) == len(want) == 1 + SERVE_STEPS
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, **FP32)


def test_gpipe_matches_the_reference(runs):
    np.testing.assert_allclose(J.ok(runs[0]["gpipe"]), runs[1]["gpipe"],
                               atol=1e-5)


def test_cross_pod_psum_int8_matches_the_reference(runs):
    got, want = J.ok(runs[0]["int8"]), runs[1]["int8"]
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-6, atol=0,
                                   err_msg=k)
