"""The port's checkpoints, fault tolerance and training launcher
(``repro_torch.train.checkpoint``, ``.fault``, ``repro_torch.launch.train``)
on the CPU: round trips are exact (fp32, bf16 as its bits, int32); a
checkpoint the reference wrote restores into the port's tree; an async
save holds the state as it was when ``maybe_save`` returned, though the
optimizer then updates the parameters in place; a resumed ``train_loop``
equals the uninterrupted one exactly (same losses, same parameters); the
launcher lowers the loss (the reference's
``test_loss_decreases_end_to_end``)."""
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.train.checkpoint import save_checkpoint as ref_save
from repro_torch.configs import get_config
from repro_torch.launch import train as launch_train
from repro_torch.launch.train import build_state, train_loop
from repro_torch.train.checkpoint import (CheckpointManager, latest_step,
                                          restore_checkpoint, save_checkpoint,
                                          tree_paths)
from repro_torch.train.fault import (ElasticRunner, StragglerWatchdog,
                                     with_retries)
from repro_torch.train.optimizer import OptConfig, tree_leaves


def _state(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {"params": {"w": torch.randn((8, 4), generator=g),
                       "b": torch.zeros((4,)),
                       "h": torch.randn((3, 5), generator=g).to(
                           torch.bfloat16)},
            "step": torch.tensor(7, dtype=torch.int32)}


def _same(a, b):
    if isinstance(a, dict):
        assert set(a) == set(b)
        for k in a:
            _same(a[k], b[k])
        return
    assert a.dtype == b.dtype and a.shape == b.shape and torch.equal(a, b)


def test_save_restore_roundtrip(tmp_path):
    st = _state()
    path = save_checkpoint(str(tmp_path), 7, st, extra_meta={"arch": "x"})
    with open(os.path.join(path, "meta.json")) as f:
        meta = json.load(f)
    assert meta["paths"] == ["params/b", "params/h", "params/w", "step"]
    assert meta["dtypes"]["params/h"] == "bfloat16"
    assert np.load(os.path.join(path, "arrays.npz"))["params/h"].dtype \
        == np.uint16
    got, meta = restore_checkpoint(str(tmp_path), _state(seed=1))
    assert meta["step"] == 7 and meta["extra"] == {"arch": "x"}
    _same(got, st)


def test_paths_are_the_reference_keys():
    from repro.train.checkpoint import tree_paths as ref_paths
    p, opt = build_state(get_config("falcon-mamba-7b", smoke=True),
                         device="cpu")
    ref_tree = jax.tree.map(lambda t: np.zeros(t.shape, np.float32),
                            {"params": p, "opt": opt})
    assert tree_paths({"params": p, "opt": opt}) == ref_paths(ref_tree)


def test_reference_checkpoint_restores_into_the_port_tree(tmp_path):
    rng = np.random.default_rng(2)
    ref_state = {"params": {"w": jnp.asarray(rng.normal(size=(8, 4)),
                                             jnp.float32),
                            "b": jnp.asarray(rng.normal(size=(4,)),
                                             jnp.float32)},
                 "opt": {"step": jnp.asarray(3, jnp.int32)}}
    ref_save(str(tmp_path), 3, ref_state)
    assert not os.path.exists(tmp_path / "step_00000003" / "meta.json")
    template = {"params": {"w": torch.zeros((8, 4)), "b": torch.zeros(4)},
                "opt": {"step": torch.zeros((), dtype=torch.int32)}}
    got, meta = restore_checkpoint(str(tmp_path), template)
    assert meta["step"] == 3
    for k in ("w", "b"):
        np.testing.assert_array_equal(got["params"][k].numpy(),
                                      np.asarray(ref_state["params"][k]))
    assert got["opt"]["step"].dtype == torch.int32
    assert int(got["opt"]["step"]) == 3


def test_latest_step_and_keep_k(tmp_path):
    mgr = CheckpointManager(str(tmp_path), every_steps=1, keep=2,
                            async_save=False)
    for s in range(1, 6):
        mgr.maybe_save(s, _state())
    assert not mgr.maybe_save(0, _state())
    assert latest_step(str(tmp_path)) == 5
    assert sorted(os.listdir(tmp_path)) == ["step_00000004", "step_00000005"]


def test_async_save_snapshots_before_the_in_place_update(tmp_path):
    """The optimizer writes the parameters in place: an update right after
    ``maybe_save`` returns must not reach the checkpoint."""
    mgr = CheckpointManager(str(tmp_path), every_steps=1, keep=3,
                            async_save=True)
    st = {"w": torch.ones(100_000), "h": torch.ones(10, dtype=torch.bfloat16)}
    mgr.maybe_save(1, st)
    st["w"].mul_(0)
    st["h"].add_(1)
    mgr.wait()
    got, _ = restore_checkpoint(str(tmp_path), st)
    assert torch.equal(got["w"], torch.ones(100_000))
    assert torch.equal(got["h"], torch.ones(10, dtype=torch.bfloat16))


def test_async_save_error_surfaces_on_wait(tmp_path):
    blocker = tmp_path / "file"
    blocker.write_text("not a directory")
    mgr = CheckpointManager(str(blocker), every_steps=1, async_save=True)
    mgr.maybe_save(1, {"w": torch.ones(3)})
    with pytest.raises(OSError):
        mgr.wait()


def test_atomic_save_no_tmp_left(tmp_path):
    save_checkpoint(str(tmp_path), 3, _state())
    save_checkpoint(str(tmp_path), 3, _state(seed=2))     # overwrite
    assert os.listdir(tmp_path) == ["step_00000003"]
    got, _ = restore_checkpoint(str(tmp_path), _state())
    _same(got, _state(seed=2))


def test_elastic_runner_restores_and_continues():
    calls = {"n": 0}

    def loop(state, start):
        calls["n"] += 1
        if calls["n"] < 3:
            raise RuntimeError("node lost")
        return (state, start)

    runner = ElasticRunner(lambda: ({"restored": True}, 5), max_restarts=5)
    state, step = runner.run(loop, {"restored": False}, 0)
    assert state["restored"] and step == 5
    assert runner.restarts == 2


def test_elastic_runner_gives_up():
    runner = ElasticRunner(lambda: ({}, 0), max_restarts=1)
    with pytest.raises(RuntimeError):
        runner.run(lambda s, t: (_ for _ in ()).throw(RuntimeError("x")),
                   {}, 0)


def test_with_retries_backoff():
    attempts = {"n": 0}

    def flaky():
        attempts["n"] += 1
        if attempts["n"] < 3:
            raise OSError("transient")
        return "ok"

    assert with_retries(flaky, max_retries=4, backoff=0.001)() == "ok"
    assert attempts["n"] == 3
    with pytest.raises(ValueError):
        with_retries(lambda: (_ for _ in ()).throw(ValueError("x")),
                     max_retries=4, backoff=0.001)()


def test_straggler_watchdog_detects_persistent_slowdown():
    events = []
    wd = StragglerWatchdog(window=16, threshold=2.0, patience=3,
                           on_straggler=events.append)
    for s in range(10):
        wd.observe(s, 0.1)
    for s in range(10, 14):
        wd.observe(s, 0.5)
    assert len(events) >= 1 and events[0].ratio > 2.0


def test_straggler_watchdog_ignores_one_off_spike():
    wd = StragglerWatchdog(window=16, threshold=2.0, patience=3)
    for s in range(10):
        wd.observe(s, 0.1)
    wd.observe(10, 1.0)
    for s in range(11, 20):
        wd.observe(s, 0.1)
    assert wd.events == []


# ------------------------------------------------------------ the launcher
def test_train_loop_resume_equals_the_uninterrupted_run(tmp_path):
    """6 steps straight, against 4 steps, a checkpoint and 2 resumed ones
    (the same schedule): the resumed steps see the same batches and give
    the same losses and parameters, exactly."""
    cfg = get_config("stablelm-3b", smoke=True)
    kw = dict(batch=4, seq_len=32, log_every=100, device="cpu",
              ocfg=OptConfig(lr=1e-2, warmup_steps=1, total_steps=6))
    whole = train_loop(cfg, steps=6, **kw)
    first = train_loop(cfg, steps=4, ckpt_dir=str(tmp_path), ckpt_every=2,
                       **kw)
    assert latest_step(str(tmp_path)) == 4
    assert first["losses"] == whole["losses"][:4]
    rest = train_loop(cfg, steps=6, ckpt_dir=str(tmp_path), resume=True,
                      **kw)
    assert rest["steps_done"] == 2
    assert rest["losses"] == whole["losses"][4:]
    for a, b in zip(tree_leaves(rest["params"]),
                    tree_leaves(whole["params"])):
        assert torch.equal(a, b)
    assert int(rest["opt_state"]["step"]) == 6
    assert latest_step(str(tmp_path)) == 6


def test_loss_decreases_end_to_end():
    cfg = get_config("stablelm-3b", smoke=True).replace(grad_accum=2)
    res = train_loop(cfg, steps=30, batch=8, seq_len=64, log_every=100,
                     device="cpu")
    losses = res["losses"]
    assert len(losses) == 30 and all(np.isfinite(losses))
    assert np.mean(losses[-5:]) < np.mean(losses[:5]) - 0.2


def test_launcher_cli_on_the_cpu(monkeypatch, capsys):
    monkeypatch.setattr(sys, "argv", [
        "train", "--arch", "falcon-mamba-7b", "--smoke", "--device", "cpu",
        "--steps", "2", "--batch", "4", "--seq-len", "32"])
    launch_train.main()
    out = capsys.readouterr().out
    assert "step     0  loss" in out and "done: 2 steps" in out


def test_launcher_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        build_state(get_config("stablelm-3b", smoke=True))
