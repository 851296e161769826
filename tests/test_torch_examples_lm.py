"""The port's LM examples (``examples/torch_{serve_lm,train_lm}.py``) on
the CPU against the reference (``repro``); the ETL examples and the import
guard of all five: ``test_torch_examples.py``.

- serve_lm: smoke mixtral in float32 with the reference's weights carried
  across (``_torch_lm.params``): tokens identical to the reference's
  ``BatchedServer`` on the example's traffic (8 prompts of 24 tokens, 16
  new tokens each, waves of 4, greedy).  The prompts are shorter than the
  smoke window (32), where the reference's window cache is right.
- train_lm: a small run (d 64, 2 layers, batch 4 x 32, 8 steps) with the
  restart gives the losses of an uninterrupted ``train_loop``, exactly.
"""
import importlib.util
from pathlib import Path

import numpy as np

from repro.launch.serve import BatchedServer as RefServer
from repro.launch.serve import Request as RefRequest
from repro_torch.launch.train import train_loop

import _torch_lm

ROOT = Path(__file__).resolve().parents[1]
SILENT = dict(log=lambda *a: None)


def load(name: str):
    spec = importlib.util.spec_from_file_location(
        name, ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_serve_lm_matches_reference():
    ref_cfg, cfg = _torch_lm.cfgs("mixtral-8x7b", compute_dtype="float32")
    ref_p, p = _torch_lm.params(ref_cfg)
    sl = load("torch_serve_lm")
    got = sl.serve(cfg, params=p, device="cpu", **SILENT)
    # the reference example's traffic: one numpy generator, a prompt a
    # request in turn
    rng = np.random.default_rng(0)
    reqs = [RefRequest(rid=i, prompt=rng.integers(
        2, ref_cfg.vocab_size, sl.TRAFFIC["prompt_len"]).astype(np.int32),
        max_new=sl.TRAFFIC["max_new"]) for i in range(sl.TRAFFIC["n"])]
    RefServer(ref_cfg, params=ref_p, batch=sl.BATCH,
              temperature=0.0).run(reqs)
    assert [r.out_tokens for r in got["done"]] == \
        [r.out_tokens for r in reqs]
    assert [list(r.prompt) for r in got["done"]] == \
        [list(r.prompt) for r in reqs]
    assert got["tokens"] == sl.TRAFFIC["n"] * sl.TRAFFIC["max_new"]
    assert got["stats"]["prefills"] == sl.TRAFFIC["n"] // sl.BATCH


def test_train_lm_restart_equals_an_uninterrupted_run():
    tl = load("torch_train_lm")
    cfg = tl.model_config(dim=64, layers=2)
    assert (cfg.n_heads, cfg.hd, cfg.vocab_size) == (8, 8, 32_000)
    assert tl.model_config().hd == 64
    got = tl.train(cfg, steps=8, batch=4, seq_len=32, device="cpu",
                   min_drop=None, **SILENT)
    want = train_loop(cfg, steps=8, batch=4, seq_len=32, device="cpu",
                      log_every=100)
    assert got["resumed_from"] == 4
    assert len(got["losses"]) == 8
    assert got["losses"] == want["losses"]
