"""Spans and counters of the port's training path (``obs.trace`` inside
``train/train_step.py``, ``data/pipeline.py``, ``data/prefetch.py`` and
``launch/train.py``): the span tree of a train step, one contextvar read
a step and bit-identical outputs with tracing off, the prefetch thread's
spans reaching the tracer the queue was built under, and a traced
``train_loop`` read by ``obs.report``."""
import json
import threading

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.data import InputPipeline, PipelineConfig, PrefetchQueue
from repro_torch.launch.train import train_loop
from repro_torch.models import transformer as tf
from repro_torch.obs import report, trace
from repro_torch.train.optimizer import (OptConfig, init_opt_state, n_pieces,
                                         tree_leaves)
from repro_torch.train.train_step import make_train_step


class CountingVar:
    """``trace.ACTIVE`` that counts its reads."""

    def __init__(self, var):
        self.var, self.reads = var, 0
        self._lock = threading.Lock()

    def get(self):
        with self._lock:
            self.reads += 1
        return self.var.get()

    def set(self, value):
        return self.var.set(value)

    def reset(self, token):
        self.var.reset(token)


@pytest.fixture
def reads(monkeypatch):
    var = CountingVar(trace.ACTIVE)
    monkeypatch.setattr(trace, "ACTIVE", var)
    return var


@pytest.fixture
def tracers_made(monkeypatch):
    made = []
    init = trace.Tracer.__init__

    def counted(self, *a, **kw):
        made.append(self)
        init(self, *a, **kw)
    monkeypatch.setattr(trace.Tracer, "__init__", counted)
    return made


def _setup(arch, seed=0):
    cfg = get_config(arch, smoke=True).replace(
        attn_impl="reference", ssm_impl="reference", grad_accum=2)
    p = tf.init_params(cfg, seed=seed, device="cpu")
    g = torch.Generator().manual_seed(seed)
    b = {"tokens": torch.randint(0, cfg.vocab_size, (4, 16), generator=g)}
    return cfg, p, init_opt_state(p, cfg), b


def _leaves_a_pass(params) -> int:
    """The accumulator's hooks a backward: a stacked block leaf binds one
    leaf a layer."""
    return sum(x.shape[0] if k == "blocks" else 1
               for k, v in params.items() for x in tree_leaves(v))


def _within(inner, outer) -> bool:
    return (outer["ts"] <= inner["ts"]
            and inner["ts"] + inner["dur"] <= outer["ts"] + outer["dur"])


@pytest.mark.parametrize("arch", ["stablelm-3b", "falcon-mamba-7b"])
def test_train_step_span_tree(arch):
    cfg, p, opt, b = _setup(arch)
    step = make_train_step(cfg, OptConfig())
    tr = trace.Tracer(measuring=True)
    with trace.trace_scope(tr):
        for _ in range(2):
            p, opt, _ = step(p, opt, b)
    ev = [e for e in tr.events if e["cat"] in ("train", "model")]
    assert {e["tid"] for e in ev} == {threading.get_native_id()}
    for s in (0, 1):
        mine = [e for e in ev if e["args"]["step"] == s]
        by = {}
        for e in mine:
            by.setdefault(e["name"], []).append(e)
        (top,) = by["train.step"]
        assert top["args"]["microbatches"] == 2
        assert [m["args"]["k"] for m in by["train.microbatch"]] == [0, 1]
        for name in ("model.forward", "model.backward"):
            assert [e["args"]["k"] for e in by[name]] == [0, 1]
            for e, mb in zip(by[name], by["train.microbatch"]):
                assert _within(e, mb)
        fwd, bwd = by["model.forward"], by["model.backward"]
        assert all(f["ts"] + f["dur"] <= b_["ts"] for f, b_ in zip(fwd, bwd))
        assert all(_within(m, top) for m in by["train.microbatch"])
        (upd,) = by["train.update"]
        assert _within(upd, top)
        assert upd["ts"] >= by["train.microbatch"][-1]["ts"] \
            + by["train.microbatch"][-1]["dur"]
        assert upd["args"]["pieces"] == n_pieces(p)
        adds = by["train.grad_accum"]
        assert len(adds) == 2 * _leaves_a_pass(p)
        assert all(any(_within(a, bw) for bw in bwd) for a in adds)
    kind = "mamba_layers" if arch == "falcon-mamba-7b" else "attn_layers"
    assert tr.metrics.snapshot()["counters"] == {
        "train_steps": 2, "grad_accum_adds": 4 * _leaves_a_pass(p),
        "adamw_pieces": 2 * n_pieces(p), kind: 2 * 2 * cfg.n_layers}


def test_untraced_step_reads_one_contextvar_and_matches(reads, tracers_made):
    """With no scope open a step reads one contextvar (however many
    microbatches and hooks), makes no tracer and emits nothing; its
    params, moments and metrics are bit-identical to a traced step's."""
    out = {}
    for traced in (True, False):
        cfg, p, opt, b = _setup("stablelm-3b", seed=1)
        step = make_train_step(cfg, OptConfig(warmup_steps=1))
        if traced:
            with trace.trace_scope(trace.Tracer()) as tr:
                out[traced] = step(p, opt, b)
            assert tr.events
            tracers_made.clear()
        else:
            before = reads.reads
            out[traced] = step(p, opt, b)
            assert reads.reads - before == 1
    assert tracers_made == []
    (p1, o1, m1), (p0, o0, m0) = out[True], out[False]
    for x, y in zip(tree_leaves(p1) + tree_leaves(o1["m"])
                    + tree_leaves(o1["v"]),
                    tree_leaves(p0) + tree_leaves(o0["m"])
                    + tree_leaves(o0["v"])):
        assert torch.equal(x, y)
    assert m1.keys() == m0.keys()
    assert all(torch.equal(m1[k], m0[k]) for k in m1)


def _pipe(**over):
    kw = dict(seq_len=32, global_batch=4, vocab_size=300, max_doc_len=48,
              min_doc_len=4, docs_per_window=16, num_splits=2,
              pipeline_degree=2, prefetch_depth=2, seed=5)
    kw.update(over)
    return PipelineConfig(**kw)


def test_prefetch_queue_spans_reach_its_creators_tracer():
    """The producer thread runs under the creator's context: the refills
    (and the ETL engine's own spans) and each batch's staging land in the
    tracer in scope where the queue was built; the k-th get carries the
    k-th staged batch's ordinal."""
    pc = _pipe()
    staged = []

    def stage(blk):
        staged.append({"tokens": torch.as_tensor(blk)})
        return staged[-1]
    tr = trace.Tracer(measuring=True)
    with trace.trace_scope(tr):
        feed = PrefetchQueue(iter(InputPipeline(pc)), depth=2,
                             stage_fn=stage)
    got = [next(feed) for _ in range(6)]      # taken outside the scope
    feed.close()
    assert [id(g) for g in got] == [id(s) for s in staged[:6]]
    main = threading.get_native_id()
    refills = [e for e in tr.events if e["name"] == "data.refill"]
    stages = [e for e in tr.events if e["name"] == "data.stage"]
    assert refills and stages
    assert [e["args"]["window"] for e in refills] == list(range(len(refills)))
    assert all(e["args"]["rows"] > 0 and e["cat"] == "data" for e in refills)
    assert [e["args"]["batch"] for e in stages] == list(range(len(stages)))
    assert all(e["cat"] == "transfer" and e["args"]["bytes"] == 4 * 33 * 4
               for e in stages)
    assert {e["tid"] for e in refills + stages} == {feed._thread.native_id}
    assert feed._thread.native_id != main
    assert any(e["cat"] == "phase" for e in tr.events)    # the engine's
    c = tr.metrics.snapshot()["counters"]
    assert c["data_refills"] == len(refills)
    assert c["h2d_transfers"] == len(stages)
    assert not any(e["name"] == "prefetch.get" for e in tr.events)

    tr2 = trace.Tracer()
    feed = PrefetchQueue(iter(range(5)), depth=2, stage_fn=lambda x: x * 10)
    with trace.trace_scope(tr2):
        got = list(feed)
    assert got == [0, 10, 20, 30, 40]
    gets = [e for e in tr2.events if e["name"] == "prefetch.get"]
    assert [e["args"]["batch"] for e in gets] == [0, 1, 2, 3, 4, 5]  # + EOS
    assert all(e["cat"] == "wait" and e["tid"] == main for e in gets)
    assert all(0 <= e["args"]["depth"] <= 3 for e in gets)


def test_untraced_prefetch_reads_one_contextvar_a_site(reads, tracers_made):
    feed = PrefetchQueue(iter(range(3)), depth=4, stage_fn=lambda x: x + 1)
    assert list(feed) == [1, 2, 3]
    feed._thread.join(timeout=10)
    assert not feed._thread.is_alive()
    assert reads.reads == 3 + 4        # 3 stagings, 4 gets (EOS included)
    before = reads.reads
    pipe = InputPipeline(_pipe())
    pipe._refill()
    assert tracers_made == []
    assert reads.reads - before >= 1   # the refill's, then the engine's own


def test_train_loop_exports_its_run_under_repro_trace(tmp_path, monkeypatch,
                                                      tracers_made):
    cfg = get_config("stablelm-3b", smoke=True).replace(
        attn_impl="reference", grad_accum=2)
    kw = dict(steps=2, batch=4, seq_len=16, log_every=100, device="cpu")
    path = tmp_path / "train.json"
    monkeypatch.setenv("REPRO_TRACE_PATH", str(path))
    monkeypatch.delenv("REPRO_TRACE", raising=False)
    train_loop(cfg, **kw)
    assert tracers_made == [] and not path.exists()

    monkeypatch.setenv("REPRO_TRACE", "1")
    res = train_loop(cfg, **kw)
    assert np.isfinite(res["losses"]).all()
    payload = json.loads(path.read_text())
    runs = report.analyze(payload)["runs"]
    (run,) = [r for r in runs if r["meta"].get("flow") == "train"]
    assert run["meta"]["steps"] == 2 and run["meta"]["arch"] == cfg.name
    counters = run["meta"]["counters"]
    assert counters["train_steps"] == 2 and counters["data_refills"] >= 1
    assert counters["grad_accum_adds"] == 2 * 2 * _leaves_a_pass(
        res["params"])
    spans = run["spans"]
    assert spans["train.step"]["calls"] == 2
    assert spans["model.forward"]["calls"] == spans["model.backward"][
        "calls"] == 4
    assert spans["data.refill"]["calls"] >= 1
    assert run["waits"]["prefetch.get"] > 0
    assert run["transfers"]["data.stage"]["count"] >= 2
    assert {"train", "model", "data"} <= set(run["categories"])
    text = report.render(report.analyze(payload))
    assert "train.step" in text and "model.backward" in text
