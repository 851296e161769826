"""The hybrid cell's smoke stand-in (``jamba2-smoke``: AI21-Jamba2-3B's
stack at smoke widths, two periods of four layers) through the harness on
the CPU: ``correct`` with the port's plain kernel versions, and not
correct for the float8 control, the half batch, the scan's states dropped
or the mixer's dt, B and C norms left out.  Then the program's
``model.layer`` spans as ``layer_spans.tracer()`` names them, and the two
layer readers.

Limits of the smoke cell (its workload file), from the CPU's readings on
four seeds: the program's ``loss_gap`` 1.9e-5 to 2.6e-5, ``grad_gap``
0.0058 to 0.0092 (bf16 products; x_proj's gradient through the dt/B/C
norms leads), ``update_gap`` 0.0034 to 0.0073; the float8 control's
``grad_gap`` 0.031 to 0.033."""
import json
import subprocess
import sys
from types import SimpleNamespace

import pytest
import torch

from portbench import check, harness, layer_spans
from portbench.reference.follow import follow
from portbench.tests._smoke import DATA, SEED, smoke_registry

CELL = "jamba2-smoke.train.smoke"

REFERENCE = """
import sys, json
from pathlib import Path
sys.path[:0] = [{repo!r}]
from portbench.reference import follow, hybrid_lm
data = Path({data!r})
tr = json.loads((data / "traffic/train.smoke.json").read_text())
cj = json.loads((data / "configs/jamba2-smoke.json").read_text())
follow.follow(cj, tr, 3, 2, "cpu", prec="mixer_norms_dropped")
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


@pytest.fixture(scope="module")
def reg(tmp_path_factory):
    """The smoke registry, the smoke cell standing in for the hybrid
    cell in the metrics that list it."""
    torch.set_num_threads(2)
    reg = smoke_registry(tmp_path_factory.mktemp("hybrid"))
    bench = json.loads(reg.bench_json.read_text())
    for m in bench["end_to_end"] + bench["per_layer"]:
        if any(w.startswith("jamba2-3b.") for w in m.get("workloads", ())):
            m["workloads"].append(CELL)
    reg.bench_json.write_text(json.dumps(bench))
    return reg


@pytest.mark.parametrize("traced", [False, True])
def test_hybrid_smoke_cell_is_correct(reg, traced):
    result = harness.run_cell(CELL, SEED, 2.0, traced, "cpu", reg)
    assert result["correct"] is True, result["check"]
    assert result["attempted"] >= 1 and result["failed"] == 0
    if not traced:
        assert {"train_tokens_per_s", "setup_s"} <= set(result["metrics"])


@pytest.mark.parametrize("variant", [{"prec": "fp8"}, {"drop_half": True},
                                     {"prec": "scan_dropped"},
                                     {"prec": "mixer_norms_dropped"}])
def test_controls_and_faults_are_not_correct(reg, variant):
    c = reg.cell(CELL)
    cj, tr = reg.config(c["config"]), reg.traffic(c["traffic"])
    ref = follow(cj, tr, SEED, c["check_steps"], "cpu")
    got = follow(cj, tr, SEED, c["check_steps"], "cpu", **variant)
    values = dict(check.numbers(got, ref), rows_mismatch=0, repeated_rows=0)
    assert not check.verdict(values, c["limits"]), (variant, values)


def test_layer_spans_are_named_by_kind_and_phase(reg):
    """One traced step of the smoke cell's program under
    ``layer_spans.tracer()``: every layer's three phases, named by kind."""
    from portbench.runners.train import port_config
    from repro_torch.models import transformer as tf
    from repro_torch.obs import trace
    from repro_torch.train.optimizer import OptConfig, init_opt_state
    from repro_torch.train.train_step import make_train_step
    cfg = port_config(reg.config("jamba2-smoke"))
    params = tf.init_params(cfg, seed=0, device="cpu")
    tr = layer_spans.tracer(measuring=True)
    with trace.trace_scope(tr):
        make_train_step(cfg, OptConfig())(
            params, init_opt_state(params, cfg),
            {"tokens": torch.randint(0, cfg.vocab_size, (2, 16))})
    names = [e["name"] for e in tr.events if e["cat"] == "model"
             and e["name"].startswith(layer_spans.SPAN)]
    kinds = [cfg.layer_kind(i) for i in range(cfg.n_layers)]
    want = {layer_spans.key(k, p): cfg.grad_accum * kinds.count(k)
            for k in layer_spans.KINDS for p in layer_spans.PHASES}
    assert {n: names.count(n) for n in set(names)} == want
    assert layer_spans.SPAN not in names


def test_layer_readers_sum_their_kinds_phases(reg):
    device_s = {layer_spans.key(k, p): s for k, s0 in (("attn", 1e-3),
                                                       ("mamba", 1e-2))
                for p, s in zip(layer_spans.PHASES, (s0, 2 * s0, 4 * s0))}
    attr = {"aligned": True, "steps": 2, "device_s": device_s}
    run = SimpleNamespace(trace={"program": {"attribution": attr}})
    assert reg.metric("attn_layers_device_ms.train").read(run) \
        == pytest.approx(3.5)
    assert reg.metric("mamba_layers_device_ms.train").read(run) \
        == pytest.approx(35.0)
    # no program session, or one unaligned: nothing
    for trace in (None, {"program": {"attribution": {"aligned": False}}}):
        run = SimpleNamespace(trace=trace)
        for name in ("attn_layers_device_ms.train",
                     "mamba_layers_device_ms.train"):
            assert reg.metric(name).read(run) is None


def test_hybrid_reference_loads_neither_jax_nor_the_port():
    p = subprocess.run([sys.executable, "-c", REFERENCE.format(
        repo=str(DATA.parents[2]), data=str(DATA))], capture_output=True,
        text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-3000:]
    names = set(json.loads(p.stdout.strip().splitlines()[-1]))
    assert "torch" in names
    assert not names & {"jax", "jaxlib", "flax", "repro", "repro_torch"}
