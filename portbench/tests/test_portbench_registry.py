"""Cells, configurations and metrics are found by name: a new one is new
files alone.  The frozen work counts give PERF.md's bounds, the trace
reader attributes device time to the op that launched it, and the
document packer gives the port's input pipeline's rows."""
import json

import numpy as np
import pytest
import torch

from portbench import docs, harness, trace
from portbench.registry import Registry
from portbench.tests._smoke import DATA, SEED, smoke_registry

H100 = "NVIDIA H100 80GB HBM3"


def test_new_cell_config_and_metric_are_files_alone(tmp_path):
    reg = smoke_registry(tmp_path)
    cj = json.loads((DATA / "configs/stablelm-smoke.json").read_text())
    cj["as_run"]["num_hidden_layers"] = 3
    (tmp_path / "configs/stablelm-deeper.json").write_text(json.dumps(cj))
    tr = json.loads((DATA / "traffic/train.smoke.json").read_text())
    tr["seq_len"], tr["global_batch"] = 48, 2
    (tmp_path / "traffic/train.other.json").write_text(json.dumps(tr))
    cell = {"config": "stablelm-deeper", "traffic": "train.other",
            "chips": 1, "check_steps": 2,
            "limits": {"loss_gap": 5e-4, "grad_gap": 5e-3,
                       "update_gap": 2e-2}}
    (tmp_path / "workloads/stablelm-deeper.train.other.json").write_text(
        json.dumps(cell))
    (tmp_path / "metrics/window_steps.py").write_text(
        "def read(run):\n    return run.window.steps\n")
    bench = json.loads(reg.bench_json.read_text())
    bench["end_to_end"].append({"name": "window_steps", "unit": "steps",
                                "better": "higher", "bound": 0.05,
                                "source": "host_clock",
                                "workloads": ["stablelm-deeper.train.other"]})
    reg.bench_json.write_text(json.dumps(bench))
    torch.set_num_threads(2)
    r = harness.run_cell("stablelm-deeper.train.other", SEED, 5.0, False,
                         "cpu", reg)
    assert r["correct"] is True
    assert r["metrics"]["window_steps"]["value"] >= 1


RUNNER = """
from portbench.harness import Outcome


def run(run, cell, seed, seconds, traced, dev, t_proc):
    run.setup_s = 0.25
    run.window = {"ops": 3 + seed % 2}
    return Outcome(correct=True, attempted=4, failed=0, memory_peak_bytes=0,
                   check={"answers_wrong": {"value": 0, "limit": 0}})
"""


@pytest.mark.parametrize("traced", [False, True])
def test_new_kind_of_traffic_is_a_runner_file_alone(tmp_path, traced):
    """A traffic file names its runner; the harness runs a cell of a new
    kind through it and reads only the metrics the cell reports."""
    reg = smoke_registry(tmp_path)
    (tmp_path / "runners/count.py").write_text(RUNNER)
    (tmp_path / "traffic/ops.json").write_text(json.dumps({"runner":
                                                           "count"}))
    (tmp_path / "workloads/none.ops.json").write_text(json.dumps(
        {"config": "stablelm-smoke", "traffic": "ops", "chips": 1}))
    (tmp_path / "metrics/ops_done.py").write_text(
        "def read(run):\n    return run.window['ops']\n")
    bench = json.loads(reg.bench_json.read_text())
    bench["end_to_end"].append({"name": "ops_done", "unit": "ops",
                                "better": "higher", "bound": 0.05,
                                "source": "host_clock",
                                "workloads": ["none.ops"]})
    reg.bench_json.write_text(json.dumps(bench))
    r = harness.run_cell("none.ops", 1, 0.1, traced, "cpu", reg)
    assert r["correct"] is True and r["attempted"] == 4
    assert r["check"] == {"answers_wrong": {"value": 0, "limit": 0}}
    want = {} if traced else {"ops_done": {"value": 4, "unit": "ops"},
                              "setup_s": {"value": 0.25, "unit": "s"}}
    assert r["metrics"] == want


def test_every_cell_and_metric_of_the_benchmark_is_found():
    reg = Registry()
    bench = json.loads(reg.bench_json.read_text())
    for w in bench["workloads"]:
        cell = reg.cell(w["name"])
        assert (cell["config"], cell["traffic"]) == (w["config"],
                                                     w["traffic"])
        reg.config(cell["config"]), reg.traffic(cell["traffic"])
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert callable(reg.metric(m["name"]).read)
        for op in getattr(reg.metric(m["name"]), "OPS", ()):
            assert callable(reg.count(op).work)


def _bound_ms(op, dims, types, scalars):
    reg = Registry()
    w = reg.count(op).work(dims, types, scalars)
    p = reg.peaks(H100)
    return 1e3 * max(w["flops"] / p[w["peak"]], w["bytes"] / p["hbm_bytes"])


def test_counts_give_the_frozen_bounds():
    bf = "c10::BFloat16"
    q, kv = [4, 2048, 32, 1, 80], [4, 2048, 32, 80]
    ms = _bound_ms("repro_torch::flash_attention", [q, kv, kv, [], [], []],
                   [bf] * 3 + ["Scalar"] * 3, ["", "", "", "True", "0", "0."])
    assert round(ms, 4) == 0.0869
    q, kv, lse = [2, 2048, 32, 1, 80], [2, 2048, 32, 80], [2, 32, 1, 2048]
    ms = _bound_ms("repro_torch::flash_attention_backward",
                   [q, kv, kv, q, lse, q, [], [], []],
                   [bf] * 4 + ["float", bf] + ["Scalar"] * 3,
                   [""] * 6 + ["True", "0", "0."])
    assert round(ms, 4) == 0.1086
    T, d, N = 2048, 8192, 16
    dims = [[1, T, d], [1, T, d], [1, T, N], [1, T, N], [d, N], [1, d, N],
            [1, T // 16, d, N], [1, T, d], [1, d, N]]
    ms = _bound_ms("repro_torch::mamba_scan_backward", dims,
                   [bf, bf] + ["float"] * 7, [""] * 9)
    assert round(ms, 4) == 0.0809


def test_trace_reader_attributes_device_time_to_the_launching_op(tmp_path):
    X = lambda **k: dict(ph="X", **k)
    ev = [X(name="repro_torch::flash_attention", cat="cpu_op", ts=10, dur=10,
            tid=1, args={"Input Dims": [[1]], "Input type": ["float"],
                         "Concrete Inputs": [""]}),
          X(name="aten::empty", cat="cpu_op", ts=11, dur=1, tid=1),
          X(name="cudaLaunchKernel", cat="cuda_runtime", ts=12, dur=1, tid=1,
            args={"correlation": 7}),
          X(name="aten::mul", cat="cpu_op", ts=30, dur=5, tid=1),
          X(name="cudaLaunchKernel", cat="cuda_runtime", ts=31, dur=1, tid=1,
            args={"correlation": 8}),
          X(name="cudaMemcpyAsync", cat="cuda_runtime", ts=45, dur=25, tid=1,
            args={"correlation": 9}),
          X(name="flash_kernel", cat="kernel", ts=20, dur=30, tid=7,
            args={"correlation": 7}),
          X(name="mul_kernel", cat="kernel", ts=40, dur=10, tid=7,
            args={"correlation": 8}),
          X(name="Memcpy DtoH", cat="gpu_memcpy", ts=60, dur=5, tid=7,
            args={"correlation": 9})]
    p = tmp_path / "t.json"
    p.write_text(json.dumps({"traceEvents": ev}))
    calls = trace.op_calls(str(p), ["repro_torch::flash_attention"])
    assert [c["device_s"] for c in calls] == [30e-6]
    t = trace.device_activity(str(p), 100e-6)
    assert t["busy_s"] == pytest.approx(35e-6)
    assert t["window_s"] == 100e-6
    gaps = dict(t["idle_gaps"])
    assert gaps["host in cudaMemcpyAsync"] == pytest.approx(10e-6)
    assert gaps["host before the first launch and after the last"] == \
        pytest.approx(55e-6)


@pytest.mark.parametrize("traffic", ["train.b8x2k", "train.b4x4k"])
def test_docs_pack_the_rows_of_the_port_pipeline(traffic):
    from repro_torch.data import InputPipeline, PipelineConfig
    tr = Registry().traffic(traffic)
    V = 50304
    for seed in (0, SEED):
        pc = PipelineConfig(
            seq_len=tr["seq_len"], global_batch=tr["global_batch"],
            vocab_size=V, max_doc_len=tr["max_doc_len"],
            min_doc_len=tr["min_doc_len"],
            docs_per_window=tr["docs_per_window"],
            num_splits=tr["num_splits"],
            pipeline_degree=tr["pipeline_degree"],
            prefetch_depth=tr["prefetch_depth"], eos_id=tr["eos_id"],
            seed=seed)
        port = InputPipeline(pc)
        for want, _ in zip(docs.global_batches(tr, V, seed), range(12)):
            np.testing.assert_array_equal(next(port), want)
