"""The harness end to end on the CPU at smoke size: the port's plain
kernel versions against the plain reference, and the result line."""
import json
import os
import shutil
import subprocess
import sys

import pytest
import torch

from portbench import harness
from portbench.registry import ROOT
from portbench.tests._smoke import SEED, SMOKE_CELLS, smoke_registry

RESULT_KEYS = ["correct", "attempted", "failed", "metrics", "device"]


@pytest.fixture(scope="module")
def reg(tmp_path_factory):
    torch.set_num_threads(2)
    return smoke_registry(tmp_path_factory.mktemp("smoke"))


@pytest.mark.parametrize("cell", SMOKE_CELLS)
@pytest.mark.parametrize("traced", [False, True])
def test_smoke_cell_prints_the_result_line(reg, cell, traced, capsys):
    result = harness.run_cell(cell, SEED, 5.0, traced, "cpu", reg)
    harness.emit(result)
    out, err = capsys.readouterr()
    line = json.loads(out.strip().splitlines()[-1])
    extra = ["breakdown"] if traced else []
    assert list(line) == RESULT_KEYS + extra + ["check"]
    assert line["correct"] is True
    assert line["attempted"] >= 1 and line["failed"] == 0
    names = {m["name"] for m in reg.metrics_for(cell, traced)}
    assert set(line["metrics"]) <= names
    if not traced:
        assert {"train_tokens_per_s", "setup_s"} <= set(line["metrics"])
    else:
        assert "input_wait_ms.train" in line["metrics"]
        assert {"busy_s", "window_s"} <= set(line["device"])
    assert set(line["check"]) == {"rows_mismatch", "repeated_rows",
                                  "loss_gap", "grad_gap", "update_gap"}
    tail = err.strip().splitlines()[-len(line["check"]):]
    assert [t.split()[1] for t in tail] == list(line["check"])


def _run_py(cwd, *args):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["CUDA_VISIBLE_DEVICES"] = ""
    return subprocess.run([sys.executable, "portbench/run.py", *args],
                          cwd=cwd, env=env, capture_output=True, text=True,
                          timeout=300)


def test_run_refuses_without_a_card():
    p = _run_py(ROOT.parent, "--workload", "stablelm-3b.train.b8x2k",
                "--seed", str(SEED), "--seconds", "1", "--trace", "0")
    assert p.returncode != 0 and p.stdout == ""


def test_run_refuses_without_the_port(tmp_path):
    shutil.copytree(ROOT, tmp_path / "portbench")
    shutil.copy(ROOT.parent / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    p = _run_py(tmp_path, "--workload", "stablelm-3b.train.b8x2k",
                "--seed", "1", "--seconds", "1", "--trace", "0")
    assert p.returncode != 0 and p.stdout == ""


@pytest.mark.cuda
def test_smoke_cell_on_the_card(tmp_path):
    """The smoke cells through the port's CUDA kernels (card only)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the port's kernels run only there")
    reg = smoke_registry(tmp_path)
    for cell in SMOKE_CELLS:
        assert harness.run_cell(cell, SEED, 0.5, True, "cuda",
                                reg)["correct"] is True

