"""What the harness and the reference load, by each module's top-level
name (the part before the first dot, compared whole): neither loads
``jax`` or the JAX package ``repro``, and the reference loads nothing of
the port ``repro_torch`` either.  Each runs a smoke cell in a process of
its own, so that every module it loads is counted."""
import json
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]

HARNESS = """
import sys, json, tempfile
from pathlib import Path
sys.path[:0] = [{src!r}, {repo!r}]
from portbench import harness
from portbench.tests._smoke import SEED, SMOKE_CELLS, smoke_registry
reg = smoke_registry(Path(tempfile.mkdtemp()))
for cell in SMOKE_CELLS:
    assert harness.run_cell(cell, SEED, 0.2, True, "cpu", reg)["correct"]
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""

REFERENCE = """
import sys, json
from pathlib import Path
sys.path[:0] = [{repo!r}]
from portbench import check, docs, weights
from portbench.reference import common, dense_lm, follow, mamba_lm
data = Path({data!r})
tr = json.loads((data / "traffic/train.smoke.json").read_text())
for name in ("stablelm-smoke", "falcon-mamba-smoke"):
    cj = json.loads((data / "configs" / (name + ".json")).read_text())
    follow.follow(cj, tr, 3, 2, "cpu")
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def _top_level_names(code: str) -> set:
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=600, cwd=REPO)
    assert p.returncode == 0, p.stderr[-3000:]
    return set(json.loads(p.stdout.strip().splitlines()[-1]))


def test_harness_loads_no_jax():
    names = _top_level_names(HARNESS.format(src=str(REPO / "src"),
                                            repo=str(REPO)))
    assert "repro_torch" in names and "portbench" in names
    assert not names & {"jax", "jaxlib", "flax", "repro"}


def test_reference_loads_neither_jax_nor_the_port():
    names = _top_level_names(REFERENCE.format(
        repo=str(REPO), data=str(REPO / "portbench/tests/data")))
    assert "torch" in names
    assert not names & {"jax", "jaxlib", "flax", "repro", "repro_torch"}
