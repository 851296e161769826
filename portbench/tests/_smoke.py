"""Shared set-up of the benchmark's CPU tests: a registry over a copy of
the benchmark's runners, readers and counts with the smoke cells of ``data/``
(stablelm-3b's and falcon-mamba-7b's layers at smoke widths, computed in
bfloat16 as the real cells are), and a ``BENCHMARK.json`` of its own."""
from __future__ import annotations

import json
import shutil
from pathlib import Path

from portbench.registry import ROOT, Registry

DATA = Path(__file__).resolve().parent / "data"
SMOKE_CELLS = ("stablelm-smoke.train.smoke", "falcon-mamba-smoke.train.smoke")
SEED = 2**31 + 11
STANDS_IN = {"stablelm-3b.": SMOKE_CELLS[0], "falcon-mamba-7b.": SMOKE_CELLS[1]}


def smoke_registry(tmp: Path) -> Registry:
    for kind in ("metrics", "counts", "runners"):
        shutil.copytree(ROOT / kind, tmp / kind)
    shutil.copy(ROOT / "peaks.json", tmp / "peaks.json")
    for kind in ("configs", "traffic", "workloads"):
        shutil.copytree(DATA / kind, tmp / kind)
    bench = json.loads((ROOT.parent / "BENCHMARK.json").read_text())
    # each smoke cell stands in for the cells of its configuration
    for m in bench["end_to_end"] + bench["per_layer"]:
        for prefix, smoke in STANDS_IN.items():
            if any(w.startswith(prefix) for w in m.get("workloads", ())):
                m["workloads"].append(smoke)
    (tmp / "BENCHMARK.json").write_text(json.dumps(bench))
    return Registry(tmp, tmp / "BENCHMARK.json")
