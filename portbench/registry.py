"""Finds what a cell is made of by name, under the benchmark's folder:

- ``workloads/<cell>.json``: its configuration, traffic, chips and the
  limits of its check;
- ``configs/<config>.json``: the model as published and as run;
- ``traffic/<traffic>.json``: the traffic's parameters, and the runner
  that drives it (``"runner"``);
- ``runners/<runner>.py``: ``run(run, cell, seed, seconds, traced, dev,
  t_proc) -> harness.Outcome``: the program, its window and its check;
- ``metrics/<metric>.py``: a reader, ``read(run) -> float | None``;
- ``counts/<op>.py`` (``::`` in the op's name as ``.``): its work,
  ``work(dims, types, scalars) -> {"flops", "bytes", "peak"}``;
- ``peaks.json``: the device's peaks, by its name.

Which metrics a cell reports comes from ``BENCHMARK.json`` beside the
folder: the ``end_to_end`` (``--trace 0``) or ``per_layer`` (``--trace
1``) entries, as ``metrics_for`` reads them.
"""
from __future__ import annotations

import importlib.util
import json
import sys
from pathlib import Path
from typing import List

ROOT = Path(__file__).resolve().parent


class Registry:
    def __init__(self, root: Path = ROOT, bench_json: Path = None):
        self.root = Path(root)
        self.bench_json = (Path(bench_json) if bench_json is not None
                           else self.root.parent / "BENCHMARK.json")

    def _json(self, kind: str, name: str) -> dict:
        path = self.root / kind / f"{name}.json"
        if not path.is_file():
            raise FileNotFoundError(f"no {kind[:-1]} named {name!r} "
                                    f"({path})")
        return json.loads(path.read_text())

    def cell(self, name: str) -> dict:
        return self._json("workloads", name)

    def config(self, name: str) -> dict:
        return self._json("configs", name)

    def traffic(self, name: str) -> dict:
        return self._json("traffic", name)

    def peaks(self, device_kind: str):
        return json.loads((self.root / "peaks.json").read_text()).get(
            device_kind)

    def _module(self, kind: str, name: str):
        path = self.root / kind / f"{name}.py"
        if not path.is_file():
            raise FileNotFoundError(f"no {kind} module named {name!r} "
                                    f"({path})")
        spec = importlib.util.spec_from_file_location(
            f"portbench.{kind}._{name.replace('.', '_').replace('-', '_')}",
            path)
        mod = importlib.util.module_from_spec(spec)
        sys.modules[spec.name] = mod   # for dataclasses' look-ups
        spec.loader.exec_module(mod)
        return mod

    def runner(self, name: str):
        return self._module("runners", name)

    def metric(self, name: str):
        return self._module("metrics", name)

    def count(self, op: str):
        return self._module("counts", op.replace("::", "."))

    def metrics_for(self, cell: str, trace: bool) -> List[dict]:
        """The metric entries ``cell`` reports in a run of this kind: those
        that list it under ``workloads``; of those that list none, every
        end-to-end metric, and every per-layer metric whose end-to-end
        metric (``moves``) the cell reports."""
        bench = json.loads(self.bench_json.read_text())

        def listed(m):
            return "workloads" not in m or cell in m["workloads"]
        e2e = {m["name"] for m in bench["end_to_end"] if listed(m)}
        if not trace:
            return [m for m in bench["end_to_end"] if m["name"] in e2e]
        return [m for m in bench["per_layer"]
                if cell in m.get("workloads", ())
                or ("workloads" not in m and m["moves"] in e2e)]
