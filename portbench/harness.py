"""One run of a cell: what every kind of traffic shares.  The cell's
traffic file names its runner (``"runner"``), which ``Registry`` finds as
``runners/<runner>.py``: the runner builds the program, runs set-up, the
measured window and, with ``--trace 1``, the traced steps, checks what
the window produced against the plain reference, and hands back an
``Outcome``.  The harness then reads the cell's metrics from the ``Run``
the runner filled and prints the result line.
"""
from __future__ import annotations

import json
import math
import sys
import time
from dataclasses import dataclass
from typing import Dict, List, Optional

import torch

from .reference.follow import model_module
from .registry import Registry

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


@dataclass
class Run:
    """What a metric reader reads; the runner fills ``setup_s``,
    ``window`` (its own record of the measured window) and ``trace``."""
    name: str
    config: dict
    traffic: dict
    registry: Registry
    device_kind: str
    setup_s: float = 0.0
    window: Optional[object] = None
    trace: Optional[dict] = None

    @property
    def peaks(self):
        return self.registry.peaks(self.device_kind)

    @property
    def model(self):
        return model_module(self.config)


@dataclass
class Outcome:
    """What a runner hands back for the result line: ``check`` maps each
    number compared to its value and its limit, in the order printed."""
    correct: bool
    attempted: int
    failed: int
    memory_peak_bytes: int
    check: Dict[str, dict]


def log(msg: str) -> None:
    print(f"[portbench {time.strftime('%H:%M:%S')}] {msg}", file=sys.stderr,
          flush=True)


def run_cell(name: str, seed: int, seconds: float, traced: bool,
             device: str = "cuda", registry: Optional[Registry] = None,
             process_start: Optional[float] = None) -> dict:
    """One run; returns the result object that ``emit`` prints."""
    t_proc = process_start if process_start is not None else time.time()
    reg = registry or Registry()
    cell = reg.cell(name)
    tr = reg.traffic(cell["traffic"])
    dev = torch.device(device)
    kind = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
            else "cpu")
    run = Run(name, reg.config(cell["config"]), tr, reg, kind)
    log(f"{name} on {kind}: {time.time() - t_proc:.2f} s after start")
    out = reg.runner(tr["runner"]).run(run, cell, seed, seconds, traced,
                                       dev, t_proc)
    metrics = {}
    for m in reg.metrics_for(name, traced):
        v = reg.metric(m["name"]).read(run)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    result = {
        "correct": out.correct, "attempted": out.attempted,
        "failed": out.failed, "metrics": metrics,
        "device": {"platform": "gpu" if dev.type == "cuda" else dev.type,
                   "kind": kind, "count": 1,
                   "memory_peak_bytes": out.memory_peak_bytes}}
    if traced and run.trace is not None:
        result["device"]["busy_s"] = run.trace["busy_s"]
        result["device"]["window_s"] = run.trace["window_s"]
        result["breakdown"] = {"device_ops": run.trace["device_ops"],
                               "idle_gaps": run.trace["idle_gaps"]}
    result["check"] = out.check
    return result


def loaded_forbidden() -> List[str]:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def main(argv=None, process_start: Optional[float] = None) -> int:
    import argparse
    ap = argparse.ArgumentParser(description="Run one cell of the port's "
                                 "benchmark.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    if args.seed < 0:
        print("--seed must be a whole number of 0 or more", file=sys.stderr)
        return 2
    reg = Registry()
    cell = reg.cell(args.workload)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell["chips"]:
        print(f"{args.workload} needs {cell['chips']} CUDA device(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    result = run_cell(args.workload, args.seed, args.seconds,
                      bool(args.trace), "cuda", reg, process_start)
    bad = loaded_forbidden()
    if bad:
        print(f"modules loaded that the benchmark must not load: {bad}",
              file=sys.stderr)
        return 3
    emit(result)
    return 0


def emit(result: dict) -> None:
    """The numbers compared, each beside its limit, as the last lines of
    standard error; the result object as the last line of standard
    output."""
    for k, v in result["check"].items():
        print(f"check {k} {v['value']!r} limit {v['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(_finite(result)), flush=True)


def _finite(x):
    """Non-finite numbers as strings, so that the line stays JSON."""
    if isinstance(x, dict):
        return {k: _finite(v) for k, v in x.items()}
    if isinstance(x, list):
        return [_finite(v) for v in x]
    if isinstance(x, float) and not math.isfinite(x):
        return str(x)
    return x
