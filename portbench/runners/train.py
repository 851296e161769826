"""The runner of training traffic: set-up, the measured window, the traced
steps and the check against the reference.

Set-up builds the port's training step with its model and optimizer
state, from weights the benchmark makes from the seed (``weights``), and
the port's input pipeline (``InputPipeline`` behind ``PrefetchQueue``,
staged to the device as ``launch/train.py`` stages it).  It drives that
same step through the cell's first ``check_steps`` steps, which also warm
every shape, and reads what the check compares: the losses, the first
gradient as AdamW took it (its first moment over ``1 - b1``) and each
leaf's change.  The window then runs the same step on the same feed for
``--seconds``, the loss read to the host each step as ``train_loop``
reads it.  With ``--trace 1`` three more steps run under two profiler
sessions (``_traced_steps``).  Once the program's state is freed the
reference follows the first steps (``reference.follow``) and ``check``
compares.
"""
from __future__ import annotations

import gc
import math
import os
import tempfile
import time
from dataclasses import dataclass, field
from typing import Dict, List

import numpy as np
import torch

from portbench import check as checks
from portbench import docs, trace
from portbench.harness import Outcome, log
from portbench.reference.follow import follow, model_module
from portbench.weights import layer_slices, make_leaves


@dataclass
class Window:
    """The measured window: steps that ended inside it and their times."""
    tokens_per_step: int
    ends: List[float] = field(default_factory=list)   # from the start, s
    waits: List[float] = field(default_factory=list)  # next(feed), s
    started: int = 0
    failed: int = 0
    peak_bytes: int = 0

    @property
    def steps(self) -> int:
        return len(self.ends)

    @property
    def tokens(self) -> int:
        return self.steps * self.tokens_per_step


def port_config(cj: dict):
    """The port's ``ModelConfig`` of a configuration file: the port's
    architecture with the widths, depth, dtypes and microbatches the file
    states."""
    from repro_torch.configs import get_config
    fields = model_module(cj).port_fields(cj)
    return get_config(cj["port_arch"]).replace(
        grad_accum=cj["microbatches"], **fields)


def _assign(tree: dict, path: str, val) -> None:
    *parents, last = path.split(".")
    for p in parents:
        tree = tree.setdefault(p, {})
    tree[last] = val


def _flatten(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flatten(v, f"{prefix}{k}.")
    else:
        yield prefix[:-1], tree


def build_params(cj: dict, cfg, seed: int, device) -> dict:
    """The port's parameter tree holding the benchmark's weights, in the
    configuration's ``param_dtype``."""
    from repro_torch.models.layers import dt
    from repro_torch.models.transformer import param_shapes
    want = dict(_flatten(param_shapes(cfg)))
    pdt = dt(cfg.param_dtype)
    tree: dict = {}
    for path, x in make_leaves(model_module(cj).leaf_specs(cj), seed,
                               device):
        if path not in want or tuple(want[path].shape) != tuple(x.shape):
            raise ValueError(f"{path}: the reference's leaf {tuple(x.shape)}"
                             f" is not the port's "
                             f"{tuple(want[path].shape) if path in want else 'none'}")
        _assign(tree, path, x.to(pdt))
        del want[path]
    if want:
        raise ValueError(f"the reference makes no weights for {sorted(want)}")
    return tree


def _leaf_norms(tree, scale: float = 1.0) -> Dict[str, float]:
    return {name: float(torch.linalg.vector_norm(t.float())) * scale
            for path, x in _flatten(tree)
            for name, t in layer_slices(path, x)}


def _delta_norms(params, specs, seed, device) -> Dict[str, float]:
    cur = dict(_flatten(params))
    out = {}
    for path, x0 in make_leaves(specs, seed, device):
        for (name, t), (_, t0) in zip(layer_slices(path, cur[path]),
                                      layer_slices(path, x0)):
            out[name] = float(torch.linalg.vector_norm(t.float() - t0))
    return out


class Program:
    """The port's training step with its state and its feed, as
    ``launch/train.py``'s ``train_loop`` composes them, on the
    benchmark's weights and the run's seed."""

    def __init__(self, cj: dict, tr: dict, seed: int, dev: torch.device):
        from repro_torch.data import (InputPipeline, PipelineConfig,
                                      PrefetchQueue, make_lm_batch_fn)
        from repro_torch.launch.train import to_device
        from repro_torch.train.optimizer import OptConfig, init_opt_state
        from repro_torch.train.train_step import make_train_step
        self.cj, self.seed, self.dev = cj, seed, dev
        self.opt = tr["optimizer"]
        cfg = port_config(cj)
        ocfg = OptConfig(**{k: self.opt[k] for k in (
            "lr", "min_lr_frac", "warmup_steps", "total_steps", "b1", "b2",
            "eps", "weight_decay", "grad_clip")})
        self.params = build_params(cj, cfg, seed, dev)
        self.opt_state = init_opt_state(self.params, cfg)
        self.step_fn = make_train_step(cfg, ocfg)
        pc = PipelineConfig(
            seq_len=tr["seq_len"], global_batch=tr["global_batch"],
            vocab_size=cfg.vocab_size, max_doc_len=tr["max_doc_len"],
            min_doc_len=tr["min_doc_len"],
            docs_per_window=tr["docs_per_window"],
            num_splits=tr["num_splits"],
            pipeline_degree=tr["pipeline_degree"],
            prefetch_depth=tr["prefetch_depth"], eos_id=tr["eos_id"],
            seed=seed)
        to_model = make_lm_batch_fn(cfg)
        self.feed = PrefetchQueue(
            iter(InputPipeline(pc)), depth=pc.prefetch_depth,
            stage_fn=lambda blk: to_device(to_model(blk), dev))
        self.batch = None

    def step(self):
        """One step: (seconds waited for the batch, the loss on the
        host)."""
        t = time.perf_counter()
        self.batch = next(self.feed)
        wait = time.perf_counter() - t
        self.params, self.opt_state, met = self.step_fn(
            self.params, self.opt_state, self.batch)
        return wait, float(met["loss"])

    def first_steps(self, n: int, t_proc: float):
        """The check's ``n`` steps (which also warm every shape): what
        the check compares, and the token rows the steps took."""
        readings, rows = {"losses": []}, []
        for k in range(n):
            _, loss = self.step()
            rows.append(self.batch["tokens"].cpu().numpy())
            readings["losses"].append(loss)
            log(f"check step {k}: loss {loss!r}, "
                f"{time.time() - t_proc:.2f} s after start")
            if k == 0:
                readings["grad_norms"] = _leaf_norms(
                    self.opt_state["m"], 1.0 / (1.0 - self.opt["b1"]))
        readings["delta_norms"] = _delta_norms(
            self.params, model_module(self.cj).leaf_specs(self.cj),
            self.seed, self.dev)
        return readings, np.concatenate(rows)

    def close(self) -> None:
        """Stop the feed and free the state."""
        self.feed.close()
        self.params = self.opt_state = self.step_fn = self.batch = None
        self.feed = None
        gc.collect()
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()


def reference_rows(cj: dict, tr: dict, seed: int, n: int) -> np.ndarray:
    """The token rows of the first ``n`` global batches, as ``docs``
    packs them."""
    return np.concatenate([b[:, :-1] for b, _ in zip(
        docs.global_batches(tr, cj["as_run"]["vocab_size"], seed),
        range(n))])


def run(run, cell: dict, seed: int, seconds: float, traced: bool,
        dev: torch.device, t_proc: float) -> Outcome:
    """One run of a training cell: fills ``run``'s set-up time, window
    and trace, and returns what the result line needs."""
    cj, tr, reg = run.config, run.traffic, run.registry
    n_check = cell["check_steps"]
    prog = Program(cj, tr, seed, dev)
    log(f"state built, {time.time() - t_proc:.2f} s after start")
    try:
        program, rows = prog.first_steps(n_check, t_proc)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
            torch.cuda.reset_peak_memory_stats(dev)
            before = _allocator(dev)
        win = Window(tr["seq_len"] * tr["global_batch"])
        t0 = time.perf_counter()
        run.setup_s = time.time() - t_proc
        while time.perf_counter() - t0 < seconds:
            wait, loss = prog.step()
            end = time.perf_counter() - t0
            win.started += 1
            win.failed += not math.isfinite(loss)
            if end <= seconds:
                win.ends.append(end)
                win.waits.append(wait)
        if dev.type == "cuda":
            win.peak_bytes = torch.cuda.max_memory_allocated(dev)
            after = _allocator(dev)
            log("allocator over the window: " + ", ".join(
                f"{k} {after[k] - before.get(k, 0)}" for k in after)
                + f"; reserved peak "
                f"{torch.cuda.memory_stats(dev)['reserved_bytes.all.peak']}")
        run.window = win
        log(f"window: {win.steps} steps in {seconds} s (started "
            f"{win.started}), ends {[round(e, 4) for e in win.ends]}, "
            f"peak {win.peak_bytes}")
        if traced:
            run.trace = _traced_steps(prog, reg, run.name)
    finally:
        prog.close()

    # the check, once the program's state is freed
    values = checks.row_numbers(rows, reference_rows(cj, tr, seed, n_check))
    t_ref = time.perf_counter()
    reference = follow(cj, tr, seed, n_check, dev)
    log(f"reference: {time.perf_counter() - t_ref:.2f} s, losses "
        f"{reference['losses']} against {program['losses']}"
        + (f", device peak {torch.cuda.max_memory_allocated(dev)}"
           if dev.type == "cuda" else ""))
    values.update(checks.numbers(program, reference))
    limits = dict(cell["limits"])
    correct = checks.verdict(values, limits)
    limits.update({k: 0 for k in checks.EXACT})
    return Outcome(correct=correct, attempted=win.started,
                   failed=win.failed, memory_peak_bytes=win.peak_bytes,
                   check={k: {"value": values[k], "limit": limits[k]}
                          for k in (*checks.EXACT, *cell["limits"])})


def _allocator(dev) -> Dict[str, int]:
    """The caching allocator's counts of retries after a failed
    allocation, of ``cudaMalloc`` calls and of ``cudaFree`` calls."""
    st = torch.cuda.memory_stats(dev)
    return {k: st.get(k, 0) for k in ("num_alloc_retries",
                                      "num_device_alloc",
                                      "num_device_free")}


def _traced_steps(prog: Program, reg, name: str) -> dict:
    """Three more steps under two profiler sessions.  The first session
    records device activity alone, whose cost to the host is small: a
    warm-up step, then the traced step, timed on the host from a
    synchronised device to a synchronised device (busy time, the largest
    items, idle gaps).  The second also records the host's ops with
    their shapes over one step: each registered op's calls and device
    time, for the kernels' rooflines."""
    from torch.profiler import ProfilerActivity, profile, schedule
    ops = set()
    for m in reg.metrics_for(name, True):
        ops.update(getattr(reg.metric(m["name"]), "OPS", ()))
    cuda = prog.dev.type == "cuda"
    sync = (lambda: torch.cuda.synchronize(prog.dev)) if cuda else \
        (lambda: None)
    device_acts = [ProfilerActivity.CUDA] if cuda else [ProfilerActivity.CPU]
    paths = []
    for _ in range(2):
        fd, path = tempfile.mkstemp(suffix=".json", prefix="portbench-")
        os.close(fd)
        paths.append(path)
    try:
        with profile(activities=device_acts,
                     schedule=schedule(wait=0, warmup=1, active=1),
                     on_trace_ready=lambda p: p.export_chrome_trace(
                         paths[0])) as prof:
            prog.step()
            sync()
            prof.step()
            t = time.perf_counter()
            prog.step()
            sync()
            window_s = time.perf_counter() - t
            prof.step()
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda
                                         else [])
        with profile(activities=acts, record_shapes=True) as prof:
            prog.step()
            sync()
        prof.export_chrome_trace(paths[1])
        t = time.perf_counter()
        out = trace.device_activity(paths[0], window_s)
        out["calls"] = trace.op_calls(paths[1], ops)
        log(f"trace: {os.path.getsize(paths[0])} + "
            f"{os.path.getsize(paths[1])} bytes, read in "
            f"{time.perf_counter() - t:.2f} s, {len(out['calls'])} calls, "
            f"traced step {window_s:.4f} s, longest idle gaps (start s, "
            f"length s, host) {out['longest_gaps']}")
        return out
    finally:
        for path in paths:
            os.remove(path)


