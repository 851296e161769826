"""Quickstart on the PyTorch/CUDA port — the paper's technique on its own
workload.

Builds the paper's Figure-11 dataflow (SSB Q4.1), partitions it with
Algorithm 1, runs it three ways (ordinary / shared-cache / pipelined),
plans the pipeline degree with Algorithm 3 and Theorem 1 from the
shared-cache run's activity times, and checks the results against an
independent oracle.

  PYTHONPATH=src python examples/torch_quickstart.py [--rows 500000]
                                                     [--backend torch_cpu]

Runs on the card (backend ``torch``) unless ``--backend`` names another;
backend ``torch`` raises without a card.  The oracle check holds float
sums to the backend's ``oracle_rtol`` (1e-3 on ``torch``: float32 sums
over 32-bit device columns).  An activity's time is the host's clock
around its calls (``Component.busy_time``): on the card that spans the
launches it queues and the copies that wait for them.
"""
import argparse
import sys

import numpy as np

from repro_torch.core import (OptimizedEngine, OptimizeOptions, OrdinaryEngine,
                              partition, resolve_backend)
from repro_torch.core.planner import build_plan, choose_degree
from repro_torch.etl import build_q4
from repro_torch.etl.ssb import generate

#: m', the sample run's splits, and the cores the degree is capped at
SPLITS = 8
CORES = 8


def quickstart(data, backend=None, expect=None, log=print) -> dict:
    """The seven steps over ``data``.  ``expect``: Q4.1's oracle table
    (computed here when None).

    Returns ``{"trees": [(root, members)], "activity_times", "plan"
    (a ``PipelinePlan``), "degree", "walls": {"ordinary", "shared_cache",
    "pipelined", "pipelined_8"}, "copies": {...}, "tables": {"ordinary",
    "pipelined"}}``; ``pipelined`` ran at the planned degree,
    ``pipelined_8`` at 8 splits."""
    rows = len(data.lineorder["lo_orderkey"])

    # 1. data + dataflow (the paper's Fig-11 Q4.1 flow)
    qf = build_q4(data)
    log(f"dataflow: {qf.flow}")

    # 2. Algorithm 1 — partition into execution trees
    g_tau = partition(qf.flow)
    for t in g_tau.trees:
        log(f"  T{t.tree_id + 1}: root={t.root!r:18s} members={t.members}")

    # 3. ordinary engine (separate caches, copy on every edge)
    run_ord = OrdinaryEngine(qf.flow, backend=backend).run()
    result_ord = qf.sink.result()
    log(run_ord.summary())

    # 4. optimized engine — shared caching, sequential (paper: ~10% gain)
    qf = build_q4(data)
    run_seq = OptimizedEngine(qf.flow, OptimizeOptions(
        num_splits=SPLITS, pipelined=False, concurrent_trees=False,
        backend=backend)).run()
    log(f"{run_seq.summary()} (copies {run_ord.copies} -> {run_seq.copies})")

    # 5. Algorithm 3 + Theorem 1 — plan the pipeline degree from the sample
    costs = {n: run_seq.activity_times[n] for n in run_seq.trees[0]}
    plan = build_plan(costs, misc_total=0.002 * len(costs),
                      sample_rows=rows, full_rows=rows, m_prime=SPLITS)
    m = choose_degree(plan, cores=CORES)
    log(f"Theorem 1: staggering={plan.staggering!r} m*={plan.m_star:.1f} "
        f"-> degree {m}")

    # 6. optimized engine — shared caching + pipeline parallelization, at
    # the planned degree and at m' splits
    qf = build_q4(data)
    run_pipe = OptimizedEngine(qf.flow, OptimizeOptions(
        num_splits=m, backend=backend)).run()
    result_pipe = qf.sink.result()
    log(run_pipe.summary())
    if m == SPLITS:
        run_8, result_8 = run_pipe, result_pipe
    else:
        qf = build_q4(data)
        run_8 = OptimizedEngine(qf.flow, OptimizeOptions(
            num_splits=SPLITS, backend=backend)).run()
        result_8 = qf.sink.result()
    log(f"pipelined wall at degree {m}: {run_pipe.wall_time:.4f}s, at "
        f"{SPLITS} splits: {run_8.wall_time:.4f}s")

    # 7. correctness: engine results == independent oracle
    rtol = resolve_backend(backend).oracle_rtol
    if expect is None:
        expect = qf.oracle(data)
    for key in expect:
        for result in (result_ord, result_pipe, result_8):
            np.testing.assert_allclose(result[key], expect[key], rtol=rtol)
    log(f"results match the independent oracle (rtol={rtol}) — OK")
    return {"trees": [(t.root, list(t.members)) for t in g_tau.trees],
            "activity_times": costs, "plan": plan, "degree": m,
            "walls": {"ordinary": run_ord.wall_time,
                      "shared_cache": run_seq.wall_time,
                      "pipelined": run_pipe.wall_time,
                      "pipelined_8": run_8.wall_time},
            "copies": {"ordinary": run_ord.copies,
                       "shared_cache": run_seq.copies,
                       "pipelined": run_pipe.copies},
            "tables": {"ordinary": result_ord, "pipelined": result_pipe}}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--rows", type=int, default=500_000)
    ap.add_argument("--backend", default=None,
                    help="operator backend: torch (the card, default), "
                         "torch_cpu or numpy; REPRO_BACKEND also works")
    args = ap.parse_args(argv)
    resolve_backend(args.backend)          # no card: raise before generating
    quickstart(generate(lineorder_rows=args.rows), backend=args.backend)
    return 0


if __name__ == "__main__":
    sys.exit(main())
