"""The paper's full evaluation workload on the PyTorch/CUDA port: every SSB
flow of ``BUILDERS`` (Q1.1, Q2.1, Q3.1, Q4.1 and Q4.1s, Q4.1 cut into two
streamed trees) under the four engines (ordinary / Kettle-like / optimized
/ streaming), with Algorithm-1 partitioning printed and every sink checked
against the query's independent oracle.

  PYTHONPATH=src python examples/torch_etl_ssb.py [--rows 1000000]
                                                  [--splits 8]
                                                  [--backend torch_cpu]

Runs on the card (backend ``torch``) unless ``--backend`` names another
(``torch_cpu``: the kernels' plain versions on the CPU); backend ``torch``
raises without a card.  The optimized and streaming engines are printed
against the ordinary and Kettle-like baselines, as the paper compares
them.
"""
import argparse
import sys

import numpy as np

from repro_torch.core import (OptimizedEngine, OptimizeOptions, OrdinaryEngine,
                              StreamingEngine, partition, resolve_backend)
from repro_torch.etl import BUILDERS, KettleEngine
from repro_torch.etl.ssb import generate
from repro_torch.kernels import launch_counts, route_counts

ENGINES = ("ordinary", "kettle-like", "optimized", "streaming")


def _engine(name: str, flow, splits: int, backend):
    if name == "ordinary":
        return OrdinaryEngine(flow, backend=backend)
    if name == "kettle-like":
        return KettleEngine(flow, backend=backend)
    cls = OptimizedEngine if name == "optimized" else StreamingEngine
    return cls(flow, OptimizeOptions(num_splits=splits, backend=backend))


def _delta(after: dict, before: dict) -> dict:
    return {k: n - before.get(k, 0) for k, n in after.items()
            if n != before.get(k, 0)}


def _check(got: dict, expect: dict, rtol: float) -> None:
    """Every oracle column of ``got`` within ``rtol`` of the oracle."""
    for k in expect:
        np.testing.assert_allclose(got[k], expect[k], rtol=rtol)


def evaluate(data, splits: int = 8, backend=None, oracles=None,
             log=print) -> dict:
    """Every flow of ``BUILDERS`` over ``data`` on the four engines, each
    sink checked against its oracle (``oracles``: flow name -> oracle
    table, computed here where missing) within the backend's
    ``oracle_rtol``, with no degradation.

    Returns ``{flow: {"trees": [(root, members)], "engines": {engine:
    {"table", "wall", "rows_per_s", "copies", "bytes_copied",
    "degradations", "launches", "routes"}}}}``: ``launches`` the kernel
    launches of that run (``repro_torch.kernels.launch_counts``), ``routes``
    its grouped sums' launches by route (``route_counts``; none on the
    CPU, where the kernels' plain versions run)."""
    rtol = resolve_backend(backend).oracle_rtol
    rows = len(data.lineorder["lo_orderkey"])
    out = {}
    for qname, build in BUILDERS.items():
        qf = build(data)
        g = partition(qf.flow)
        trees = [(t.root, list(t.members)) for t in g.trees]
        log(f"\n{qname}: {len(qf.flow)} components -> {len(g.trees)} "
            f"execution trees ("
            + " | ".join(f"T{t.tree_id + 1}:{t.root}" for t in g.trees)
            + ")")
        expect = (oracles or {}).get(qname)
        if expect is None:
            expect = qf.oracle(data)
        runs = {}
        for name in ENGINES:
            qf = build(data)
            launches, routes = launch_counts(), route_counts()
            r = _engine(name, qf.flow, splits, backend).run()
            table = qf.sink.result()
            _check(table, expect, rtol)
            if r.degradations:
                raise AssertionError(f"{qname}/{name}: {r.degradations} "
                                     f"degradations")
            runs[name] = dict(
                table=table, wall=r.wall_time, rows_per_s=rows / r.wall_time,
                copies=r.copies, bytes_copied=r.bytes_copied,
                degradations=r.degradations,
                launches=_delta(launch_counts(), launches),
                routes=_delta(route_counts(), routes))
        for name, rr in runs.items():
            log(f"  {name:12s} wall {rr['wall']:7.3f}s  "
                f"rows/s {rr['rows_per_s']:11.4g}  copies {rr['copies']:4d}  "
                f"copied {rr['bytes_copied'] / 1e6:8.1f} MB  "
                f"launches {rr['launches']}  routes {rr['routes']}")
        for fast in ("optimized", "streaming"):
            log(f"  {fast} against the baselines: "
                + ", ".join(f"{runs[base]['wall'] / runs[fast]['wall']:.2f}x "
                            f"{base}" for base in ("ordinary", "kettle-like")))
        out[qname] = {"trees": trees, "engines": runs}
    log(f"\nall results match the independent oracles (rtol={rtol}) — OK")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--rows", type=int, default=1_000_000)
    ap.add_argument("--splits", type=int, default=8)
    ap.add_argument("--backend", default=None,
                    help="operator backend: torch (the card, default), "
                         "torch_cpu or numpy; REPRO_BACKEND also works")
    args = ap.parse_args(argv)
    resolve_backend(args.backend)          # no card: raise before generating
    data = generate(lineorder_rows=args.rows)
    print(f"SSB data: {data.nbytes() / 1e6:.0f} MB columnar, "
          f"{args.rows} lineorder rows")
    evaluate(data, splits=args.splits, backend=args.backend)
    return 0


if __name__ == "__main__":
    sys.exit(main())
