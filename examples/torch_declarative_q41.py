"""SSB Q4.1 (the paper's Figure-11 dataflow) built with the PyTorch/CUDA
port's declarative flow API — expression DSL + FlowBuilder + Session — and
cross-checked against the independent oracle.

  PYTHONPATH=src python examples/torch_declarative_q41.py [--rows 200000]
                                                          [--backend torch_cpu]
                                                          [--engine streaming]
                                                          [--optimize 2]

Runs on the card (backend ``torch``) unless ``--backend`` names another;
backend ``torch`` raises without a card.  Every predicate and expression
is an AST node, so the optimizer derives read sets itself: a refusal for
an undeclared read fails the run.
"""
import argparse
import sys

import numpy as np

import repro_torch
from repro_torch import col
from repro_torch.core import resolve_backend
from repro_torch.etl import BUILDERS, DimTable
from repro_torch.etl.ssb import generate, mfgr_id, region_id


def build_flow(data) -> repro_torch.Flow:
    AMERICA = region_id("AMERICA")
    M1, M2 = mfgr_id("MFGR#1"), mfgr_id("MFGR#2")
    cust = DimTable(data.customer["c_custkey"],
                    {"c_nation": data.customer["c_nation"]},
                    row_filter=data.customer["c_region"] == AMERICA)
    supp = DimTable(data.supplier["s_suppkey"],
                    {"s_nation": data.supplier["s_nation"]},
                    row_filter=data.supplier["s_region"] == AMERICA)
    part = DimTable(data.part["p_partkey"], {"p_mfgr": data.part["p_mfgr"]},
                    row_filter=((data.part["p_mfgr"] == M1)
                                | (data.part["p_mfgr"] == M2)))
    date = DimTable(data.date["d_datekey"], {"d_year": data.date["d_year"]})

    # every predicate/expression is an AST node: read sets are derived, the
    # optimizer commutes/fuses without hand-declared reads=, and the torch
    # backend compiles the predicate into its fused segment
    return (repro_torch.flow("q4.1-declarative")
            .source(data.lineorder, name="lineorder")
            .lookup(cust, "lo_custkey", {"c_nation": "c_nation"})
            .lookup(supp, "lo_suppkey", {"s_nation": "s_nation"})
            .lookup(part, "lo_partkey", {"p_mfgr": "p_mfgr"})
            .lookup(date, "lo_orderdate", {"d_year": "d_year"})
            .filter((col("c_nation") >= 0) & (col("s_nation") >= 0)
                    & (col("p_mfgr") >= 0) & (col("d_year") >= 0))
            .project("d_year", "c_nation", "lo_revenue", "lo_supplycost")
            .derive("profit", col("lo_revenue") - col("lo_supplycost"))
            .aggregate(["d_year", "c_nation"], {"profit": ("profit", "sum")})
            .sort(["d_year", "c_nation"])
            .sink())


def run(data, engine: str = "streaming", optimize: int = 2, backend=None,
        expect=None, log=print) -> repro_torch.SessionRun:
    """Build the flow over ``data``, run it on ``engine`` (optimized and
    streaming: ``optimize`` level, segment fusion, 8 splits) and check its
    table against Q4.1's oracle (``expect``, computed here when None)
    within the backend's ``oracle_rtol``; no refusal may name an
    undeclared read.  Returns the ``SessionRun``."""
    f = build_flow(data)
    log(f"built {f.name}: {len(f.flow)} components, "
        f"sink schema {sorted(f.schema)}")
    session = repro_torch.Session(backend=backend)
    kwargs = {}
    if engine in ("optimized", "streaming"):
        kwargs = dict(optimize=optimize, fuse=True, num_splits=8)
    res = session.run(f, engine=engine, **kwargs)
    log(res.summary())
    for r in res.run.rewrites:
        log(f"  rewrite: {r['rule']}: {r['detail']}")
    for r in res.run.refusals:
        log(f"  refusal: {r['rule']}: {r['detail']}")

    # cross-check against the independent Q4.1 oracle
    rtol = resolve_backend(backend).oracle_rtol
    if expect is None:
        expect = BUILDERS["Q4.1"](data).oracle(data)
    assert set(res.table) == set(expect), "column set mismatch"
    for k in expect:
        np.testing.assert_allclose(res.table[k], expect[k], rtol=rtol)
    undeclared = [r for r in res.run.refusals if "undeclared" in r["detail"]]
    assert not undeclared, f"undeclared-read refusals on a DSL flow: {undeclared}"
    log(f"OK: {len(res.table['profit'])} result rows match the oracle "
        f"(rtol={rtol})")
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--rows", type=int, default=200_000)
    ap.add_argument("--backend", default=None,
                    help="operator backend: torch (the card, default), "
                         "torch_cpu or numpy")
    ap.add_argument("--engine", default="streaming",
                    choices=repro_torch.Session.ENGINES)
    ap.add_argument("--optimize", type=int, default=2)
    args = ap.parse_args(argv)
    resolve_backend(args.backend)          # no card: raise before generating
    run(generate(lineorder_rows=args.rows), engine=args.engine,
        optimize=args.optimize, backend=args.backend)
    return 0


if __name__ == "__main__":
    sys.exit(main())
