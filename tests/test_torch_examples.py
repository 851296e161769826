"""The port's ETL examples (``examples/torch_{etl_ssb,quickstart,
declarative_q41}.py``) on the CPU against the reference (``repro``) on the
same inputs (the LM examples: ``test_torch_examples_lm.py``).
Engine-by-engine parity of the flows is ``test_torch_session.py``'s; these
tests hold the examples' own code: the functions ``chip_smoke.py`` calls
on the card.

- etl_ssb: every flow of ``BUILDERS`` on the four engines on ``torch_cpu``
  against ``repro`` on ``numpy`` over the same ``generate``: partition
  trees and ``copies`` equal, key values and row order identical (keys
  are 32-bit on the port's device columns), float sums within the backend's ``oracle_rtol`` (float32 sums against
  float64).  The card's grouped-sum route counter is stood in for by a spy
  that counts the route the launch plan picks for each call's shape.
- quickstart: the trees equal ``repro.core.partition``'s; its oracle
  check passes (the planner against the reference: test_torch_planner.py).
- declarative: the example's flow and the reference example's, through
  each package's ``Session`` (the reference on ``jax``): keys, row order
  and dtypes identical, float sums within rtol 1e-5 (float32 sums in
  other orders).
- every example, the LM ones too, imports no ``jax``, ``jaxlib`` or ``repro``, and without
  a card its defaults raise.
"""
import importlib.util
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import repro
from repro.core import (OptimizedEngine as RefOptimized,
                        OptimizeOptions as RefOptions,
                        OrdinaryEngine as RefOrdinary,
                        StreamingEngine as RefStreaming)
from repro.core import partition as ref_partition
from repro.etl import KettleEngine as RefKettle
from repro.etl import queries as ref_queries
from repro.etl import ssb as ref_ssb
from repro_torch.core import get_backend
from repro_torch.core.backend import torch_backend
from repro_torch.etl import ssb
from repro_torch.kernels import _cuda
from repro_torch.kernels import _grouped_sum as gs


ROOT = Path(__file__).resolve().parents[1]
BK = "torch_cpu"
SIZES = dict(lineorder_rows=20_000, customers=600, suppliers=60, parts=800,
             seed=5)
NAMES = ("torch_quickstart", "torch_etl_ssb", "torch_declarative_q41",
         "torch_serve_lm", "torch_train_lm")
#: the H100's SMs: the wide route's grid the spy's plans assume
SMS = 132
SILENT = dict(log=lambda *a: None)


def load(name: str):
    spec = importlib.util.spec_from_file_location(
        name, ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def data():
    return ssb.generate(**SIZES), ref_ssb.generate(**SIZES)


def _ref_engine(name, flow, splits):
    """The reference example's engines, on ``numpy``."""
    if name == "ordinary":
        return RefOrdinary(flow, backend="numpy")
    if name == "kettle-like":
        return RefKettle(flow, backend="numpy")
    cls = RefOptimized if name == "optimized" else RefStreaming
    return cls(flow, RefOptions(num_splits=splits, backend="numpy"))


@pytest.fixture(scope="module")
def etl_runs(data):
    """(the port example's results, the reference's per flow and engine:
    (trees, {engine: (table, copies)})), with every grouped sum's route
    counted by the spy."""
    td, rd = data
    orig = torch_backend.radix_groupby

    def spy(ids, values, n_groups, **kw):
        p = gs.plan(ids.shape[0], int(n_groups), values.shape[1], True, SMS)
        _cuda.count_route(f"radix_groupby/{p.route}")
        return orig(ids, values, n_groups, **kw)
    torch_backend.radix_groupby = spy
    try:
        got = load("torch_etl_ssb").evaluate(td, splits=8, backend=BK,
                                             **SILENT)
    finally:
        torch_backend.radix_groupby = orig
    want = {}
    for qname, build in ref_queries.BUILDERS.items():
        trees = [(t.root, list(t.members))
                 for t in ref_partition(build(rd).flow).trees]
        runs = {}
        for name in ("ordinary", "kettle-like", "optimized", "streaming"):
            qf = build(rd)
            r = _ref_engine(name, qf.flow, 8).run()
            runs[name] = (qf.sink.result(), r.copies)
        want[qname] = (trees, runs)
    return got, want


def same_table(got, want, rtol, label, dtypes=False):
    assert list(got) == list(want), label
    for k, w in want.items():
        g = np.asarray(got[k])
        assert g.shape == w.shape, (label, k)
        assert not dtypes or g.dtype == w.dtype, (label, k)
        if w.dtype.kind == "f":
            np.testing.assert_allclose(g, w, rtol=rtol, atol=0,
                                       err_msg=f"{label}: {k}")
        else:
            np.testing.assert_array_equal(g, w, err_msg=f"{label}: {k}")


@pytest.mark.parametrize("qname", list(ref_queries.BUILDERS))
def test_etl_ssb_matches_reference(etl_runs, qname):
    got, want = etl_runs
    trees, runs = want[qname]
    assert got[qname]["trees"] == trees
    rtol = get_backend(BK).oracle_rtol
    assert list(got[qname]["engines"]) == list(runs)
    for engine, (table, copies) in runs.items():
        run = got[qname]["engines"][engine]
        same_table(run["table"], table, rtol, f"{qname}/{engine}")
        assert run["copies"] == copies, (qname, engine)
        assert run["degradations"] == 0
        assert run["launches"] == {}                 # CPU: plain versions
        assert run["wall"] > 0 and run["rows_per_s"] > 0


def test_etl_ssb_reports_each_aggregate_route(etl_runs):
    """One grouped sum an Aggregate a run: Q3.1's 2,646 ids with counts
    take the wide route, Q2.1's and Q4.1's the narrow one; Q1.1's keyless
    sum is no radix groupby."""
    got, _ = etl_runs
    expect = {"Q1.1": {}, "Q2.1": {"radix_groupby/narrow": 1},
              "Q3.1": {"radix_groupby/wide": 1},
              "Q4.1": {"radix_groupby/narrow": 1},
              "Q4.1s": {"radix_groupby/narrow": 1}}
    for qname, routes in expect.items():
        for engine, run in got[qname]["engines"].items():
            assert run["routes"] == routes, (qname, engine)


def test_quickstart_trees_and_oracle(data):
    td, rd = data
    out = load("torch_quickstart").quickstart(td, backend=BK, **SILENT)
    want = [(t.root, list(t.members))
            for t in ref_partition(ref_queries.build_q4(rd).flow).trees]
    assert out["trees"] == want
    assert 1 <= out["degree"] <= 8
    assert out["copies"]["ordinary"] > 0
    assert set(out["walls"]) == {"ordinary", "shared_cache", "pipelined",
                                 "pipelined_8"}
    same_table(out["tables"]["pipelined"], out["tables"]["ordinary"], 1e-5,
               "pipelined against ordinary")


@pytest.mark.parametrize("engine,optimize", [("streaming", 2),
                                             ("ordinary", 2)])
def test_declarative_q41_matches_reference(data, engine, optimize):
    td, rd = data
    got = load("torch_declarative_q41").run(td, engine=engine,
                                            optimize=optimize, backend=BK,
                                            **SILENT)
    flow = load("declarative_q41").build_flow(rd)      # the reference's
    kw = (dict(optimize=optimize, fuse=True, num_splits=8)
          if engine in ("optimized", "streaming") else {})
    want = repro.Session(backend="jax").run(flow, engine=engine, **kw)
    # (optimize 2's rewrites follow timed calibration runs, so they may
    # differ between the two runs; the tables may not)
    same_table(got.table, want.table, 1e-5, f"declarative/{engine}",
               dtypes=True)


def test_examples_import_no_jax():
    """One process loads all five examples (their modules, not their
    ``main``)."""
    code = ("import importlib.util, sys\n"
            f"for name in {NAMES!r}:\n"
            "    spec = importlib.util.spec_from_file_location(\n"
            f"        name, {str(ROOT / 'examples')!r} + f'/{{name}}.py')\n"
            "    mod = importlib.util.module_from_spec(spec)\n"
            "    spec.loader.exec_module(mod)\n"
            "    assert callable(mod.main), name\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro')]\n"
            "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    subprocess.run([sys.executable, "-c", code], check=True, env=env)


@pytest.mark.parametrize("name", NAMES)
def test_example_defaults_need_a_card(name, monkeypatch):
    """Run with no arguments, each example asks for the card and raises
    without one: nothing falls back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the defaults would run")
    monkeypatch.delenv("REPRO_BACKEND", raising=False)
    with pytest.raises(RuntimeError, match="CUDA"):
        load(name).main([])
