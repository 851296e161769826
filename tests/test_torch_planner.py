"""Algorithm 3 and Theorem 1 in the port (``repro_torch.core.planner``)
against the reference (``repro.core.planner``) on the same inputs:
``tests/test_core_planner.py``'s cases, its degenerate ones included, a
seeded grid over the cost model's parameters, and the activity times of a
``torch_cpu`` run of ``examples/torch_quickstart.py``.

Tolerance: none.  The planner is host arithmetic copied from the
reference, so every field of ``PipelinePlan``, every degree, channel depth
and pool width, and the plan's predictions are equal (NaN equal to NaN).
"""
import dataclasses
import importlib.util
import math
from pathlib import Path

import numpy as np
import pytest

from repro.core import planner as ref
from repro_torch.core import planner as port
from repro_torch.etl.ssb import generate

EXAMPLES = Path(__file__).resolve().parents[1] / "examples"
NAN, INF = float("nan"), float("inf")

# theorem1_m_star(c, lam, N, t0, m_max): test_core_planner.py's cases
M_STAR_CASES = [
    (100.0, 0.1, 100, 0.1, None), (100.0, 0.1, 10, 1e-9, 64),
    (0.0, 1.0, 100, 1.0, None), (NAN, 0.1, 100, 0.1, None),
    (INF, 0.1, 100, 0.1, None), (100.0, NAN, 100, 0.1, None),
    (0.0, 0.0, 0, 0.0, None), (1.0, 1.0, 10, 0.0, None),
    (10.0, 0.0, 0, 0.0, 16), (10.0, 0.0, 0, 0.0, None),
]
# build_plan(activity_times, misc_total, sample_rows, full_rows, m_prime,
# staggering_rows_sample)
_T0, _LAM, _ROWS = 0.01, 2e-5, 200_000
_NETS = [0.5, 0.8, _LAM * _ROWS, 0.6, 0.3]
BUILD_CASES = [
    ({f"a{i}": v + _T0 for i, v in enumerate(_NETS)}, 5 * _T0, _ROWS,
     _ROWS, 4, None),
    ({}, 0.0, 0, 0, 0, None),
    ({"a": 0.0, "b": 0.0}, 0.0, 0, 0, 1, None),
    ({"a": 0.3, "b": 0.9, "c": 0.1}, 0.006, 50_000, 6_000_000, 8, 12_000),
    ({"a": NAN, "b": 0.2}, 0.004, 1_000, 1_000, 8, None),
]
# PipelinePlan fields (n, t0, c, lam, N, staggering, m_star) for
# choose_degree(plan, cores, cap, split_bytes, memory_budget_bytes)
DEGREE_CASES = [
    ((4, 1e-4, 100.0, 1e-9, 10, "a0", 1000.0), 8, 64, None, None),
    ((4, 1e-4, 100.0, 1e-9, 10, "a0", 1000.0), None, 64, None, None),
    ((2, 0.0, INF, 0.0, 0, "a", INF), None, 64, None, None),
    ((2, 0.0, 0.0, 0.0, 0, "a", NAN), None, 64, None, None),
    ((2, 0.01, 10.0, 1e-6, 100, "a", 8.0), None, 64, 0, 1 << 20),
    ((2, 0.01, 10.0, 1e-6, 100, "a", 30.4), 16, 64, 1 << 18, 1 << 20),
    ((4, 0.01, 10.0, 1e-5, 100_000, "a1", 30.0), 4, 2, None, None),
]
# choose_channel_depth(edge_nbytes, num_splits, m_prime, budget)
DEPTH_CASES = [(0, 8, 8, 256 << 20), (1 << 30, 8, 8, 256 << 20),
               (1 << 34, 8, 8, 256 << 20), (1 << 20, 0, 0, 1 << 10),
               (96_000_000, 3, 12, 64 << 20)]
# choose_pool_width(num_trees, m_prime, mt_threads, wave_width, cores, cap)
POOL_CASES = [(3, 8, None, 1, None, 64), (3, 8, {"a": 12}, 2, None, 64),
              (1, 1, None, 1, None, 64), (0, 0, {}, 0, 4, 64),
              (5, 16, {"x": 3, "y": 70}, 4, 32, 48)]


def same(a, b) -> bool:
    if isinstance(a, float) and isinstance(b, float) and math.isnan(a):
        return math.isnan(b)
    return type(a) is type(b) and a == b


def same_plan(got, want) -> None:
    g, w = dataclasses.asdict(got), dataclasses.asdict(want)
    assert list(g) == list(w)
    for k in w:
        if k == "activity_times":
            assert list(g[k]) == list(w[k])
            assert all(same(g[k][a], w[k][a]) for a in w[k]), k
        else:
            assert same(g[k], w[k]), (k, g[k], w[k])
    for m in (1, 2, 8, got.m_star):
        assert same(got.predict_T_p(m), want.predict_T_p(m)), m
        assert same(got.predict_speedup(m), want.predict_speedup(m)), m
    assert same(got.predict_T_s(), want.predict_T_s())


def _grid():
    """(c, lam, N, t0, m_max) drawn from numpy seed 0 over
    test_theorem1_minimizes_cost's ranges."""
    rng = np.random.default_rng(0)
    return [(float(rng.uniform(0.5, 500.0)), float(rng.uniform(1e-6, 1e-3)),
             int(rng.integers(100, 100_000)), float(rng.uniform(1e-4, 0.5)),
             [None, 8, 10_000][i % 3]) for i in range(12)]


@pytest.mark.parametrize("c,lam,N,t0,m_max", M_STAR_CASES + _grid())
def test_theorem1_m_star_matches_reference(c, lam, N, t0, m_max):
    assert same(port.theorem1_m_star(c, lam, N, t0, m_max=m_max),
                ref.theorem1_m_star(c, lam, N, t0, m_max=m_max))


@pytest.mark.parametrize("case", range(len(BUILD_CASES)))
def test_build_plan_matches_reference(case):
    times, misc, sample, full, m_prime, n_stag = BUILD_CASES[case]
    args = (dict(times), misc, sample, full, m_prime, n_stag)
    same_plan(port.build_plan(*args), ref.build_plan(*args))


@pytest.mark.parametrize("fields,cores,cap,split_bytes,budget",
                         DEGREE_CASES)
def test_choose_degree_matches_reference(fields, cores, cap, split_bytes,
                                         budget):
    kw = dict(cores=cores, cap=cap, split_bytes=split_bytes,
              memory_budget_bytes=budget)
    got = port.choose_degree(port.PipelinePlan(*fields), **kw)
    want = ref.choose_degree(ref.PipelinePlan(*fields), **kw)
    assert type(got) is int and got == want


@pytest.mark.parametrize("nbytes,splits,m_prime,budget", DEPTH_CASES)
def test_choose_channel_depth_matches_reference(nbytes, splits, m_prime,
                                                budget):
    assert port.choose_channel_depth(nbytes, splits, m_prime, budget) == \
        ref.choose_channel_depth(nbytes, splits, m_prime, budget)


@pytest.mark.parametrize("trees,m_prime,mt,wave,cores,cap", POOL_CASES)
def test_choose_pool_width_matches_reference(trees, m_prime, mt, wave,
                                             cores, cap):
    kw = dict(mt_threads=mt, wave_width=wave, cores=cores, cap=cap)
    assert port.choose_pool_width(trees, m_prime, **kw) == \
        ref.choose_pool_width(trees, m_prime, **kw)


def test_plans_from_a_quickstart_run_match_reference():
    """The activity times of ``examples/torch_quickstart.py`` on
    ``torch_cpu``: both planners make the same plan and degree from them,
    and the example's own plan is that plan."""
    spec = importlib.util.spec_from_file_location(
        "torch_quickstart", EXAMPLES / "torch_quickstart.py")
    qs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(qs)
    data = generate(lineorder_rows=20_000, customers=600, suppliers=60,
                    parts=800, seed=5)
    out = qs.quickstart(data, backend="torch_cpu", log=lambda *a: None)
    times = out["activity_times"]
    assert len(times) >= 2 and max(times.values()) > 0
    args = (dict(times), 0.002 * len(times), 20_000, 20_000, qs.SPLITS)
    got, want = port.build_plan(*args), ref.build_plan(*args)
    same_plan(got, want)
    same_plan(out["plan"], want)
    for cores in (None, 2, qs.CORES):
        assert port.choose_degree(got, cores=cores) == \
            ref.choose_degree(want, cores=cores)
    assert out["degree"] == ref.choose_degree(want, cores=qs.CORES)
