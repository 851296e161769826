"""The port's front end (``repro_torch.Session``, ``flow``) and its host
copies (``core/simulate.py``, ``obs/report.py``, ``configs/ssb_etl.py``)
against the JAX reference (``repro`` on backend ``jax``), same data, same
options.

Tolerances: group keys, counts, dtypes and row order are byte-identical;
float32 sums agree within rtol 1e-5 (the two backends add float32 values in
different orders); both stay within the backend's ``oracle_rtol`` (1e-3,
float32 accumulation) of the float64 oracles.  The copy, transfer and
dispatch counters of a run equal the reference's, measured live.
"""
import json

import numpy as np
import pytest

import repro
import repro_torch
from repro.configs import ssb_etl as ref_ssb_etl
from repro.core import simulate as ref_simulate
from repro.etl import queries as ref_queries
from repro.etl import ssb as ref_ssb
from repro.obs import report as ref_report
from repro_torch.configs import ssb_etl
from repro_torch.core import get_backend, simulate
from repro_torch.core.optimizer import FlowStatistics
from repro_torch.etl import queries, ssb
from repro_torch.obs import report

SIZES = dict(lineorder_rows=20_000, customers=600, suppliers=60, parts=800,
             seed=5)
COUNTERS = ("copies", "bytes_copied", "h2d_transfers", "h2d_bytes",
            "d2h_transfers", "d2h_bytes", "dispatch_calls", "degradations")
QUERIES = ("Q1.1", "Q2.1", "Q3.1", "Q4.1", "Q4.1s")


@pytest.fixture(scope="module")
def data():
    return ssb.generate(**SIZES), ref_ssb.generate(**SIZES)


def _cases():
    """Every query on every engine once, with fusion on where the engine
    takes it, alternating the two flow styles; then the other fusion
    setting and the other style on the optimized/streaming engines for
    each query.  Each case runs on both packages."""
    out = []
    for qi, q in enumerate(QUERIES):
        for ei, eng in enumerate(("ordinary", "kettle", "optimized",
                                  "streaming")):
            fuse = True if eng in ("optimized", "streaming") else None
            out.append((q, eng, fuse, (qi + ei) % 2 == 0))
        eng = ("optimized", "streaming")[qi % 2]
        out.append((q, eng, False, qi % 2 == 1))
    return out


def _session_run(qname, engine, fuse, use_dsl, data):
    """The same Session.run on both packages: (port run, reference run,
    port oracle)."""
    td, rd = data
    kw = {"fuse": fuse} if fuse is not None else {}
    if engine in ("optimized", "streaming"):
        kw["num_splits"] = 4
    tq = queries.BUILDERS[qname](td, use_dsl=use_dsl)
    rq = ref_queries.BUILDERS[qname](rd, use_dsl=use_dsl)
    got = repro_torch.Session(backend="torch_cpu", metadata=None).run(
        tq, engine=engine, **kw)
    want = repro.Session(backend="jax", metadata=None).run(
        rq, engine=engine, **kw)
    return got, want, tq.oracle(td)


@pytest.mark.parametrize("qname,engine,fuse,use_dsl", _cases())
def test_session_run_matches_reference(qname, engine, fuse, use_dsl, data):
    got, want, oracle = _session_run(qname, engine, fuse, use_dsl, data)
    assert got.run.engine == want.run.engine == engine
    assert list(got.table) == list(want.table)
    for col, w in want.table.items():
        g = got.table[col]
        assert g.dtype == w.dtype, col
        if w.dtype.kind == "f":
            np.testing.assert_allclose(g, w, rtol=1e-5, atol=0)
        else:
            np.testing.assert_array_equal(g, w)      # keys, row order
    rtol = get_backend("torch_cpu").oracle_rtol
    for col, o in oracle.items():
        np.testing.assert_allclose(got.table[col], o, rtol=rtol)
        np.testing.assert_allclose(want.table[col], o, rtol=rtol)
    for name in COUNTERS:
        assert getattr(got.run, name) == getattr(want.run, name), name


def test_session_run_accepts_the_reference_argument_forms(data):
    """A built Flow, a QueryFlow and a (Dataflow, sink) pair all run; the
    sink is cleared between runs; an unknown engine is refused."""
    td, _ = data
    s = repro_torch.Session(backend="torch_cpu")
    q = queries.build_q1(td)
    a = s.run(q, engine="optimized").table
    b = s.run((q.flow, q.sink), engine="optimized").table
    assert a["revenue"].tobytes() == b["revenue"].tobytes()
    assert len(s.metadata.dataflows) == 1
    with pytest.raises(ValueError, match="unknown engine"):
        s.run(q, engine="spark")
    with pytest.raises(TypeError, match="cannot run"):
        s.run(42)


@pytest.mark.parametrize("engine", ["ordinary", "kettle"])
@pytest.mark.parametrize("kw,err", [({"optimize": 2}, ValueError),
                                    ({"fuse": True}, ValueError),
                                    ({"num_splits": 4}, TypeError)])
def test_baseline_engines_refuse_optimizer_options(engine, kw, err, data):
    td, rd = data
    tq, rq = queries.build_q4(td), ref_queries.build_q4(rd)
    with pytest.raises(err) as got:
        repro_torch.Session(backend="torch_cpu").run(tq, engine=engine, **kw)
    with pytest.raises(err) as want:
        repro.Session(backend="jax").run(rq, engine=engine, **kw)
    assert str(got.value) == str(want.value)


def _typo_flow(pkg, columns):
    return (pkg.flow("typo").source(columns)
            .filter(pkg.col("lo_quantity") < 25)
            .derive("rev", pkg.col("lo_extendedprice")
                    * pkg.col("lo_discont"))
            .aggregate([], {"revenue": ("rev", "sum")}))


def test_flow_builder_rejects_a_typo_at_sink_like_the_reference(data):
    td, rd = data
    with pytest.raises(ValueError) as got:
        _typo_flow(repro_torch, td.lineorder).sink()
    with pytest.raises(ValueError) as want:
        _typo_flow(repro, rd.lineorder).sink()
    assert "lo_discont" in str(got.value)
    assert str(got.value) == str(want.value)


def test_flow_builder_structure_errors_match_reference(data):
    td, rd = data
    for pkg, d in ((repro_torch, td), (repro, rd)):
        with pytest.raises(ValueError, match="must start with .source"):
            pkg.flow("x").filter(pkg.col("lo_quantity") < 1)
        with pytest.raises(ValueError, match="already has a source"):
            pkg.flow("x").source(d.lineorder).source(d.lineorder)
        with pytest.raises(TypeError, match="DimTable"):
            pkg.flow("x").source(d.lineorder).lookup(
                "not-a-dim", "lo_custkey", {"c": "c"})


def test_declarative_flow_matches_reference(data):
    """The declarative Q4.1 (the example's flow) on the streaming engine,
    fused, against the reference on jax: identical keys and row order."""
    td, rd = data
    got = repro_torch.Session(backend="torch_cpu").run(
        _declarative_q41(repro_torch, td), engine="streaming", fuse=True,
        num_splits=4)
    want = repro.Session(backend="jax").run(
        _declarative_q41(repro, rd), engine="streaming", fuse=True,
        num_splits=4)
    assert list(got.table) == list(want.table)
    for col, w in want.table.items():
        assert got.table[col].dtype == w.dtype, col
        if w.dtype.kind == "f":
            np.testing.assert_allclose(got.table[col], w, rtol=1e-5)
        else:
            assert got.table[col].tobytes() == w.tobytes(), col
    oracle = queries.build_q4(td).oracle(td)
    np.testing.assert_allclose(got.table["profit"], oracle["profit"],
                               rtol=get_backend("torch_cpu").oracle_rtol)
    assert got.run.degradations == 0


def _declarative_q41(pkg, data, sort=True):
    """SSB Q4.1 through ``flow()``, as the reference's declarative example
    (``examples/declarative_q41.py``) builds it."""
    if pkg is repro_torch:
        from repro_torch.etl import DimTable
        from repro_torch.etl.ssb import mfgr_id, region_id
    else:
        from repro.etl import DimTable
        from repro.etl.ssb import mfgr_id, region_id
    col = pkg.col
    america = region_id("AMERICA")
    m1, m2 = mfgr_id("MFGR#1"), mfgr_id("MFGR#2")
    cust = DimTable(data.customer["c_custkey"],
                    {"c_nation": data.customer["c_nation"]},
                    row_filter=data.customer["c_region"] == america)
    supp = DimTable(data.supplier["s_suppkey"],
                    {"s_nation": data.supplier["s_nation"]},
                    row_filter=data.supplier["s_region"] == america)
    part = DimTable(data.part["p_partkey"], {"p_mfgr": data.part["p_mfgr"]},
                    row_filter=((data.part["p_mfgr"] == m1)
                                | (data.part["p_mfgr"] == m2)))
    date = DimTable(data.date["d_datekey"], {"d_year": data.date["d_year"]})
    b = (pkg.flow("q4.1-declarative")
         .source(data.lineorder, name="lineorder")
         .lookup(cust, "lo_custkey", {"c_nation": "c_nation"})
         .lookup(supp, "lo_suppkey", {"s_nation": "s_nation"})
         .lookup(part, "lo_partkey", {"p_mfgr": "p_mfgr"})
         .lookup(date, "lo_orderdate", {"d_year": "d_year"})
         .filter((col("c_nation") >= 0) & (col("s_nation") >= 0)
                 & (col("p_mfgr") >= 0) & (col("d_year") >= 0))
         .project("d_year", "c_nation", "lo_revenue", "lo_supplycost")
         .derive("profit", col("lo_revenue") - col("lo_supplycost"))
         .aggregate(["d_year", "c_nation"], {"profit": ("profit", "sum")}))
    return (b.sort(["d_year", "c_nation"]) if sort else b).sink()


def test_calibrate_gives_reference_statistics(data):
    td, rd = data
    ts = repro_torch.Session(backend="torch_cpu")
    got = ts.calibrate(queries.build_q4(td), sample_rows=2048)
    want = repro.Session(backend="jax").calibrate(
        ref_queries.build_q4(rd), sample_rows=2048)
    assert isinstance(got, FlowStatistics)
    assert (got.sample_rows, got.scale) == (want.sample_rows, want.scale)
    assert set(got.components) == set(want.components)
    for name, w in want.components.items():
        g = got.components[name]
        assert (g.rows_in, g.rows_out, g.calls, g.out_bytes) == (
            w.rows_in, w.rows_out, w.calls, w.out_bytes), name
    assert queries.build_q4(td).flow.name in ts.metadata.statistics


# ---------------------------------------------------------------------------
#  host copies: simulate, report, ssb_etl
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("case", ["m1", "stagger", "cores", "penalty",
                                  "usage", "multithreading"])
def test_simulate_equals_reference(case):
    """The reference's simulator cases (tests/test_simulate_metadata.py)
    through both copies: equal curves and results."""
    per = [1.0] * 4
    calls = {
        "m1": lambda m: m.simulate_tree(np.array([[1.0], [2.0], [0.5]]),
                                        cores=8, m_prime=1),
        "stagger": lambda m: m.simulate_tree(
            np.tile((np.array([0.1, 0.4, 0.1]) / 8)[:, None], (1, 8)),
            cores=8),
        "cores": lambda m: m.speedup_curve(per, total_rows=1000,
                                           degrees=[1, 2, 4, 8, 16],
                                           cores=2, t0=0.0),
        "penalty": lambda m: m.speedup_curve(per, 1000, [4, 8, 16, 32],
                                             cores=8, t0=0.01,
                                             switch_cost=0.01),
        "usage": lambda m: m.cpu_usage_curve(per, degrees=[1, 4, 8],
                                             cores=8, t0=0.01),
        "multithreading": lambda m: m.multithreading_curve(
            bottleneck_cost=8.0, other_cost=2.0,
            thread_counts=[1, 2, 4, 8, 16], cores=8, switch_cost=0.02),
    }
    got, want = calls[case](simulate), calls[case](ref_simulate)
    if isinstance(want, dict):
        assert got == want
    else:
        assert (got.makespan, got.sequential_time, got.speedup,
                got.avg_cpu_usage) == (want.makespan, want.sequential_time,
                                       want.speedup, want.avg_cpu_usage)
        np.testing.assert_array_equal(got.core_busy, want.core_busy)


def test_core_exports_simulate():
    import repro_torch.core as core
    for name in ("SimResult", "cpu_usage_curve", "multithreading_curve",
                 "simulate_tree", "speedup_curve"):
        assert getattr(core, name) is getattr(simulate, name), name


def _nested_payload(obs_trace):
    with obs_trace.trace_scope() as tr:
        obs_trace.complete("phase", "parent", 0.0, 0.010)
        obs_trace.complete("compute", "child", 0.002, 0.004)
    tr.meta = {"run_id": "x" * 32}
    return {"traceEvents": tr.to_chrome(pid=1),
            "otherData": {"runs": [tr.meta]}}


def test_report_self_time_equals_reference():
    from repro.obs import trace as ref_trace
    from repro_torch.obs import trace
    got = report.analyze(_nested_payload(trace))
    want = ref_report.analyze(_nested_payload(ref_trace))
    assert got == want
    rep = got["runs"][0]
    assert rep["categories"]["overhead"] == pytest.approx(6000, rel=0.01)
    assert rep["categories"]["compute"] == pytest.approx(4000, rel=0.01)
    assert report.render(got) == ref_report.render(want)


def test_report_reads_a_served_session_trace(tmp_path, monkeypatch):
    """A serving session exports one trace on close(); the port's report
    attributes it exactly as the reference's report does, and its CLI
    round-trips --json."""
    path = tmp_path / "serve.json"
    monkeypatch.setenv("REPRO_TRACE", "1")
    monkeypatch.setenv("REPRO_TRACE_PATH", str(path))
    r = np.random.RandomState(3)
    cols = {"k": r.randint(0, 5, 300).astype(np.int64),
            "v": r.randint(0, 100, 300).astype(np.int64)}
    f = (repro_torch.flow("traced").source({c: a[:0] for c, a in cols.items()})
         .derive("e", repro_torch.col("v") + 1)
         .aggregate(["k"], {"s": ("e", "sum")}).sink())
    with repro_torch.Session(backend="torch_cpu", metadata=None).serve(
            f, num_splits=2) as srv:
        for idx in np.array_split(np.arange(300), 3):
            srv.tick({c: a[idx] for c, a in cols.items()})
        summary = srv.close()
    assert summary["trace_file"] == str(path)
    payload = json.loads(path.read_text())
    got, want = report.analyze(payload), ref_report.analyze(payload)
    assert got == want
    assert got["runs"][-1]["meta"]["ticks"] == 3
    assert report.render(got) == ref_report.render(want)
    assert report.main([str(path), "--json"]) == 0


def test_ssb_etl_config_builds_torch_options():
    cfg = ssb_etl.CONFIG
    assert cfg.backend == "torch"
    o = cfg.engine_options()
    assert o.backend == "torch"
    assert (o.num_splits, o.pipeline_degree, o.chunk_rows) == (
        8, 8, 262_144)
    assert ssb_etl.SMOKE_CONFIG.engine_options(num_splits=2).num_splits == 2
    ref = ref_ssb_etl.CONFIG
    for f in ("lineorder_rows", "customers", "suppliers", "parts",
              "num_splits", "pipeline_degree", "chunk_rows", "queries"):
        assert getattr(cfg, f) == getattr(ref, f), f
    assert ref.backend == "numpy"          # the one deliberate difference


def test_session_defaults_to_the_card():
    """With no backend named, a run resolves to ``torch``, which needs
    CUDA; the reference resolves to ``numpy``."""
    import torch
    s = repro_torch.Session()
    assert s.backend is None and s.defaults.backend is None
    q = queries.build_q1(ssb.generate(lineorder_rows=200, customers=20,
                                      suppliers=10, parts=20))
    if torch.cuda.is_available():          # pragma: no cover
        assert s.run(q, engine="optimized").run.backend == "torch"
    else:
        with pytest.raises(RuntimeError, match="torch_cpu"):
            s.run(q, engine="optimized")
