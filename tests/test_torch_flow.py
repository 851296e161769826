"""The port's SSB slice end to end (``repro_torch`` on backend ``torch_cpu``)
against the JAX reference (``repro`` on backend ``jax``), same data, same
options.

Tolerances: group keys, counts and row order are byte-identical; float32
sums agree within rtol 1e-5 (the two backends add float32 values in
different orders); both stay within the backend's ``oracle_rtol`` (1e-3,
float32 accumulation) of the float64 oracles.  The transfer, dispatch and
segment-compile counters of a run are compared live with the reference's.
"""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.core import OptimizedEngine as RefOptimized
from repro.core import OptimizeOptions as RefOptions
from repro.core import StreamingEngine as RefStreaming
from repro.core.shared_cache import cache_stats_scope as ref_stats_scope
from repro.etl import queries as ref_queries
from repro.etl import ssb as ref_ssb
from repro_torch.core import (MetadataStore, OptimizedEngine, OptimizeOptions,
                              StreamingEngine, get_backend, resolve_backend)
from repro_torch.core.shared_cache import cache_stats_scope
from repro_torch.etl import queries, ssb

SIZES = dict(lineorder_rows=20_000, customers=600, suppliers=60, parts=800,
             seed=5)
ENGINES = {"optimized": (OptimizedEngine, RefOptimized),
           "streaming": (StreamingEngine, RefStreaming)}
COUNTERS = ("h2d_transfers", "d2h_transfers", "dispatch_calls")


@pytest.fixture(scope="module")
def data():
    return ssb.generate(**SIZES), ref_ssb.generate(**SIZES)


def _run(qname, engine, fuse, data):
    """Run one query on both packages; return (port sink, reference sink,
    port run, reference run, port stats, reference stats, port oracle)."""
    td, rd = data
    port_engine, ref_engine = ENGINES[engine]
    tq, rq = queries.BUILDERS[qname](td), ref_queries.BUILDERS[qname](rd)
    with cache_stats_scope() as ts:
        trun = port_engine(tq.flow, OptimizeOptions(
            backend="torch_cpu", fuse_segments=fuse, num_splits=4)).run()
    with ref_stats_scope() as rs:
        rrun = ref_engine(rq.flow, RefOptions(
            backend="jax", fuse_segments=fuse, num_splits=4)).run()
    return (tq.sink.result(), rq.sink.result(), trun, rrun,
            ts.snapshot(), rs.snapshot(), tq.oracle(td))


def test_ssb_generator_identical_to_reference(data):
    td, rd = data
    for table in ("customer", "supplier", "part", "date", "lineorder"):
        got, want = getattr(td, table), getattr(rd, table)
        assert list(got) == list(want)
        for col in want:
            assert got[col].dtype == want[col].dtype, (table, col)
            np.testing.assert_array_equal(got[col], want[col])


@pytest.mark.parametrize("qname,engine,fuse", [
    ("Q4.1", "optimized", True), ("Q4.1", "streaming", True),
    ("Q4.1", "optimized", False), ("Q4.1", "streaming", False),
    ("Q1.1", "optimized", True), ("Q1.1", "optimized", False),
])
def test_query_matches_reference(qname, engine, fuse, data):
    got, want, trun, rrun, _, _, oracle = _run(qname, engine, fuse, data)
    assert list(got) == list(want)
    for col, w in want.items():
        g = got[col]
        assert g.dtype == w.dtype, col
        if w.dtype.kind == "f":
            np.testing.assert_allclose(g, w, rtol=1e-5, atol=0)
        else:
            np.testing.assert_array_equal(g, w)      # keys, row order
    rtol = get_backend("torch_cpu").oracle_rtol
    for col, o in oracle.items():
        np.testing.assert_allclose(got[col], o, rtol=rtol)
        np.testing.assert_allclose(want[col], o, rtol=rtol)
    assert trun.degradations == rrun.degradations == 0


@pytest.mark.parametrize("engine", ["optimized", "streaming"])
def test_fused_q41_counters_equal_reference(engine, data):
    """The fused Q4.1's transfer, dispatch and segment-compile counters are
    the reference jax backend's, measured live on the same flow."""
    _, _, trun, rrun, ts, rs, _ = _run("Q4.1", engine, True, data)
    for name in COUNTERS:
        assert getattr(trun, name) == getattr(rrun, name), name
    assert ts["segment_compiles"] == rs["segment_compiles"] >= 1
    assert trun.h2d_bytes == rrun.h2d_bytes
    assert trun.d2h_bytes == rrun.d2h_bytes


@pytest.mark.parametrize("engine", ["optimized", "streaming"])
def test_packed_probe_tables_add_no_transfer(engine, data):
    """Each Lookup's hash table is packed for the probe kernel on the
    device, from the slot arrays already uploaded: the fused Q4.1's
    transfer counters, dimension uploads included, stay the jax backend's,
    and every probed table keeps its packed copy alone."""
    from repro_torch.kernels.hash_join import PackedTable, hash_build
    td, rd = data
    port_engine, ref_engine = ENGINES[engine]
    tq, rq = queries.build_q4(td), ref_queries.build_q4(rd)
    lookups = [c for c in tq.flow.vertices.values()
               if type(c).__name__ == "Lookup"]
    with cache_stats_scope() as ts:
        port_engine(tq.flow, OptimizeOptions(
            backend="torch_cpu", fuse_segments=True, num_splits=4)).run()
    with ref_stats_scope() as rs:
        ref_engine(rq.flow, RefOptions(
            backend="jax", fuse_segments=True, num_splits=4)).run()
    got, want = ts.snapshot(), rs.snapshot()
    for name in ("h2d_transfers", "h2d_bytes", "d2h_transfers", "d2h_bytes",
                 "dim_h2d_transfers", "dim_h2d_bytes"):
        assert got[name] == want[name], name
    assert len(lookups) == 4
    for lk in lookups:
        ht = lk.dim.__dict__["_torch_hash_cache"]["cpu"]
        assert sorted(ht) == ["max_probes", "packed"]
        packed = ht["packed"]
        assert isinstance(packed, PackedTable)
        built = hash_build((np.asarray(lk.dim.keys),))
        assert ht["max_probes"] == built["max_probes"]
        np.testing.assert_array_equal(packed.slots[:, 0].numpy(),
                                      built["slot_keys"][0])
        np.testing.assert_array_equal(packed.slots[:, 1].numpy(),
                                      built["slot_idx"])


def test_torch_backend_needs_cuda():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device; the test checks the "
                    "refusal without one")
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_backend("torch")
    assert resolve_backend("torch_cpu").device.type == "cpu"


@pytest.mark.parametrize("degrade", ["on", "off"])
def test_segment_kernel_failure_raises(data, monkeypatch, degrade):
    """A fused segment whose device runner fails: on ``torch_cpu`` the
    segment steps onto the host reference pass and records one
    ``segment[torch_cpu] -> reference`` degradation, with the sink and the
    transfer and dispatch counters of the reference's run whose runner
    fails the same way; with ``REPRO_DEGRADE=0`` the run aborts with the
    runner's error."""
    from repro.core.backend.jax_backend import JaxBackend
    from repro_torch.core.backend.torch_backend import TorchBackend

    def broken(self, segment):
        def runner(cache):
            raise RuntimeError("hash_probe: CUDA error 98 (invalid device "
                               "function)")
        return runner

    monkeypatch.setattr(TorchBackend, "compile_segment", broken)
    monkeypatch.setattr(JaxBackend, "compile_segment", broken)
    q = queries.build_q4(data[0])
    opts = OptimizeOptions(backend="torch_cpu", fuse_segments=True,
                           num_splits=2)
    if degrade == "off":
        monkeypatch.setenv("REPRO_DEGRADE", "0")
        with pytest.raises(RuntimeError, match="invalid device function"):
            OptimizedEngine(q.flow, opts).run()
        return
    run = OptimizedEngine(q.flow, opts).run()
    rq = ref_queries.build_q4(data[1])
    rrun = RefOptimized(rq.flow, RefOptions(backend="jax", fuse_segments=True,
                                            num_splits=2)).run()
    got, want = q.sink.result(), rq.sink.result()
    assert list(got) == list(want)
    for col, w in want.items():
        assert got[col].dtype == w.dtype, col
        if w.dtype.kind == "f":
            np.testing.assert_allclose(got[col], w, rtol=1e-5, atol=0)
        else:
            np.testing.assert_array_equal(got[col], w)
    assert run.degradations == rrun.degradations == 1
    (event,) = run.degradation_events
    assert (event["kind"], event["src"], event["dst"]) == (
        "kernel", "segment[torch_cpu]", "reference")
    assert rrun.degradation_events[0]["dst"] == "reference"
    for name in COUNTERS + ("h2d_bytes", "d2h_bytes"):
        assert getattr(run, name) == getattr(rrun, name), name


def test_sharded_run_is_refused(data):
    """``shards=2`` is not refused: the same call runs sharded (``auto``
    takes the mesh route on torch_cpu) and gives the serial run's keys,
    order, counts and dtypes, with float sums within rtol 1e-5."""
    q = queries.build_q4(data[0])
    OptimizedEngine(q.flow, OptimizeOptions(backend="torch_cpu")).run()
    want = q.sink.result()
    q = queries.build_q4(data[0])
    run = OptimizedEngine(q.flow, OptimizeOptions(backend="torch_cpu",
                                                  shards=2)).run()
    got = q.sink.result()
    assert run.shards == 2 and run.shard.impl == "mesh"
    assert run.degradations == 0
    assert sum(run.shard_rows) == SIZES["lineorder_rows"]
    assert list(got) == list(want)
    for col, w in want.items():
        assert got[col].dtype == w.dtype, col
        if w.dtype.kind == "f":
            np.testing.assert_allclose(got[col], w, rtol=1e-5, atol=0)
        else:
            np.testing.assert_array_equal(got[col], w)


def test_metadata_xml_roundtrip():
    """The port's metadata store reads its own XML back (the reference's
    ``from_xml`` tests an element's truth value, which Python 3.12
    deprecates, and fails under the test settings)."""
    q = queries.build_q1(ssb.generate(lineorder_rows=2_000, customers=50,
                                      suppliers=10, parts=40, seed=1))
    store = MetadataStore()
    run = OptimizedEngine(q.flow, OptimizeOptions(backend="torch_cpu",
                                                  num_splits=2),
                          metadata=store).run()
    assert run.backend == "torch_cpu"
    text = store.to_xml()
    back = MetadataStore.from_xml(text)
    assert back.to_xml() == text
    assert back.dataflows.keys() == store.dataflows.keys()


def test_port_imports_no_jax():
    code = ("import sys; import repro_torch, repro_torch.core, "
            "repro_torch.etl, repro_torch.core.backend.torch_backend, "
            "repro_torch.kernels, repro_torch.session, "
            "repro_torch.etl.kettle, repro_torch.core.simulate, "
            "repro_torch.obs.report, repro_torch.configs.ssb_etl, "
            "repro_torch.core.shard.proc, repro_torch.core.shard.mesh; "
            "from repro_torch import (Session, flow, FlowBuilder, "
            "ServeSession, TickResult, replay_deltas, ServingEngine); "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro')]; "
            "assert not bad, bad")
    env = dict(os.environ,
               PYTHONPATH=str(Path(__file__).resolve().parents[1] / "src"))
    subprocess.run([sys.executable, "-c", code], check=True, env=env)
