"""Degradation ladders and fault tolerance in the port, the counterpart of
the ladder tests of ``tests/test_faults.py``, the fused fault tests of
``tests/test_fusion.py`` and the fault and kernel-route properties of
``tests/test_optimizer_equivalence.py``.

- The ladders are ``torch_cpu``'s: join ``reference -> searchsorted`` and
  groupby ``reference -> sort``, plus the fused segment's host fallback.
  Transient and injected permanent/poison faults, ``REPRO_DEGRADE=0`` and a
  kernel library that cannot load never step.  The card has no ladder: a
  kernel failure on CUDA tensors raises.  That rule is checked on a
  stand-in backend whose device is a CUDA card (no card here: only the
  route choice runs).
- Against the reference: SSB Q4.1 with the probe, and with the grouped sum,
  made to fail once on ``torch_cpu`` and on ``jax`` (both starting at the
  ``reference`` rung, so both step to the same legacy route): byte-
  identical keys, order, counts and dtypes, float sums within rtol 1e-5,
  one ``kernel`` degradation each with the same source and target, and
  equal transfer and dispatch counters; the same for a served session
  whose grouped sum fails on one tick, tick by tick.
- The properties: sinks under seeded transient fault plans are byte-
  identical to the fault-free sink, and the ``reference`` kernel routes are
  byte-identical to the legacy routes and to the numpy backend.

Every test gets fresh backend instances: the sticky routes live on the
registry's singletons.
"""
import os
import threading
import types

import numpy as np
import pytest
import torch

try:
    import hypothesis.strategies as st
    from hypothesis import given, settings
except ImportError:        # pragma: no cover — env without the `test` extra
    from _hypothesis_compat import given, settings, st

import repro
import repro_torch
from _torch_flows import build_flow, flow_spec
from repro.core import faults as ref_faults
from repro.core import OptimizeOptions as RefOptions
from repro.core import StreamingEngine as RefStreaming
from repro.core.backend import base as ref_registry
from repro.etl import queries as ref_queries
from repro.etl import ssb as ref_ssb
from repro_torch import replay_deltas
from repro_torch.core import (OptimizeOptions, StreamingEngine, config,
                              faults, get_backend)
from repro_torch.core.backend import base as registry
from repro_torch.core.backend import torch_backend
from repro_torch.core.backend.torch_backend import TorchBackend
from repro_torch.core.faults import (PermanentFault, PoisonFault,
                                     TransientFault, fault_recorder)
from repro_torch.etl import queries, ssb
from repro_torch.core.shared_cache import SharedCache
from repro_torch.etl.components import (DimTable, FusedSegment, Lookup,
                                        segment_fallback_allowed)
from repro_torch.kernels import KernelLibraryError

N_EXAMPLES = int(os.environ.get("REPRO_OPTEQ_EXAMPLES", "100"))
SIZES = dict(lineorder_rows=20_000, customers=600, suppliers=60, parts=800,
             seed=5)
#: EngineRun counters a degraded run holds equal to the reference's
COUNTERS = ("h2d_transfers", "h2d_bytes", "d2h_transfers", "d2h_bytes",
            "dispatch_calls")
#: per-tick CacheStats counters a served session holds equal to the
#: reference's
TICK_COUNTERS = ("segment_compiles", "dim_h2d_transfers", "dim_h2d_bytes",
                 "h2d_transfers", "h2d_bytes", "d2h_transfers", "d2h_bytes",
                 "copies", "retries", "degradations")
LAUNCH_ERROR = "hash_probe: CUDA error 7 (too many resources requested for " \
               "launch)"


@pytest.fixture(autouse=True)
def _fresh_backends(monkeypatch):
    """No ambient fault plan or ladder switch, and fresh backend instances:
    the registry builds a dropped one on first use; afterwards the test's
    instance (its routes possibly stepped) is dropped and the old one put
    back, so no step outlives the test."""
    for var in (config.ENV_FAULTS, config.ENV_DEGRADE, config.ENV_JOIN_IMPL,
                config.ENV_GROUPBY_IMPL):
        monkeypatch.delenv(var, raising=False)
    saved = [(reg, name, reg.pop(name, None))
             for reg, name in ((registry._instances, "torch_cpu"),
                               (registry._instances, "numpy"),
                               (ref_registry._instances, "jax"))]
    yield
    for reg, name, inst in saved:
        reg.pop(name, None)
        if inst is not None:
            reg[name] = inst


@pytest.fixture(scope="module")
def data():
    return ssb.generate(**SIZES), ref_ssb.generate(**SIZES)


def _card_standin() -> TorchBackend:
    """A backend whose ladders are the card's: its device says CUDA.  Only
    the route choice is exercised; nothing runs on it."""
    bk = TorchBackend("cpu")
    bk.device = torch.device("cuda", 0)
    bk.name = "torch"
    return bk


def _fail_once(fn, calls):
    """``fn`` behind a double whose first call raises a launch-style error;
    ``calls`` counts the calls that went through after it."""
    state = {"failed": False}

    def double(*args, **kwargs):
        if not state["failed"]:
            state["failed"] = True
            raise RuntimeError(LAUNCH_ERROR)
        calls.append(1)
        return fn(*args, **kwargs)
    return double


# ---------------------------------------------------------------------------
#  ladder units
# ---------------------------------------------------------------------------
def test_degraded_impl_walks_ladder_and_sticks():
    bk = TorchBackend("cpu")
    with fault_recorder() as rec:
        assert bk._degraded_impl("join", "auto", ValueError("x")) \
            == "searchsorted"
        assert bk._join_route == "searchsorted"
        # ladder floor: nothing below the legacy route
        assert bk._degraded_impl("join", "searchsorted",
                                 ValueError("x")) is None
        assert bk._degraded_impl("groupby", "reference",
                                 RuntimeError(LAUNCH_ERROR)) == "sort"
        assert bk._degraded_impl("groupby", "sort", ValueError("x")) is None
    assert bk._join_route == "searchsorted"
    assert bk._groupby_route == "sort"
    assert [(d.kind, d.src, d.dst) for d in rec.degradations] == [
        ("kernel", "join[reference]", "searchsorted"),
        ("kernel", "groupby[reference]", "sort")]


@pytest.mark.parametrize("exc", [
    ValueError("val_cols[0] must be a CUDA tensor, got cpu"),
    RuntimeError(LAUNCH_ERROR),
    RuntimeError("radix_groupby: CUDA error 209 (no kernel image is "
                 "available for execution on the device)"),
    RuntimeError("segment_sum: CUDA error 98 (invalid device function)")],
    ids=["argument", "launch", "no_image", "invalid_function"])
def test_card_kernel_failure_never_steps(exc):
    """The card has no ladder: whatever a kernel raises on CUDA tensors,
    from any route, propagates with no step and no recorded degradation, so
    no other route can hide a kernel that fails."""
    bk = _card_standin()
    with fault_recorder() as rec:
        for kind in ("join", "groupby"):
            for impl in ("auto", "cuda", "reference"):
                assert bk._degraded_impl(kind, impl, exc) is None
    assert bk._join_route is None and bk._groupby_route is None
    assert rec.degradations == []


def test_degraded_impl_propagates_transient_and_injected():
    bk = TorchBackend("cpu")
    with fault_recorder() as rec:
        # transient => replay retries the SAME route instead of degrading
        assert bk._degraded_impl("join", "reference",
                                 TransientFault("t")) is None
        assert bk._degraded_impl("join", "reference",
                                 ConnectionError("t")) is None
        # injected permanent/poison faults must abort, not silently degrade
        assert bk._degraded_impl("groupby", "reference",
                                 PermanentFault("p")) is None
        assert bk._degraded_impl("groupby", "reference",
                                 PoisonFault("p")) is None
    assert bk._join_route is None and bk._groupby_route is None
    assert rec.degradations == []


def test_degrade_disabled_by_env(monkeypatch):
    monkeypatch.setenv(config.ENV_DEGRADE, "0")
    assert config.snapshot()["degrade"] is False
    bk = TorchBackend("cpu")
    assert bk._degraded_impl("join", "auto", ValueError("x")) is None
    assert bk._degraded_impl("groupby", "auto", ValueError("x")) is None
    assert bk._join_route is None and bk._groupby_route is None


def test_kernel_library_error_never_steps():
    """A library that cannot be built or loaded aborts: a slower route would
    hide a kernel that is not there.  It is still a permanent failure."""
    bk = TorchBackend("cpu")
    err = KernelLibraryError("the CUDA kernel library could not be loaded")
    assert isinstance(err, RuntimeError)
    assert faults.classify(err) == "permanent"
    assert not faults.may_degrade(err)
    with fault_recorder() as rec:
        for kind in ("join", "groupby"):
            for impl in ("auto", "reference"):
                assert bk._degraded_impl(kind, impl, err) is None
    assert bk._join_route is None and bk._groupby_route is None
    assert rec.degradations == []


@pytest.mark.parametrize("failure", ["load", "no_nvcc", "no_entry_point"])
def test_library_failures_raise_kernel_library_error(monkeypatch, failure):
    """Every way the library can fail to build or load raises
    ``KernelLibraryError``, which the ladders refuse to step on."""
    import ctypes
    from repro_torch.kernels import _cuda
    monkeypatch.setattr(_cuda, "_lib", None)
    if failure == "no_nvcc":
        monkeypatch.setenv("CUDA_HOME", "/nonexistent")
        monkeypatch.setattr(_cuda.shutil, "which", lambda name: None)
        monkeypatch.setattr(_cuda, "lib_path",
                            lambda: _cuda.BUILD_ROOT / "absent" / "lib.so")
    else:
        monkeypatch.setattr(_cuda, "_build", lambda: _cuda.lib_path())

        def cdll(path, *a, **k):
            if failure == "load":
                raise OSError("cannot open shared object file")
            return types.SimpleNamespace()      # no entry points
        monkeypatch.setattr(ctypes, "CDLL", cdll)
    with pytest.raises(KernelLibraryError) as ei:
        _cuda.library()
    assert not faults.may_degrade(ei.value)
    assert faults.classify(ei.value) == "permanent"


def test_two_threads_failing_on_one_rung_step_once():
    bk = TorchBackend("cpu")
    barrier = threading.Barrier(4)
    got = []

    def fail():
        barrier.wait()
        got.append(bk._degraded_impl("join", "auto",
                                     RuntimeError(LAUNCH_ERROR)))

    with fault_recorder() as rec:
        # the recorder is a context variable: each thread runs in a copy
        import contextvars
        threads = [threading.Thread(target=contextvars.copy_context().run,
                                    args=(fail,)) for _ in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
    assert got == ["searchsorted"] * 4
    assert len(rec.degradations) == 1


def test_failure_on_the_last_rung_propagates(monkeypatch):
    """A sticky device error fails the legacy route too: the second error
    propagates after one recorded step, and nothing loops."""
    bk = TorchBackend("cpu")
    seen = []

    def always_fails(dim, vals, impl):
        seen.append(impl)
        raise RuntimeError(f"{impl}: CUDA error 700 (an illegal memory "
                           f"access was encountered)")
    monkeypatch.setattr(bk, "_probe", always_fails)
    dim = DimTable(np.arange(1, 9, dtype=np.int64),
                   {"pay": np.arange(8, dtype=np.int64)})
    with fault_recorder() as rec:
        with pytest.raises(RuntimeError, match="searchsorted: CUDA error"):
            bk.searchsorted_probe(dim, np.array([1, 2, 3], dtype=np.int64))
    assert seen == ["auto", "searchsorted"]
    assert [d.dst for d in rec.degradations] == ["searchsorted"]


def test_value_error_steps_like_the_reference():
    """The reference steps on any non-transient, non-injected error, an
    argument check's ``ValueError`` included; the port keeps that rule."""
    bk = TorchBackend("cpu")
    assert bk._degraded_impl("join", "auto", ValueError(
        "val_cols[0] must be a CUDA tensor, got cpu")) == "searchsorted"


# ---------------------------------------------------------------------------
#  the fused segment's rung
# ---------------------------------------------------------------------------
def _segment_and_cache():
    dim = DimTable(np.arange(1, 9, dtype=np.int64),
                   {"pay": np.arange(10, 18, dtype=np.int64)})
    seg = FusedSegment.from_components(
        [Lookup("lk", dim, "k", {"p": "pay"})])
    keys = np.arange(0, 12, dtype=np.int64)
    return seg, SharedCache({"k": keys}, len(keys))


def _broken_compile(exc):
    def compile_segment(segment):
        def runner(cache):
            raise exc
        return runner
    return compile_segment


def test_segment_fallback_allowed_only_off_the_card():
    assert segment_fallback_allowed(TorchBackend("cpu"))
    assert segment_fallback_allowed(get_backend("numpy"))
    assert not segment_fallback_allowed(_card_standin())
    assert not segment_fallback_allowed(
        types.SimpleNamespace(name="torch", device=torch.device("cuda", 0)))


def test_segment_failure_on_the_card_propagates(monkeypatch):
    """On the card a runner failure that its join ladder did not absorb
    aborts: no host pass, no degradation."""
    bk = _card_standin()
    monkeypatch.setattr(bk, "compile_segment", _broken_compile(
        RuntimeError("segment: CUDA error 9 (invalid configuration "
                     "argument)")))
    seg, cache = _segment_and_cache()
    with fault_recorder() as rec:
        with pytest.raises(RuntimeError, match="invalid configuration"):
            seg._dispatch(bk, cache)
    assert rec.degradations == []


@pytest.mark.parametrize("exc", [
    KernelLibraryError("could not be built or loaded"),
    PermanentFault("p"), TransientFault("t")])
def test_segment_failures_that_never_step(monkeypatch, exc):
    bk = TorchBackend("cpu")
    monkeypatch.setattr(bk, "compile_segment", _broken_compile(exc))
    seg, cache = _segment_and_cache()
    with fault_recorder() as rec:
        with pytest.raises(type(exc)):
            seg._dispatch(bk, cache)
    assert rec.degradations == []


def test_segment_host_fallback_on_torch_cpu_sticks(monkeypatch):
    bk = TorchBackend("cpu")
    monkeypatch.setattr(bk, "compile_segment", _broken_compile(
        RuntimeError(LAUNCH_ERROR)))
    seg, cache = _segment_and_cache()
    with fault_recorder() as rec:
        seg._dispatch(bk, cache)
        seg._dispatch(bk, _segment_and_cache()[1])
    assert [(d.src, d.dst) for d in rec.degradations] == [
        ("segment[torch_cpu]", "reference")]
    k = np.arange(0, 12)
    # Lookup's default for an unmatched key is -1
    np.testing.assert_array_equal(np.asarray(cache.col("p")),
                                  np.where((k >= 1) & (k <= 8), k + 9, -1))


# ---------------------------------------------------------------------------
#  SSB Q4.1 failing once, on the port and on the reference
# ---------------------------------------------------------------------------
def _assert_tables_close(got, want, label):
    assert list(got) == list(want), label
    for col, w in want.items():
        assert got[col].dtype == w.dtype, f"{label}: dtype of {col}"
        if w.dtype.kind == "f":
            np.testing.assert_allclose(got[col], w, rtol=1e-5, atol=0,
                                       err_msg=f"{label}: {col}")
        else:
            np.testing.assert_array_equal(got[col], w,
                                          err_msg=f"{label}: {col}")


@pytest.mark.parametrize("kind,fuse", [("join", False), ("groupby", False),
                                       ("groupby", True)])
def test_q41_kernel_failing_once_matches_reference(data, monkeypatch, kind,
                                                   fuse):
    """Both packages start at the ``reference`` rung and step to the same
    legacy route (the reference's own ladder from ``auto`` passes through
    the Pallas interpreter, a route the port does not have).  The fused
    reference runs its lookups inside one traced program, not through the
    probe, so the join case runs unfused."""
    monkeypatch.setenv(config.ENV_JOIN_IMPL, "reference")
    monkeypatch.setenv(config.ENV_GROUPBY_IMPL, "reference")
    port_calls, ref_calls = [], []
    name = "hash_probe" if kind == "join" else "radix_groupby"
    monkeypatch.setattr(torch_backend, name, _fail_once(
        getattr(torch_backend, name), port_calls))
    rbk = ref_registry.get_backend("jax")
    attr = f"_{name}"
    monkeypatch.setattr(rbk, attr, _fail_once(getattr(rbk, attr), ref_calls))

    td, rd = data
    tq, rq = queries.build_q4(td), ref_queries.build_q4(rd)
    trun = StreamingEngine(tq.flow, OptimizeOptions(
        backend="torch_cpu", fuse_segments=fuse, num_splits=4)).run()
    rrun = RefStreaming(rq.flow, RefOptions(
        backend="jax", fuse_segments=fuse, num_splits=4)).run()
    _assert_tables_close(tq.sink.result(), rq.sink.result(), kind)
    floor = "searchsorted" if kind == "join" else "sort"
    for run in (trun, rrun):
        assert [(d["kind"], d["src"], d["dst"])
                for d in run.degradation_events] == [
            ("kernel", f"{kind}[reference]", floor)]
    for c in COUNTERS:
        assert getattr(trun, c) == getattr(rrun, c), c
    # sticky: the failed kernel is never called again
    assert port_calls == [] and ref_calls == []
    assert getattr(get_backend("torch_cpu"), f"_{kind}_route") == floor


def test_fused_q41_probe_failure_steps_inside_the_runner(data, monkeypatch):
    """A probe failure inside the fused segment steps the join ladder and
    the segment carries on, on its runner (no ``segment`` step).  The
    reference's fused runner probes inside one traced program, which the
    probe's double cannot reach, so the port's degraded run is held against
    the reference's clean fused run on ``jax``: the same sink, and the same
    d2h and dispatch counters (the segment carries on in its runner).  The
    legacy route uploads no hash table, so the later lookups upload less."""
    calls = []
    monkeypatch.setattr(torch_backend, "hash_probe", _fail_once(
        torch_backend.hash_probe, calls))
    td, rd = data
    tq, rq = queries.build_q4(td), ref_queries.build_q4(rd)
    run = StreamingEngine(tq.flow, OptimizeOptions(
        backend="torch_cpu", fuse_segments=True, num_splits=4)).run()
    rrun = RefStreaming(rq.flow, RefOptions(
        backend="jax", fuse_segments=True, num_splits=4)).run()
    _assert_tables_close(tq.sink.result(), rq.sink.result(), "fused join")
    assert [(d["src"], d["dst"]) for d in run.degradation_events] == [
        ("join[reference]", "searchsorted")]
    assert rrun.degradations == 0
    for c in ("d2h_transfers", "d2h_bytes", "dispatch_calls"):
        assert getattr(run, c) == getattr(rrun, c), c
    assert 0 < run.h2d_bytes < rrun.h2d_bytes
    assert calls == []


@pytest.mark.parametrize("where", ["probe", "groupby", "degrade_off"])
def test_q41_failures_that_abort(data, monkeypatch, where):
    """A probe whose kernel library cannot load, the same for the grouped
    sum, and a probe failing once with ``REPRO_DEGRADE=0``: each run aborts
    with its error and records no degradation."""
    def no_library(*args, **kwargs):
        raise KernelLibraryError("the CUDA kernel library could not be "
                                 "built or loaded")
    if where == "degrade_off":
        monkeypatch.setenv(config.ENV_DEGRADE, "0")
        monkeypatch.setattr(torch_backend, "hash_probe", _fail_once(
            torch_backend.hash_probe, []))
        expected = RuntimeError
    else:
        name = "hash_probe" if where == "probe" else "radix_groupby"
        monkeypatch.setattr(torch_backend, name, no_library)
        expected = KernelLibraryError
    q = queries.build_q4(data[0])
    with fault_recorder() as rec:
        with pytest.raises(expected):
            StreamingEngine(q.flow, OptimizeOptions(
                backend="torch_cpu", fuse_segments=True,
                num_splits=4)).run()
    assert rec.degradations == []
    bk = get_backend("torch_cpu")
    assert bk._join_route is None and bk._groupby_route is None


# ---------------------------------------------------------------------------
#  the fused fault tests of tests/test_fusion.py
# ---------------------------------------------------------------------------
FUSION_SIZES = dict(lineorder_rows=12_000, customers=500, suppliers=80,
                    parts=300, seed=11)


@pytest.fixture(scope="module")
def fusion_data():
    return ssb.generate(**FUSION_SIZES)


def _q41_streaming(d):
    q = queries.build_q4(d)
    run = StreamingEngine(q.flow, OptimizeOptions(
        backend="torch_cpu", num_splits=4, fuse_segments=True)).run()
    return q, run


def test_fault_retry_under_guard_no_poisoned_reuse(fusion_data, monkeypatch):
    """Mid-segment transient faults abort chunks that already wrote into
    arena-pooled buffers; under ``REPRO_CACHE_GUARD=1`` (recycled buffers
    poisoned, double releases raise) the retried run equals the fault-free
    one byte for byte."""
    baseline = _q41_streaming(fusion_data)[0].sink.result()
    monkeypatch.setenv(config.ENV_CACHE_GUARD, "1")
    monkeypatch.setenv(config.ENV_RETRY_BACKOFF, "0.001")
    plan = faults.FaultPlan.parse(
        "seed=3; kernel:kind=transient,count=1,after=1; "
        "chunk:kind=transient,count=1")
    with faults.fault_scope(plan):
        q, run = _q41_streaming(fusion_data)
    faulty = q.sink.result()
    assert run.faults_injected == plan.injected >= 1
    assert run.retries >= 1
    assert run.degradations == 0
    for k in baseline:
        np.testing.assert_array_equal(faulty[k], baseline[k], err_msg=k)


def test_permanent_fault_aborts_and_releases_buffers(fusion_data,
                                                     monkeypatch):
    """A permanent mid-segment fault aborts promptly (no retries, no
    degradation), hands every in-flight buffer back once (the guard raises
    on a double release), and the same flow objects rerun byte-identically
    to a fresh run."""
    monkeypatch.setenv(config.ENV_CACHE_GUARD, "1")
    q = queries.build_q4(fusion_data)
    plan = faults.FaultPlan.parse("kernel:kind=permanent,after=1")
    with faults.fault_scope(plan), fault_recorder() as rec:
        with pytest.raises(PermanentFault):
            StreamingEngine(q.flow, OptimizeOptions(
                backend="torch_cpu", num_splits=4,
                fuse_segments=True)).run()
    assert plan.injected == 1 and rec.degradations == []
    run = StreamingEngine(q.flow, OptimizeOptions(
        backend="torch_cpu", num_splits=4, fuse_segments=True)).run()
    rerun = q.sink.result()
    assert run.retries == 0 and run.faults_injected == 0
    ref = _q41_streaming(fusion_data)[0].sink.result()
    for k in ref:
        np.testing.assert_array_equal(rerun[k], ref[k], err_msg=k)


# ---------------------------------------------------------------------------
#  serving: a tick that degrades
# ---------------------------------------------------------------------------
def _tick_cols(seed, rows=60):
    r = np.random.RandomState(seed)
    return {"k": r.randint(0, 5, rows).astype(np.int64),
            "v": r.randint(0, 100, rows).astype(np.int64)}


def _serve_failing_on_tick(pkg, fail, ticks=4):
    """``ticks`` served ticks of a grouped sum on ``pkg``'s session, with
    ``fail`` installed; returns the results and, per tick, the
    ``(kind, src, dst)`` of the degradations recorded during it."""
    f = pkg.flow("degrade-serve").source(
        {"k": np.zeros(0, np.int64), "v": np.zeros(0, np.int64)}).aggregate(
        ["k"], {"s": ("v", "sum"), "n": ("v", "count")}).sink()
    recorder = (fault_recorder if pkg is repro_torch
                else ref_faults.fault_recorder)
    results, events = [], []
    with pkg.Session(backend="torch_cpu" if pkg is repro_torch else "jax",
                     metadata=None).serve(f, fuse=True,
                                          num_splits=4) as srv:
        for i in range(ticks):
            fail["tick"] = i
            with recorder() as rec:
                results.append(srv.tick(_tick_cols(i)))
            events.append([(d.kind, d.src, d.dst) for d in rec.degradations])
    return results, events


def _fails_on_tick_1(real, fail):
    def double(*args, **kwargs):
        if fail["tick"] == 1 and not fail["failed"]:
            fail["failed"] = True
            raise RuntimeError("radix_groupby: CUDA error 7 (too many "
                               "resources requested for launch)")
        fail["calls"].append(fail["tick"])
        return real(*args, **kwargs)
    return double


def test_served_tick_degrades_and_later_ticks_stay_on_the_rung(monkeypatch):
    """The grouped sum fails on tick 1, on the port and on the reference's
    serving session on ``jax`` (both at the ``reference`` rung): the tick
    steps the groupby ladder, completes and reports the step; ticks 2 and 3
    stay on the sort route (the resident backend keeps it).  Tick by tick,
    the deltas, the degradations and the cache counters equal the
    reference's."""
    monkeypatch.setenv(config.ENV_GROUPBY_IMPL, "reference")
    port_fail = {"tick": 0, "failed": False, "calls": []}
    ref_fail = {"tick": 0, "failed": False, "calls": []}
    monkeypatch.setattr(torch_backend, "radix_groupby", _fails_on_tick_1(
        torch_backend.radix_groupby, port_fail))
    rbk = ref_registry.get_backend("jax")
    monkeypatch.setattr(rbk, "_radix_groupby", _fails_on_tick_1(
        rbk._radix_groupby, ref_fail))
    got, got_events = _serve_failing_on_tick(repro_torch, port_fail)
    want, want_events = _serve_failing_on_tick(repro, ref_fail)
    step = [("kernel", "groupby[reference]", "sort")]
    assert got_events == want_events == [[], step, [], []]
    assert [[(d["kind"], d["src"], d["dst"]) for d in r.degradation_events]
            for r in got] == [[], step, [], []]
    # never again after the step, on either package
    assert port_fail["calls"] == ref_fail["calls"] == [0]
    assert get_backend("torch_cpu")._groupby_route == "sort"
    for g, w in zip(got, want):
        assert (g.tick, g.rows_in, g.rows_out) == (w.tick, w.rows_in,
                                                   w.rows_out)
        assert g.retries == w.retries == 0
        assert not (g.dead_lettered or w.dead_lettered)
        _assert_tables_close(g.delta, w.delta, f"tick {g.tick}")
        for name in TICK_COUNTERS:
            assert g.cache_stats[name] == w.cache_stats[name], (g.tick, name)
    assert [g.cache_stats["degradations"] for g in got] == [0, 1, 0, 0]
    _assert_tables_close(replay_deltas(got, ["k"]),
                         repro.replay_deltas(want, ["k"]), "replay")


# ---------------------------------------------------------------------------
#  properties (the reference harness's strategies and example counts)
# ---------------------------------------------------------------------------
@st.composite
def fault_rules(draw):
    """1-3 transient single-fire rules, as in the reference harness."""
    n = draw(st.integers(1, 3))
    rules = []
    for _ in range(n):
        rules.append(dict(
            site=draw(st.sampled_from(["chunk", "chunk", "kernel", "edge",
                                       "arena"])),
            kind="transient", count=1,
            after=draw(st.integers(0, 4)),
            split=draw(st.sampled_from([None, None, 0, 1]))))
    return rules


def _with_env(values, fn):
    saved = {k: os.environ.get(k) for k in values}
    os.environ.update(values)
    try:
        return fn()
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def _assert_fault_tolerant(spec, rule_kws, fuse):
    _, num_splits, _ = spec

    def run_flow():
        flow, sink = build_flow(spec)
        run = StreamingEngine(flow, OptimizeOptions(
            backend="torch_cpu", num_splits=num_splits,
            fuse_segments=fuse)).run()
        return run, sink.result()

    _, baseline = run_flow()
    plan = faults.FaultPlan([faults.FaultRule(**kw) for kw in rule_kws],
                            seed=1)

    def faulty_run():
        with faults.fault_scope(plan):
            return run_flow()
    run, faulty = _with_env({config.ENV_RETRY_BACKOFF: "0.001"}, faulty_run)
    label = f"spec={spec} rules={rule_kws} fuse={fuse}"
    assert set(faulty) == set(baseline), f"{label}: column sets differ"
    for k in baseline:
        assert faulty[k].dtype == baseline[k].dtype, f"{label}: dtype of {k}"
        np.testing.assert_array_equal(
            faulty[k], baseline[k],
            err_msg=f"{label}: column {k} differs under fault plan")
    assert run.faults_injected == plan.injected, label
    # a transient fault is retried on the same route, never stepped around
    assert not [d for d in run.degradation_events if d["kind"] == "kernel"]


@given(flow_spec(), fault_rules(), st.sampled_from([True, False]))
@settings(max_examples=max(N_EXAMPLES // 4, 10), deadline=None)
def test_transient_fault_plans_byte_identical(spec, rule_kws, fuse):
    """For every generated DAG and every seeded transient fault plan, the
    retried run's sink is byte-identical to the fault-free sink."""
    _assert_fault_tolerant(spec, rule_kws, fuse)


def test_fault_plan_run_level_replay_deterministic():
    """Source, accumulate and edge faults escalate to run-level replay; the
    rerun is byte-identical."""
    spec = (7, 4, [("lookup", 3, 0, True),
                   ("expr", 3, 4, False),
                   ("boundary",),
                   ("filter", 4, 30, True),
                   ("agg", 2, 5, "sum"),
                   ("sort", 0)])
    rules = [dict(site="chunk", kind="transient", count=1, after=0),
             dict(site="edge", kind="transient", count=1),
             dict(site="chunk", kind="transient", count=1, after=7)]
    _assert_fault_tolerant(spec, rules, fuse=True)


def _run_with_impls(spec, backend, join_impl, groupby_impl):
    _, num_splits, _ = spec

    def run():
        flow, sink = build_flow(spec)
        StreamingEngine(flow, OptimizeOptions(
            num_splits=num_splits, backend=backend)).run()
        return sink.result()
    return _with_env({config.ENV_JOIN_IMPL: join_impl,
                      config.ENV_GROUPBY_IMPL: groupby_impl}, run)


def _assert_tables_equal(got, oracle, label, check_dtype=True):
    assert set(got) == set(oracle), f"{label}: column sets differ"
    for k in oracle:
        if check_dtype:
            assert got[k].dtype == oracle[k].dtype, f"{label}: dtype of {k}"
        np.testing.assert_array_equal(got[k], oracle[k],
                                      err_msg=f"{label}: column {k}")


@given(flow_spec())
@settings(max_examples=max(N_EXAMPLES // 4, 10), deadline=None)
def test_kernel_impl_routes_byte_identical(spec):
    """For every generated DAG: ``torch_cpu`` on the kernels' ``reference``
    routes (the hash probe and the dense groupby) gives sinks byte-
    identical to the legacy ``searchsorted`` + ``sort`` routes, and equal in
    value to the numpy backend (int widths differ by design)."""
    oracle = _run_with_impls(spec, "numpy", "searchsorted", "sort")
    legacy = _run_with_impls(spec, "torch_cpu", "searchsorted", "sort")
    kernel = _run_with_impls(spec, "torch_cpu", "reference", "reference")
    _assert_tables_equal(kernel, legacy, f"kernel-vs-legacy (spec={spec})")
    _assert_tables_equal(kernel, oracle, f"kernel-vs-oracle (spec={spec})",
                         check_dtype=False)
