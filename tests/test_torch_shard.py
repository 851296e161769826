"""Sharded execution in the port (``repro_torch.core.shard``), the
counterpart of ``tests/test_shard.py``, held against the JAX reference
(``repro.core.shard``) on the same inputs.

- Partitioner and planner: the port's shard ids, bounds, partitions and
  auto shard counts equal the reference's; ``auto`` resolves to ``mesh`` on
  ``torch_cpu`` and to ``inline`` on ``numpy``.
- partial -> merge of every agg op, global and float-avg aggregates, more
  shards than groups, staged row order and per-shard counters on
  ``torch_cpu``, inline and mesh, each against the reference's run of the
  same flow on ``jax`` over the same route and against the port's serial
  run; the mesh combiner against the host ``reduce_partials``.
- Replay, degradations, spans, options and metadata.
- SSB Q4.1 and Q1.1 at 1, 2 and 4 shards, inline and mesh, against the
  reference on ``jax`` over the same route (the reference's mesh against
  the port's) and against the port's serial run; Q4.1 on the process
  route, byte-identical to serial.

Tolerances: group keys, counts, row order and dtypes are identical; float32
sums agree within rtol 1e-5 (shards add float32 values in another order
than the serial run and than the reference); the h2d, d2h and dispatch
counters equal the reference's.
"""
import io
import pickle

import numpy as np
import pytest
import torch

from repro.core import Dataflow as RefDataflow
from repro.core import OptimizeOptions as RefOptions
from repro.core import StreamingEngine as RefStreaming
from repro.core import StageBoundary as RefStageBoundary
from repro.core import cache_stats_scope as ref_cache_stats_scope
from repro.core import partition as ref_partition
from repro.core import plan_runtime as ref_plan_runtime
from repro.core import plan_shards as ref_plan_shards
from repro.core import resolve_backend as ref_resolve_backend
from repro.core.engine import _assign_backend as ref_assign_backend
from repro.core.shard import ShardRunner as RefShardRunner
from repro.core.shard import choose_shards as ref_choose_shards
from repro.core.shard import partitioner as ref_partitioner
from repro.etl import components as ref_components
from repro.etl import queries as ref_queries
from repro.etl import ssb as ref_ssb
from repro_torch.core import (Dataflow, MetadataStore, OptimizeOptions,
                              StreamingEngine, cache_stats_scope, config,
                              faults, get_backend, partition, plan_runtime,
                              plan_shards, resolve_backend)
from repro_torch.core.engine import _assign_backend
from repro_torch.core.shard import ShardRunner, choose_shards, proc
from repro_torch.core.shard.merge import reduce_partials
from repro_torch.core.shard.mesh import make_combiner
from repro_torch.core.shard.partitioner import (hash_shard_ids, range_bounds,
                                                shard_tables, table_rows)
from repro_torch.core.shard.planner import MAX_AUTO_SHARDS, MIN_SHARD_ROWS
from repro_torch.etl import components as port_components
from repro_torch.etl import queries, ssb
from repro_torch.etl.components import (Aggregate, ArraySource, CollectSink,
                                        Filter)
from repro_torch.obs import trace as obs_trace

ROWS = 12_000
BK = "torch_cpu"
SIZES = dict(lineorder_rows=20_000, customers=600, suppliers=60, parts=800,
             seed=5)
COUNTERS = ("h2d_transfers", "d2h_transfers", "dispatch_calls")


def _table(seed=0, rows=ROWS):
    r = np.random.RandomState(seed)
    return {"g": r.randint(0, 7, rows).astype(np.int64),
            "h": r.randint(0, 3, rows).astype(np.int64),
            "v": r.randint(-1000, 1000, rows).astype(np.int64),
            "f": r.uniform(-1.0, 1.0, rows)}


def _agg_flow(ops, group=("g",), seed=0, rows=ROWS, name="aggflow"):
    """src -> Aggregate(group, ops) -> sink, picklable (no lambdas)."""
    flow = Dataflow(name)
    sink = CollectSink("sink")
    flow.chain(ArraySource("src", _table(seed, rows)),
               Aggregate("agg", list(group), dict(ops)),
               sink)
    return flow, sink


def _ref_agg_flow(ops, group=("g",), seed=0, rows=ROWS, name="aggflow"):
    """The same flow built from the reference's components."""
    flow = RefDataflow(name)
    sink = ref_components.CollectSink("sink")
    flow.chain(ref_components.ArraySource("src", _table(seed, rows)),
               ref_components.Aggregate("agg", list(group), dict(ops)),
               sink)
    return flow, sink


def _run(flow, sink, backend=BK, **opt_kw):
    run = StreamingEngine(flow, OptimizeOptions(num_splits=4, backend=backend,
                                                **opt_kw)).run()
    return run, sink.result()


def _ref_run(flow, sink, **opt_kw):
    run = RefStreaming(flow, RefOptions(num_splits=4, backend="jax",
                                        **opt_kw)).run()
    return run, sink.result()


def _assert_matches_reference(trun, got, rrun, want, label):
    """The port's sharded run against the reference's on the same route:
    tables close, the same shard layout, the same h2d/d2h/dispatch counts
    and no degradation on either side."""
    _assert_tables_close(got, want, label + " vs reference")
    assert trun.shards == rrun.shards, label
    assert trun.shard_rows == rrun.shard_rows, label
    for name in COUNTERS:
        assert getattr(trun, name) == getattr(rrun, name), f"{label}: {name}"
    assert trun.degradations == rrun.degradations == 0, label


def _assert_tables_equal(got, want, label=""):
    assert list(got) == list(want), label
    for k in want:
        assert got[k].dtype == want[k].dtype, f"{label}: dtype of {k}"
        np.testing.assert_array_equal(got[k], want[k],
                                      err_msg=f"{label}: column {k}")


def _assert_tables_close(got, want, label=""):
    """Keys, counts, order and dtypes identical; floats within rtol 1e-5."""
    assert list(got) == list(want), label
    for k in want:
        assert got[k].dtype == want[k].dtype, f"{label}: dtype of {k}"
        if want[k].dtype.kind == "f":
            np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=0,
                                       err_msg=f"{label}: column {k}")
        else:
            np.testing.assert_array_equal(got[k], want[k],
                                          err_msg=f"{label}: column {k}")


# ---------------------------------------------------------------- partitioner
def test_range_bounds_match_reference():
    for rows, shards in [(0, 3), (1, 4), (10, 3), (12_000, 7)]:
        b = range_bounds(rows, shards)
        assert b[0] == 0 and b[-1] == rows
        assert (np.diff(b) >= 0).all()
        np.testing.assert_array_equal(
            b, ref_partitioner.range_bounds(rows, shards))
    with pytest.raises(ValueError):
        range_bounds(10, 0)


def test_hash_shard_ids_match_reference():
    r = np.random.RandomState(3)
    a = r.randint(0, 1 << 40, 50_000).astype(np.int64)
    b = r.randint(-5, 5, 50_000).astype(np.int64)
    ids = hash_shard_ids([a, b], 5)
    assert ids.dtype == np.int64
    assert ids.min() >= 0 and ids.max() < 5
    np.testing.assert_array_equal(ids,
                                  ref_partitioner.hash_shard_ids([a, b], 5))
    # chained mixing: key order matters
    assert not np.array_equal(ids, hash_shard_ids([b, a], 5))
    # splitmix64 spreads even low-cardinality keys across all shards
    assert len(np.unique(ids)) == 5
    with pytest.raises(ValueError):
        hash_shard_ids([], 2)


@pytest.mark.parametrize("mode,key", [("hash", ("g", "h")), ("range", ())])
def test_shard_tables_match_reference(mode, key):
    src = _table(seed=1)
    parts = shard_tables({"src": src}, 4, mode, key=key)
    want = ref_partitioner.shard_tables({"src": src}, 4, mode, key=key)
    assert sum(table_rows(p["src"]) for p in parts) == ROWS
    for got_k, want_k in zip(parts, want):
        _assert_tables_equal(got_k["src"], want_k["src"], mode)
    if mode == "hash":
        # the same key tuple always lands on the same shard: group-disjoint
        seen = {}
        for k, p in enumerate(parts):
            for pair in zip(p["src"]["g"].tolist(), p["src"]["h"].tolist()):
                assert seen.setdefault(pair, k) == k
    else:
        cat = np.concatenate([p["src"]["v"] for p in parts])
        np.testing.assert_array_equal(cat, src["v"])
    with pytest.raises(ValueError):
        shard_tables({"src": src}, 2, "round-robin")


# -------------------------------------------------------------------- planner
def test_choose_shards_matches_reference():
    assert choose_shards(100, 4, cores=8) == 1          # rows floor
    assert choose_shards(MIN_SHARD_ROWS * 100, 4, cores=8) == 4
    assert choose_shards(MIN_SHARD_ROWS * 100, 64, cores=64) == MAX_AUTO_SHARDS
    assert choose_shards(0, 0, cores=1) == 1
    for rows in (0, 5_000, 40_000, 10**7):
        for splits in (0, 1, 4, 32):
            for cores in (1, 3, 16):
                assert (choose_shards(rows, splits, cores=cores)
                        == ref_choose_shards(rows, splits, cores=cores))


@pytest.mark.parametrize("backend,auto", [("torch_cpu", "mesh"),
                                          ("numpy", "inline")])
def test_plan_shards_serial_and_degradations(backend, auto):
    flow, _ = _agg_flow([("s", ("v", "sum"))])
    bk = resolve_backend(backend)
    _assign_backend(flow, bk)
    g_tau = partition(flow)
    opts = OptimizeOptions(num_splits=4)
    assert plan_shards(flow, g_tau, 1, "auto", opts, bk) is None

    plan = plan_shards(flow, g_tau, 3, "auto", opts, bk)
    assert plan is not None and plan.shards == 3 and plan.impl == auto
    assert plan.mode == "hash" and plan.key == ("g",)
    assert plan.spec()["cuts"] == ["agg"]

    with pytest.raises(ValueError):
        plan_shards(flow, g_tau, 2, "threads", opts, bk)

    # a chunk-sensitive source cannot be re-partitioned: serial + recorded
    flow.component("src").chunk_sensitive = True
    with faults.fault_recorder() as frec:
        assert plan_shards(flow, g_tau, 2, "auto", opts, bk) is None
    assert any(d.kind == "shard_plan" for d in frec.degradations)


def test_plan_shards_global_agg_takes_range_mode():
    flow, _ = _agg_flow([("s", ("v", "sum"))], group=())
    bk = resolve_backend(BK)
    _assign_backend(flow, bk)
    plan = plan_shards(flow, partition(flow), 2, "inline",
                       OptimizeOptions(num_splits=4), bk)
    assert plan is not None and plan.mode == "range" and plan.key == ()


# ------------------------------------------------------- partial→merge ops
@pytest.mark.parametrize("route", ["inline", "mesh"])
@pytest.mark.parametrize("op", ["sum", "min", "max", "count", "avg"])
def test_partial_merge_every_agg_op(op, route):
    ops = [("a", ("v", op)), ("b", ("f", op))]
    flow_s, sink_s = _agg_flow(ops, group=("g", "h"))
    _, serial = _run(flow_s, sink_s, shards=1)
    for shards in (2, 3):
        label = f"op={op} {route} shards={shards}"
        flow_n, sink_n = _agg_flow(ops, group=("g", "h"))
        run, got = _run(flow_n, sink_n, shards=shards, shard_impl=route)
        assert run.shards == shards and run.shard.impl == route
        # keyed on source columns: partitioned by hash of (g, h)
        assert run.shard.mode == "hash"
        _assert_tables_close(got, serial, label + " vs serial")
    # the reference's partial -> merge of the same op over the same route
    # (each shard's row count costs the reference a compile: one count)
    rflow, rsink = _ref_agg_flow(ops, group=("g", "h"))
    rrun, want = _ref_run(rflow, rsink, shards=3, shard_impl=route)
    _assert_matches_reference(run, got, rrun, want, f"op={op} {route}")


def test_mesh_combiner_matches_host_reduce(monkeypatch):
    """The mesh combiner against ``reduce_partials`` on the same partials:
    same groups in the same order, identical sums, counts, mins and maxes
    (the float partials are integer-valued, so their float32 sums are exact
    in any order) — every float sum column in ONE segment-sum call, and no
    copy recorded in CacheStats."""
    from repro_torch.core.shard import mesh
    calls = []
    real = mesh.segment_sum

    def spy(ids, vals, n_groups, impl="auto"):
        calls.append((ids.dtype, vals.dtype, tuple(vals.shape), n_groups))
        return real(ids, vals, n_groups, impl=impl)

    monkeypatch.setattr(mesh, "segment_sum", spy)
    r = np.random.RandomState(9)
    n = 3_000
    cat = {"k1": r.randint(1992, 1999, n).astype(np.int32),
           "k2": r.randint(0, 25, n).astype(np.int32),
           "s": r.randint(-1000, 1000, n).astype(np.float32),
           "t": r.randint(0, 5000, n).astype(np.float32),
           "c": r.randint(0, 100, n).astype(np.int64),
           "lo": r.randint(-500, 500, n).astype(np.int32),
           "hi": r.uniform(-5, 5, n).astype(np.float32)}
    ops = {"s": "sum", "t": "sum", "c": "sum", "lo": "min", "hi": "max"}
    combine = make_combiner(get_backend(BK))
    with cache_stats_scope() as stats:
        got_keys, got = combine(cat, ["k1", "k2"], ops)
    want_keys, want = reduce_partials(cat, ["k1", "k2"], ops)
    for g, w in zip(got_keys, want_keys):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    for p in ops:
        assert got[p].dtype == want[p].dtype, p
        np.testing.assert_array_equal(got[p], want[p], err_msg=p)
    assert calls == [(torch.int32, torch.float32, (n, 2), len(want_keys[0]))]
    snap = stats.snapshot()
    assert snap["h2d_transfers"] == snap["d2h_transfers"] == 0
    # ids, the float-sum matrix, then c, lo, hi up; sums, c, lo, hi down
    assert combine.copies["h2d"] == 5 and combine.copies["d2h"] == 4
    # global: one group
    keys, out = combine(cat, [], {"c": "sum", "lo": "min"})
    assert keys == []
    assert out["c"].tolist() == [int(cat["c"].sum())]
    assert out["lo"].tolist() == [int(cat["lo"].min())]


def test_mesh_combiner_refuses_what_32_bits_cannot_hold():
    """The reference's refusals with x64 off: values that do not round-trip
    through the device's 32-bit dtypes, non-numeric columns and empty
    input give None, and the caller reduces on the host."""
    combine = make_combiner(get_backend(BK))
    keys = np.array([1, 2, 1], dtype=np.int64)
    assert combine({"k": keys, "c": np.array([1, 2, 1 << 40])}, ["k"],
                   {"c": "sum"}) is None
    assert combine({"k": keys, "f": np.array([0.1, 0.2, 0.3])}, ["k"],
                   {"f": "sum"}) is None
    assert combine({"k": keys, "o": np.array(["a", "b", "c"], dtype=object)},
                   ["k"], {"o": "min"}) is None
    assert combine({"k": keys[:0], "c": keys[:0]}, ["k"], {"c": "sum"}) is None
    # 64-bit values that round-trip are combined, in their own dtypes
    keys_out, out = combine({"k": keys, "f": np.array([0.5, 2.0, 1.25])},
                            ["k"], {"f": "sum"})
    assert keys_out[0].dtype == np.int64 and out["f"].dtype == np.float64
    assert out["f"].tolist() == [1.75, 2.0]


@pytest.mark.parametrize("route", ["inline", "mesh"])
def test_global_aggregate_sharded(route):
    # integer-valued sums below 2^24 are exact in float32, and avg divides
    # once: identical to serial on every route
    ops = [("s", ("v", "sum")), ("m", ("f", "min")),
           ("c", ("v", "count")), ("a", ("v", "avg"))]
    flow_s, sink_s = _agg_flow(ops, group=())
    _, serial = _run(flow_s, sink_s, shards=1)
    flow_n, sink_n = _agg_flow(ops, group=())
    run, got = _run(flow_n, sink_n, shards=3, shard_impl=route)
    assert run.shards == 3 and run.shard.impl == route
    assert run.shard.mode == "range"
    _assert_tables_equal(got, serial, "global agg")
    rflow, rsink = _ref_agg_flow(ops, group=())
    rrun, want = _ref_run(rflow, rsink, shards=3, shard_impl=route)
    _assert_matches_reference(run, got, rrun, want, f"global agg {route}")


@pytest.mark.parametrize("route", ["inline", "mesh"])
def test_global_float_avg_sharded_ulp_close(route):
    ops = [("a", ("f", "avg"))]
    flow_s, sink_s = _agg_flow(ops, group=())
    _, serial = _run(flow_s, sink_s, shards=1)
    flow_n, sink_n = _agg_flow(ops, group=())
    run, got = _run(flow_n, sink_n, shards=3, shard_impl=route)
    assert got["a"].dtype == serial["a"].dtype
    np.testing.assert_allclose(got["a"], serial["a"], rtol=1e-5)
    rflow, rsink = _ref_agg_flow(ops, group=())
    rrun, want = _ref_run(rflow, rsink, shards=3, shard_impl=route)
    _assert_matches_reference(run, got, rrun, want, f"float avg {route}")


def test_empty_shards_more_shards_than_groups():
    # one distinct key tuple => hash mode puts every row on ONE shard;
    # the other shards run empty passes and must not perturb the merge
    rows = 5_000
    cols = {"g": np.ones(rows, dtype=np.int64),
            "v": np.arange(rows, dtype=np.int64)}

    def build(pkg, df):
        flow = df("onekey")
        sink = pkg.CollectSink("sink")
        flow.chain(pkg.ArraySource("src", dict(cols)),
                   pkg.Aggregate("agg", ["g"], {"s": ("v", "sum"),
                                                "n": ("v", "count")}), sink)
        return flow, sink

    flow_s, sink_s = build(port_components, Dataflow)
    _, serial = _run(flow_s, sink_s, shards=1)
    flow_n, sink_n = build(port_components, Dataflow)
    run, got = _run(flow_n, sink_n, shards=4)
    assert run.shards == 4 and run.shard.impl == "mesh"
    assert run.shard.mode == "hash"
    assert sorted(run.shard_rows) == [0, 0, 0, rows]
    _assert_tables_close(got, serial, "one-key hash")
    rflow, rsink = build(ref_components, RefDataflow)
    rrun, want = _ref_run(rflow, rsink, shards=4, shard_impl="mesh")
    _assert_matches_reference(run, got, rrun, want, "one-key hash")


# ----------------------------------------------------------- fault replay
def test_shard_failure_replays_to_identical_output(monkeypatch):
    monkeypatch.setenv("REPRO_RETRY_BACKOFF", "0.001")
    monkeypatch.setenv("REPRO_CACHE_GUARD", "1")
    monkeypatch.delenv(config.ENV_FAULTS, raising=False)
    ops = [("s", ("v", "sum")), ("a", ("f", "avg"))]
    flow_c, sink_c = _agg_flow(ops)
    _, clean = _run(flow_c, sink_c, shards=3)
    plan = faults.FaultPlan(
        [faults.FaultRule(site="shard", kind="transient", count=2)],
        seed=5)
    flow_n, sink_n = _agg_flow(ops)
    with faults.fault_scope(plan):
        run, got = _run(flow_n, sink_n, shards=3)
    assert plan.injected == 2
    assert run.faults_injected == 2
    assert run.retries >= 2                        # whole-shard replays
    _assert_tables_equal(got, clean, "shard replay")


def test_merge_pass_failure_replays(monkeypatch):
    monkeypatch.setenv("REPRO_RETRY_BACKOFF", "0.001")
    monkeypatch.delenv(config.ENV_FAULTS, raising=False)
    flow_c, sink_c = _agg_flow([("s", ("v", "sum"))])
    _, clean = _run(flow_c, sink_c, shards=2)
    # the merge attempt injects with split=None only after every shard
    # pass took its own injection, so a rule skipping the first
    # ``shards`` matching calls targets the coordinator merge exactly
    plan = faults.FaultPlan(
        [faults.FaultRule(site="shard", kind="transient", count=1,
                          after=2)], seed=1)
    flow_n, sink_n = _agg_flow([("s", ("v", "sum"))])
    with faults.fault_scope(plan):
        run, got = _run(flow_n, sink_n, shards=2)
    assert plan.injected == 1 and run.retries >= 1
    _assert_tables_equal(got, clean, "merge replay")


# ------------------------------------------------------- degrade / refuse
def test_process_route_degrades_under_fault_scope():
    # scoped fault plans cannot cross a process boundary: the runner must
    # fall back to inline (recorded) rather than silently lose injections
    plan = faults.FaultPlan([faults.FaultRule(site="chunk", count=0)], seed=1)
    flow, sink = _agg_flow([("s", ("v", "sum"))])
    with faults.fault_scope(plan):
        run, got = _run(flow, sink, shards=2, shard_impl="process")
    assert run.shards == 2 and run.shard.impl == "inline"
    assert any(d["kind"] == "shard_impl" and d["dst"] == "inline"
               for d in run.degradation_events)
    flow_s, sink_s = _agg_flow([("s", ("v", "sum"))])
    _, serial = _run(flow_s, sink_s, shards=1)
    _assert_tables_close(got, serial, "process degrade")


def test_unpicklable_flow_degrades_to_inline():
    flow = Dataflow("unpick")
    sink = CollectSink("sink")
    flow.chain(ArraySource("src", _table()),
               Filter("keep", lambda c, rows: c.col("v")[rows] > 0,
                      reads=["v"]),
               sink)
    run, got = _run(flow, sink, shards=2, shard_impl="process")
    assert run.shards == 2 and run.shard.impl == "inline"
    assert any(d["kind"] == "shard_impl" for d in run.degradation_events)
    src = _table()["v"]
    np.testing.assert_array_equal(got["v"], src[src > 0])


def test_payloads_carry_host_rows_only(data):
    """A flow that ran on the torch backend (DimTable device caches and
    compiled segment runners filled) pickles into payloads that hold only
    host arrays; a tensor anywhere in a payload is refused."""
    td, _ = data
    q = queries.build_q4(td)
    lookups = [c for c in q.flow.vertices.values()
               if type(c).__name__ == "Lookup"]
    StreamingEngine(q.flow, OptimizeOptions(backend=BK, fuse_segments=True,
                                            num_splits=4)).run()
    assert len(lookups) == 4 and all("_torch_hash_cache" in lk.dim.__dict__
                                     for lk in lookups)
    q.sink.clear()
    bk = resolve_backend(BK)
    g_tau = partition(q.flow)
    opts = OptimizeOptions(backend=BK, num_splits=4, shards=2)
    plan = plan_shards(q.flow, g_tau, 2, "process", opts, bk)
    parts = shard_tables({s: q.flow.component(s).columns
                          for s in plan.sources}, 2, plan.mode, plan.key)
    payloads = proc.build_payloads(q.flow, opts, plan, parts)
    assert payloads is not None and len(payloads) == 2

    class NoTorch(pickle.Unpickler):
        """Loads a payload only if nothing in it is a torch object."""

        def find_class(self, module, name):
            assert module.split(".")[0] != "torch", (module, name)
            return super().find_class(module, name)

    flow_k, _, cuts, k = NoTorch(io.BytesIO(payloads[1])).load()
    assert k == 1 and cuts == plan.cuts
    for comp in flow_k.vertices.values():
        assert getattr(comp, "_compiled", {}) == {}
    assert table_rows(flow_k.component("lineorder").columns) == \
        SIZES["lineorder_rows"] // 2
    with pytest.raises(TypeError, match="torch.Tensor"):
        proc._dumps({"cols": {"x": torch.zeros(3)}})


@pytest.mark.parametrize("shards", [1, 2, 4])
def test_sharded_staged_flow_preserves_row_order(shards):
    # a semi-block cut feeds a row-sync tail: the sink harvests streamed
    # shard-pass caches whose arrival order is scheduler-dependent, so
    # reassembly must restore (shard, split) order
    from repro_torch.core import StageBoundary
    rows = 20_000

    def build(pkg, df, boundary):
        flow = df("staged_order")
        sink = pkg.CollectSink("sink")
        flow.chain(pkg.ArraySource("src",
                                   {"x": np.arange(rows, dtype=np.int64)}),
                   pkg.Filter("keep_even",
                              lambda c, r: c.col("x")[r] % 2 == 0,
                              reads=["x"]),
                   boundary("cut"),
                   pkg.Filter("keep_div4",
                              lambda c, r: c.col("x")[r] % 4 == 0,
                              reads=["x"]),
                   sink)
        return flow, sink

    flow, sink = build(port_components, Dataflow, StageBoundary)
    run = StreamingEngine(flow, OptimizeOptions(
        backend=BK, num_splits=8, shards=shards, shard_impl="inline")).run()
    assert run.shards == shards
    np.testing.assert_array_equal(sink.result()["x"],
                                  np.arange(0, rows, 4))
    rflow, rsink = build(ref_components, RefDataflow, RefStageBoundary)
    rrun = RefStreaming(rflow, RefOptions(
        backend="jax", num_splits=8, shards=shards,
        shard_impl="inline")).run()
    _assert_matches_reference(run, sink.result(), rrun, rsink.result(),
                              f"staged order shards={shards}")


# --------------------------------------------------- counters and metadata
@pytest.mark.parametrize("route", ["inline", "mesh"])
def test_per_shard_counters_sum_to_run_total(route):
    flow, sink = _agg_flow([("s", ("v", "sum"))])
    bk = resolve_backend(BK)
    _assign_backend(flow, bk)
    g_tau = partition(flow)
    opts = OptimizeOptions(backend=BK, num_splits=4, shards=3,
                           shard_impl=route)
    rplan = plan_runtime(flow, g_tau, num_splits=4, m_prime=4, backend=bk)
    plan = plan_shards(flow, g_tau, 3, route, opts, bk)
    assert plan is not None
    with cache_stats_scope() as stats:
        res = ShardRunner(flow, g_tau, opts, rplan, plan).execute()
    total = stats.snapshot()
    by_parts = {}
    for snap in res.shard_stats + [res.merge_stats]:
        for k, v in snap.items():
            by_parts[k] = by_parts.get(k, 0) + v
    assert len(res.shard_stats) == 3 and res.impl == route
    for k in ("copies", "bytes_copied", "h2d_transfers", "h2d_bytes",
              "d2h_transfers", "d2h_bytes", "arena_hits", "arena_misses"):
        assert by_parts[k] == total[k], \
            f"{k}: per-shard {by_parts[k]} != run total {total[k]}"
    assert total["h2d_transfers"] > 0
    assert res.shuffle_bytes > 0
    assert res.scatter_bytes <= res.source_bytes
    assert sum(res.shard_rows) == ROWS
    # the combiner's copies are its own, never in the run's CacheStats
    assert bool(res.combiner_copies) == (route == "mesh")
    assert sink.result()  # merge delivered

    # the reference's runner on the same flow and route: the same shard
    # rows, and the same transfers in each shard and in the merge pass
    rflow, rsink = _ref_agg_flow([("s", ("v", "sum"))])
    rbk = ref_resolve_backend("jax")
    ref_assign_backend(rflow, rbk)
    rg_tau = ref_partition(rflow)
    ropts = RefOptions(backend="jax", num_splits=4, shards=3,
                       shard_impl=route)
    rrplan = ref_plan_runtime(rflow, rg_tau, num_splits=4, m_prime=4,
                              backend=rbk)
    rshard_plan = ref_plan_shards(rflow, rg_tau, 3, route, ropts, rbk)
    with ref_cache_stats_scope():
        rres = RefShardRunner(rflow, rg_tau, ropts, rrplan,
                              rshard_plan).execute()
    assert res.shard_rows == rres.shard_rows
    for k in ("h2d_transfers", "d2h_transfers"):
        assert ([s[k] for s in res.shard_stats] + [res.merge_stats[k]]
                == [s[k] for s in rres.shard_stats]
                + [rres.merge_stats[k]]), k
    _assert_tables_close(sink.result(), rsink.result(),
                         f"counters {route} vs reference")


def test_env_vars_drive_shards(monkeypatch):
    monkeypatch.setenv(config.ENV_SHARDS, "2")
    monkeypatch.setenv(config.ENV_SHARD_IMPL, "inline")
    assert config.snapshot()["shard_impl"] == "inline"
    flow, sink = _agg_flow([("s", ("v", "sum"))])
    run, _ = _run(flow, sink)
    assert run.shards == 2 and len(run.shard_rows) == 2
    assert run.shard.impl == "inline"
    assert "shards=2" in run.summary()
    monkeypatch.setenv(config.ENV_SHARD_IMPL, "threads")
    with pytest.raises(ValueError, match="REPRO_SHARD_IMPL"):
        config.shard_impl()


def test_explicit_opts_override_env(monkeypatch):
    monkeypatch.setenv(config.ENV_SHARDS, "4")
    monkeypatch.setenv(config.ENV_SHARD_IMPL, "process")
    flow, sink = _agg_flow([("s", ("v", "sum"))])
    run, _ = _run(flow, sink, shards=1)
    assert run.shards == 1 and run.shard_rows == []
    assert run.shard is None
    flow, sink = _agg_flow([("s", ("v", "sum"))])
    run, _ = _run(flow, sink, shards=2, shard_impl="mesh")
    assert run.shards == 2 and run.shard.impl == "mesh"


def test_metadata_records_shard_layout_xml_roundtrip():
    """The reference's version of this test fails on its metadata XML
    reader; the port's reads its own XML back."""
    store = MetadataStore()
    flow, sink = _agg_flow([("s", ("v", "sum"))])
    StreamingEngine(flow, OptimizeOptions(backend=BK, num_splits=4, shards=2,
                                          shard_impl="inline"),
                    metadata=store).run()
    spec = store.runs[flow.name]
    assert spec["shards"] == 2 and len(spec["shard_rows"]) == 2
    back = MetadataStore.from_xml(store.to_xml()).runs[flow.name]
    assert back["shards"] == 2
    assert back["shard_rows"] == spec["shard_rows"]


# ------------------------------------------------------------ tracing path
def test_sharded_run_emits_shard_and_merge_spans():
    tr = obs_trace.Tracer(name="shardtrace")
    flow, sink = _agg_flow([("s", ("v", "sum"))])
    with obs_trace.trace_scope(tr):
        StreamingEngine(flow, OptimizeOptions(backend=BK, num_splits=4,
                                              shards=2,
                                              shard_impl="mesh")).run()
    names = [e.get("name") for e in tr.events]
    assert "shard-0" in names and "shard-1" in names
    merge = [e for e in tr.events if e.get("name") == "shard-merge"]
    assert len(merge) == 1
    args = merge[0]["args"]
    assert args["impl"] == "mesh" and args["shards"] == 2
    # the combiner's copies, which CacheStats does not record
    assert args["combiner_h2d"] >= 2 and args["combiner_d2h"] >= 1
    assert args["combiner_h2d_bytes"] > 0


def test_shard_runner_attaches_per_shard_subtracers():
    flow, sink = _agg_flow([("s", ("v", "sum"))])
    bk = resolve_backend(BK)
    _assign_backend(flow, bk)
    g_tau = partition(flow)
    opts = OptimizeOptions(backend=BK, num_splits=4, shards=2,
                           shard_impl="inline")
    rplan = plan_runtime(flow, g_tau, num_splits=4, m_prime=4, backend=bk)
    plan = plan_shards(flow, g_tau, 2, "inline", opts, bk)
    tr = obs_trace.Tracer(name="shardtrace", measuring=False)
    tr.meta = {"flow": flow.name}
    with obs_trace.trace_scope(tr):
        ShardRunner(flow, g_tau, opts, rplan, plan, tracer=tr).execute()
    assert len(tr.shard_tracers) == 2
    for k, sub in enumerate(tr.shard_tracers):
        assert sub.meta["shard"] == k
        assert sub.meta["flow"] == f"{flow.name}[shard{k}]"
        assert any(e.get("name") == f"shard-{k}" for e in sub.events)


# ------------------------------------------------ SSB against the reference
@pytest.fixture(scope="module")
def data():
    return ssb.generate(**SIZES), ref_ssb.generate(**SIZES)


@pytest.fixture(scope="module")
def serial(data):
    """The port's serial fused streaming run of each query."""
    out = {}
    for qname in ("Q4.1", "Q1.1"):
        q = queries.BUILDERS[qname](data[0])
        StreamingEngine(q.flow, OptimizeOptions(
            backend=BK, fuse_segments=True, num_splits=4)).run()
        out[qname] = q.sink.result()
    return out


@pytest.mark.parametrize("qname", ["Q4.1", "Q1.1"])
@pytest.mark.parametrize("shards,route", [(1, "inline"), (2, "inline"),
                                          (2, "mesh"), (4, "inline"),
                                          (4, "mesh")])
def test_query_sharded_matches_reference(qname, shards, route, data, serial):
    td, rd = data
    tq, rq = queries.BUILDERS[qname](td), ref_queries.BUILDERS[qname](rd)
    trun = StreamingEngine(tq.flow, OptimizeOptions(
        backend=BK, fuse_segments=True, num_splits=4, shards=shards,
        shard_impl=route)).run()
    rrun = RefStreaming(rq.flow, RefOptions(
        backend="jax", fuse_segments=True, num_splits=4, shards=shards,
        shard_impl=route)).run()
    got, want = tq.sink.result(), rq.sink.result()
    label = f"{qname} shards={shards} {route}"
    _assert_tables_close(got, want, label + " vs reference")
    _assert_tables_close(got, serial[qname], label + " vs serial")
    rtol = get_backend(BK).oracle_rtol
    for col, o in tq.oracle(td).items():
        np.testing.assert_allclose(got[col], o, rtol=rtol)
    assert trun.shards == rrun.shards == shards
    assert trun.shard_rows == rrun.shard_rows
    if shards > 1:
        assert trun.shard.impl == route and trun.shard.mode == "range"
        assert sum(trun.shard_rows) == SIZES["lineorder_rows"]
    for name in COUNTERS:
        assert getattr(trun, name) == getattr(rrun, name), name
    assert trun.degradations == rrun.degradations == 0


def _suppkey_flow(pkg, df, lineorder):
    """lineorder -> Aggregate(lo_suppkey: revenue sum, row count) -> sink,
    keyed on a source column, so the planner partitions by hash."""
    flow = df("suppkey-revenue")
    sink = pkg.CollectSink("sink")
    flow.chain(pkg.ArraySource("lineorder", lineorder),
               pkg.Aggregate("by_supplier", ["lo_suppkey"],
                             {"revenue": ("lo_revenue", "sum"),
                              "orders": ("lo_revenue", "count")}),
               sink)
    return flow, sink


@pytest.mark.parametrize("shards,route", [(2, "inline"), (4, "mesh")])
def test_hash_mode_flow_matches_reference(shards, route, data):
    td, rd = data
    flow_s, sink_s = _suppkey_flow(port_components, Dataflow, td.lineorder)
    _, serial_t = _run(flow_s, sink_s, shards=1)
    flow, sink = _suppkey_flow(port_components, Dataflow, td.lineorder)
    run, got = _run(flow, sink, shards=shards, shard_impl=route)
    assert run.shards == shards and run.shard.impl == route
    assert run.shard.mode == "hash"
    rflow, rsink = _suppkey_flow(ref_components, RefDataflow, rd.lineorder)
    rrun, want = _ref_run(rflow, rsink, shards=shards, shard_impl=route)
    label = f"lo_suppkey shards={shards} {route}"
    _assert_matches_reference(run, got, rrun, want, label)
    _assert_tables_close(got, serial_t, label + " vs serial")
    uniq, inv = np.unique(td.lineorder["lo_suppkey"], return_inverse=True)
    np.testing.assert_array_equal(got["lo_suppkey"], uniq)
    np.testing.assert_array_equal(got["orders"], np.bincount(inv))
    np.testing.assert_allclose(
        got["revenue"],
        np.bincount(inv, weights=td.lineorder["lo_revenue"]
                    .astype(np.float64)),
        rtol=get_backend(BK).oracle_rtol)


def test_q41_sharded_process_route_byte_identical(data, serial):
    """The reference's acceptance query: Q4.1 at shards=2 over the process
    route is byte-identical to serial and actually fans out."""
    q = queries.build_q4(data[0])
    run = StreamingEngine(q.flow, OptimizeOptions(
        backend=BK, fuse_segments=True, num_splits=4, shards=2,
        shard_impl="process")).run()
    assert run.shards == 2 and run.shard.impl == "process"
    assert not any(d["kind"] == "shard_impl"
                   for d in run.degradation_events), "process route degraded"
    assert sum(run.shard_rows) == SIZES["lineorder_rows"]
    _assert_tables_equal(q.sink.result(), serial["Q4.1"], "Q4.1 process")
    # the workers' counters fold into the run (each worker plans chunks
    # for its own rows and uploads the dimension tables afresh, so they
    # are not the inline route's); on the CPU no kernel is launched
    assert run.dispatch_calls > 0 and run.h2d_transfers > 0
    assert run.shard.worker_launches == {}
    assert run.shard.payload_bytes > 0 and run.shard.payload_seconds > 0
    proc.close_pool()
