"""Resident serving in the port (``repro_torch.Session.serve``), the
counterpart of ``tests/test_serving.py``.

- Serve vs batch: replaying a serving session's per-tick deltas on
  ``torch_cpu`` is byte-identical to the one-shot streaming run of the same
  flow, fused and unfused, for generated flows (the reference's generator,
  copied here).
- Against the reference: for fixed flows, each tick's delta equals the
  reference's ``jax`` serving session's tick: same columns, dtypes, row
  order and bytes (the data is exact integers, so float32 partial sums are
  exact), and the same per-tick transfer and compile counters.
- Semantics, retries and dead letters, and aliasing of the emitted deltas.

Every session is closed by a ``with`` block or a ``finally``.
"""
import ctypes

import numpy as np
import pytest

try:
    import hypothesis.strategies as st
    from hypothesis import given, settings
except ImportError:        # pragma: no cover — env without the `test` extra
    from _hypothesis_compat import given, settings, st

import repro
import repro_torch
from repro.core.faults import FaultPlan as RefFaultPlan
from repro.core.faults import fault_scope as ref_fault_scope
from repro_torch import replay_deltas
from repro_torch.core import config, faults
from repro_torch.core.faults import FaultPlan, FaultRule, fault_scope
from repro_torch.kernels import _cuda

ROWS = 2_000
KEYSPACE = 30
N_EXAMPLES = 10
#: per-tick counters held equal to the reference's
TICK_COUNTERS = ("segment_compiles", "dim_h2d_transfers", "dim_h2d_bytes",
                 "h2d_transfers", "h2d_bytes", "d2h_transfers", "d2h_bytes",
                 "copies", "retries", "degradations")


# ---------------------------------------------------------------------------
#  spec -> (serve flow, batch flow) builders, for either package
# ---------------------------------------------------------------------------
def _make_data(seed, rows=ROWS):
    r = np.random.RandomState(seed)
    # bounded integer values: every partial sum a serving tick can merge
    # stays exactly representable in float32 (< 2^24), so incremental
    # tick-by-tick accumulation is bit-identical to the one-shot reduction
    return {
        "k0": r.randint(1, KEYSPACE + 1, rows).astype(np.int64),
        "g": r.randint(0, 5, rows).astype(np.int64),
        "v0": r.randint(0, 100, rows).astype(np.int64),
        "v1": r.randint(-50, 50, rows).astype(np.int64),
    }


def _dim(dim_seed, drop):
    rd = np.random.RandomState(dim_seed)
    nk = KEYSPACE if not drop else KEYSPACE // 2    # some unmatched keys
    return (np.arange(1, nk + 1, dtype=np.int64),
            {"pay": rd.randint(0, 9, nk).astype(np.int64)})


def build_serving_flow(spec, data, empty_source, pkg=repro_torch):
    """A fresh Flow from a drawn spec.  Deterministic: the same spec always
    builds the same flow; ``empty_source=True`` builds the serving variant
    (schema-only source, fed via ticks)."""
    seed, ops, agg = spec
    src = ({c: a[:0] for c, a in data.items()} if empty_source else data)
    b = pkg.flow(f"serve-{seed}").source(src)
    avail = list(data.keys())
    for i, op in enumerate(ops):
        kind = op[0]
        if kind == "filter":
            col_i, thresh = op[1:]
            col = avail[col_i % len(avail)]
            b = b.filter(pkg.col(col) % 97 < thresh)
        elif kind == "lookup":
            dim_seed, key_i, drop = op[1:]
            key = avail[key_i % len(avail)]
            out = f"l{i}"
            b = b.lookup(_dim(dim_seed, drop), key, {out: "pay"})
            avail.append(out)
        elif kind == "derive":
            a_i, b_i, mul = op[1:]
            a, c = avail[a_i % len(avail)], avail[b_i % len(avail)]
            out = f"e{i}"
            # factor capped at 3: chained multiplying derives keep every
            # per-group partial sum < 2^24 (exact float32 accumulation)
            expr = (pkg.col(a) * (pkg.col(c) % 3 + 1) if mul
                    else pkg.col(a) + pkg.col(c))
            b = b.derive(out, expr)
            avail.append(out)
    group_by = None
    if agg is not None:
        g_i, v_i, agg_op = agg
        group = avail[g_i % len(avail)]
        val = avail[v_i % len(avail)]
        b = b.aggregate([group], {"out": (val, agg_op),
                                  "cnt": (val, "count")})
        group_by = [group]
    return b.sink(), group_by


@st.composite
def serve_spec(draw):
    seed = draw(st.integers(0, 10_000))
    n_ops = draw(st.integers(0, 4))
    ops = []
    for _ in range(n_ops):
        kind = draw(st.sampled_from(["filter", "lookup", "derive", "derive"]))
        if kind == "filter":
            ops.append(("filter", draw(st.integers(0, 9)),
                        draw(st.integers(10, 90))))
        elif kind == "lookup":
            ops.append(("lookup", draw(st.integers(0, 1000)),
                        draw(st.integers(0, 3)),
                        draw(st.sampled_from([True, False]))))
        else:
            ops.append(("derive", draw(st.integers(0, 9)),
                        draw(st.integers(0, 9)),
                        draw(st.sampled_from([True, False]))))
    agg = None
    if draw(st.sampled_from([True, False])):
        agg = (draw(st.integers(0, 9)), draw(st.integers(0, 9)),
               draw(st.sampled_from(["sum", "avg", "min", "max", "count"])))
    return (seed, ops, agg)


def _session(pkg=repro_torch):
    return pkg.Session(backend="torch_cpu" if pkg is repro_torch else "jax",
                       metadata=None)


def _assert_same_table(got, want, what):
    assert list(got) == list(want), what
    for k, w in want.items():
        assert got[k].dtype == w.dtype, f"{what}: dtype of {k}"
        assert got[k].tobytes() == w.tobytes(), f"{what}: {k}"


def _serve_vs_batch(spec, ticks=3, fuse=None):
    seed, _, _ = spec
    data = _make_data(seed)
    batch, group_by = build_serving_flow(spec, data, empty_source=False)
    session = _session()
    ref = session.run(batch, engine="streaming", fuse=fuse).table

    serve_f, _ = build_serving_flow(spec, data, empty_source=True)
    deltas = []
    with session.serve(serve_f, fuse=fuse) as srv:
        for idx in np.array_split(np.arange(ROWS), ticks):
            deltas.append(srv.tick({c: a[idx] for c, a in data.items()}))
    rep = replay_deltas(deltas, group_by=group_by)
    if not ref or not len(next(iter(ref.values()))):
        assert sum(r.rows_out for r in deltas) == 0, spec
        return
    assert set(rep) == set(ref), spec
    for k in ref:
        assert rep[k].dtype == ref[k].dtype, (k, spec)
        assert rep[k].tobytes() == ref[k].tobytes(), (k, spec)


# ---------------------------------------------------------------------------
#  the property: serve == batch, byte for byte, on torch_cpu
# ---------------------------------------------------------------------------
@given(serve_spec())
@settings(max_examples=N_EXAMPLES, deadline=None)
def test_serve_replay_byte_identical_to_batch(spec):
    _serve_vs_batch(spec, fuse=False)


@given(serve_spec())
@settings(max_examples=N_EXAMPLES, deadline=None)
def test_serve_replay_byte_identical_fused(spec):
    """The same property with segment fusion on (compiled segments resident
    across ticks)."""
    _serve_vs_batch(spec, fuse=True)


# ---------------------------------------------------------------------------
#  tick by tick against the reference's serving session on jax
# ---------------------------------------------------------------------------
#: (spec, ticks, empty tick inserted after this tick or None, fuse)
REF_SPECS = [
    ((7, [("lookup", 3, 0, False), ("derive", 0, 4, True)], (1, 5, "sum")),
     5, None, True),
    ((17, [("lookup", 3, 0, True), ("derive", 2, 4, True)], (1, 5, "avg")),
     4, 1, True),
    ((23, [("filter", 2, 55), ("derive", 0, 2, False)], None), 4, None, True),
    ((31, [("filter", 2, 1)], (1, 2, "sum")), 3, 0, False),
    ((41, [("derive", 2, 3, True), ("filter", 3, 60)], (0, 4, "min")),
     4, None, True),
    ((5, [("lookup", 10, 1, False), ("filter", 3, 40)], (2, 6, "max")),
     3, 2, False),
]


def _serve_ticks(pkg, spec, ticks, empty_after, fuse):
    data = _make_data(spec[0])
    f, group_by = build_serving_flow(spec, data, empty_source=True, pkg=pkg)
    batches = [{c: a[idx] for c, a in data.items()}
               for idx in np.array_split(np.arange(ROWS), ticks)]
    if empty_after is not None:
        batches.insert(empty_after + 1, {c: a[:0] for c, a in data.items()})
    with _session(pkg).serve(f, fuse=fuse, num_splits=4) as srv:
        return [srv.tick(b) for b in batches], group_by


@pytest.mark.parametrize("spec,ticks,empty_after,fuse", REF_SPECS)
def test_serve_ticks_equal_reference(spec, ticks, empty_after, fuse):
    got, group_by = _serve_ticks(repro_torch, spec, ticks, empty_after, fuse)
    want, _ = _serve_ticks(repro, spec, ticks, empty_after, fuse)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert (g.tick, g.rows_in, g.rows_out) == (w.tick, w.rows_in,
                                                   w.rows_out)
        _assert_same_table(g.delta, w.delta, f"tick {g.tick}")
        for name in TICK_COUNTERS:
            assert g.cache_stats[name] == w.cache_stats[name], (g.tick, name)
        assert not (g.retries or g.dead_lettered)
    _assert_same_table(replay_deltas(got, group_by=group_by),
                       repro.replay_deltas(want, group_by=group_by), "replay")
    if empty_after is not None:
        empty = got[empty_after + 1]
        assert empty.rows_in == 0 and empty.rows_out == 0


def test_warm_ticks_zero_recompiles_and_dim_uploads():
    """The reference's baseline: the cold tick compiles the fused segment
    and uploads the dimension table; warm ticks do neither."""
    spec = REF_SPECS[0][0]
    got, _ = _serve_ticks(repro_torch, spec, 5, None, True)
    cold, warm = got[0], got[1:]
    assert cold.cache_stats["segment_compiles"] >= 1
    assert cold.cache_stats["dim_h2d_transfers"] >= 1
    for t in warm:
        assert t.cache_stats["segment_compiles"] == 0, t.tick
        assert t.cache_stats["dim_h2d_transfers"] == 0, t.tick


def test_all_agg_ops_single_and_many_ticks():
    for agg_op in ("sum", "avg", "min", "max", "count"):
        for ticks in (1, 4):
            _serve_vs_batch((17, [("lookup", 3, 0, True),
                                  ("derive", 2, 4, True)],
                             (1, 5, agg_op)), ticks=ticks)


def test_empty_tick_delta_dtypes_equal_reference():
    """A session whose first tick is empty emits the reference's empty
    delta: the same columns and dtypes, no rows."""
    spec = (31, [("derive", 0, 2, False)], (1, 2, "avg"))
    outs = []
    for pkg in (repro_torch, repro):
        data = _make_data(31, rows=40)
        f, _ = build_serving_flow(spec, data, empty_source=True, pkg=pkg)
        with _session(pkg).serve(f) as srv:
            outs.append(srv.tick({c: a[:0] for c, a in data.items()}).delta)
    _assert_same_table(outs[0], outs[1], "empty tick")
    assert all(len(v) == 0 for v in outs[0].values())


# ---------------------------------------------------------------------------
#  semantics: watermarks, lifecycle, validation
# ---------------------------------------------------------------------------
def _tiny_session(**opts):
    data = _make_data(3, rows=40)
    f, _ = build_serving_flow((3, [], None), data, empty_source=True)
    return _session().serve(f, **opts), data


def test_watermark_regression_raises_by_default(monkeypatch):
    monkeypatch.delenv(config.ENV_SERVE_STRICT_WATERMARK, raising=False)
    srv, data = _tiny_session()
    batch = {c: a[:5] for c, a in data.items()}
    try:
        srv.tick(batch, watermark=100.0)
        with pytest.raises(ValueError, match="watermark regressed"):
            srv.tick(batch, watermark=99.0)
        assert srv.watermark == 100.0
        srv.tick(batch, watermark=100.0)
        srv.tick(batch, watermark=101.5)
        assert srv.watermark == 101.5
    finally:
        srv.close()


def test_watermark_regression_clamps_when_lenient(monkeypatch):
    monkeypatch.setenv(config.ENV_SERVE_STRICT_WATERMARK, "0")
    srv, data = _tiny_session()
    batch = {c: a[:5] for c, a in data.items()}
    try:
        srv.tick(batch, watermark=100.0)
        r = srv.tick(batch, watermark=42.0)     # clamped, not raised
        assert r.watermark == 100.0 and srv.watermark == 100.0
        r = srv.tick(batch)                     # untimed keeps the mark
        assert r.watermark == 100.0
    finally:
        srv.close()


def test_history_is_capped(monkeypatch):
    monkeypatch.setenv(config.ENV_SERVE_HISTORY, "3")
    srv, data = _tiny_session()
    try:
        for _ in range(5):
            srv.tick({c: a[:5] for c, a in data.items()})
        assert [t.tick for t in srv.history] == [2, 3, 4]
    finally:
        srv.close()


def test_close_is_idempotent_and_tick_after_close_raises():
    srv, data = _tiny_session()
    try:
        srv.tick({c: a[:5] for c, a in data.items()})
    finally:
        s1 = srv.close()
    s2 = srv.close()
    assert s1["ticks"] == s2["ticks"] == 1
    assert s1["engine"] == "serving" and s1["backend"] == "torch_cpu"
    assert srv.closed
    with pytest.raises(RuntimeError, match="closed"):
        srv.tick({c: a[:5] for c, a in data.items()})


def test_flow_reusable_after_serving_session():
    """close() ends serving mode: the same flow then batch-runs correctly,
    and a fresh serve() on it works too."""
    data = _make_data(29)
    spec = (29, [("derive", 0, 2, False)], (1, 4, "sum"))
    f, group_by = build_serving_flow(spec, data, empty_source=True)
    session = _session()
    with session.serve(f) as srv:
        deltas = [srv.tick({c: a[idx] for c, a in data.items()})
                  for idx in np.array_split(np.arange(ROWS), 2)]
    first = replay_deltas(deltas, group_by=group_by)
    src = next(c for c in f.flow.vertices.values()
               if type(c).__name__ == "ArraySource")
    src.set_data(data)
    batch = session.run(f, engine="streaming").table
    _assert_same_table(first, batch, "first session")
    src.set_data({c: a[:0] for c, a in data.items()})
    with session.serve(f) as srv2:
        deltas2 = [srv2.tick({c: a[idx] for c, a in data.items()})
                   for idx in np.array_split(np.arange(ROWS), 3)]
    _assert_same_table(replay_deltas(deltas2, group_by=group_by), batch,
                       "second session")


def test_serve_rejects_adaptive_optimizer():
    data = _make_data(3, rows=40)
    f, _ = build_serving_flow((3, [], None), data, empty_source=True)
    with pytest.raises(ValueError, match="optimize"):
        _session().serve(f, optimize=2)


def test_serve_rejects_explicit_shards_like_the_reference(monkeypatch):
    """An explicit shards > 1 raises the reference's ValueError at the first
    tick (a batch run shards, a serving session does not); ambient
    REPRO_SHARDS is ignored, as in the reference."""
    srv, data = _tiny_session(shards=2)
    try:
        with pytest.raises(ValueError, match="sharded execution"):
            srv.tick({c: a[:5] for c, a in data.items()})
    finally:
        srv.close()
    monkeypatch.setenv(config.ENV_SHARDS, "2")
    srv, data = _tiny_session()
    try:
        assert srv.tick({c: a[:5] for c, a in data.items()}).rows_out == 5
    finally:
        srv.close()


def test_serve_rejects_mid_flow_sort():
    data = _make_data(3, rows=40)
    f = (repro_torch.flow("bad").source({c: a[:0] for c, a in data.items()})
         .sort(["k0"]).derive("d", repro_torch.col("v0") + 1).sink())
    srv = _session().serve(f)
    try:
        with pytest.raises(ValueError, match="Sort"):
            srv.tick({c: a[:5] for c, a in data.items()})
    finally:
        srv.close()


def test_serve_rejects_non_terminal_aggregate():
    data = _make_data(3, rows=40)
    f = (repro_torch.flow("bad-agg")
         .source({c: a[:0] for c, a in data.items()})
         .aggregate(["g"], {"s": ("v0", "sum")})
         .derive("d", repro_torch.col("s") + 1).sink())
    srv = _session().serve(f)
    try:
        with pytest.raises(ValueError, match="sinks only"):
            srv.tick({c: a[:5] for c, a in data.items()})
    finally:
        srv.close()


def test_serve_needs_a_sink_and_one_source():
    data = _make_data(3, rows=40)
    f, _ = build_serving_flow((3, [], None), data, empty_source=True)
    with pytest.raises(ValueError, match="collecting sink"):
        _session().serve(f.flow)


# ---------------------------------------------------------------------------
#  retries and dead letters
# ---------------------------------------------------------------------------
def _fault_flow(pkg=repro_torch):
    schema = {"k": np.zeros(0, np.int64), "v": np.zeros(0, np.int64)}
    return (pkg.flow("faulty-serve").source(schema)
            .derive("e", pkg.col("v") + 1)
            .aggregate(["k"], {"out": ("e", "sum"), "cnt": ("e", "count")})
            .sink())


def _tick_cols(seed, rows=40):
    r = np.random.RandomState(seed)
    return {"k": r.randint(0, 5, rows).astype(np.int64),
            "v": r.randint(0, 100, rows).astype(np.int64)}


def test_transient_tick_retried_merges_once(monkeypatch):
    monkeypatch.setenv(config.ENV_RETRY_BACKOFF, "0.001")
    runs = []
    for pkg, plan_cls, scope in ((repro_torch, FaultPlan, fault_scope),
                                 (repro, RefFaultPlan, ref_fault_scope)):
        plan = plan_cls.parse("tick:kind=transient,count=2")
        with _session(pkg).serve(_fault_flow(pkg)) as srv, scope(plan):
            runs.append([srv.tick(_tick_cols(s)) for s in range(3)])
        assert plan.injected == 2
    got, want = runs
    assert [t.retries for t in got] == [t.retries for t in want]
    assert sum(t.retries for t in got) == 2
    assert not any(t.dead_lettered for t in got)
    for g, w in zip(got, want):
        _assert_same_table(g.delta, w.delta, f"tick {g.tick}")
    with _session().serve(_fault_flow()) as clean:
        ref = [clean.tick(_tick_cols(s)) for s in range(3)]
    _assert_same_table(replay_deltas(got), replay_deltas(ref), "replay")


def test_poison_tick_dead_lettered_session_survives():
    plan = FaultPlan.parse("tick:kind=poison,count=1")
    with _session().serve(_fault_flow()) as srv:
        with fault_scope(plan):
            bad = srv.tick(_tick_cols(0))
        good = srv.tick(_tick_cols(1))
        assert bad.dead_lettered and bad.delta == {}
        assert len(srv.dead_letters) == 1
        dl = srv.dead_letters[0]
        assert dl["attempts"] == 1              # poison: no retries
        np.testing.assert_array_equal(dl["columns"]["k"],
                                      _tick_cols(0)["k"])
        assert not good.dead_lettered and good.rows_out > 0
        assert srv.dead_letters.maxlen == config.DEAD_LETTER_MAX
    with _session().serve(_fault_flow()) as clean:
        want = clean.tick(_tick_cols(1))
    _assert_same_table(good.delta, want.delta, "tick after the poison")


def test_dead_letter_buffer_is_bounded(monkeypatch):
    monkeypatch.setattr(config, "DEAD_LETTER_MAX", 4)
    plan = FaultPlan([FaultRule("tick", kind="poison", count=6)])
    with _session().serve(_fault_flow()) as srv, fault_scope(plan):
        for s in range(6):
            assert srv.tick(_tick_cols(s, rows=4)).dead_lettered
        assert len(srv.dead_letters) == 4
        np.testing.assert_array_equal(srv.dead_letters[0]["columns"]["v"],
                                      _tick_cols(2, rows=4)["v"])


# ---------------------------------------------------------------------------
#  a kernel library that cannot load is permanent, never retried
# ---------------------------------------------------------------------------
def _refuse_load(monkeypatch, exc):
    def cdll(path, *a, **k):
        raise exc
    monkeypatch.setattr(_cuda, "_lib", None)
    monkeypatch.setattr(_cuda, "_build", lambda: _cuda.lib_path())
    monkeypatch.setattr(ctypes, "CDLL", cdll)


def test_library_load_error_classifies_permanent(monkeypatch):
    _refuse_load(monkeypatch, OSError("cannot open shared object file"))
    with pytest.raises(RuntimeError) as ei:
        _cuda.library()
    assert str(_cuda.lib_path()) in str(ei.value)
    assert faults.classify(ei.value) == "permanent"
    assert faults.classify(OSError("x")) == "transient"


def test_library_build_os_error_classifies_permanent(monkeypatch):
    def no_compiler():
        raise FileNotFoundError("nvcc")
    monkeypatch.setattr(_cuda, "_lib", None)
    monkeypatch.setattr(_cuda, "_build", no_compiler)
    with pytest.raises(RuntimeError, match="could not be built") as ei:
        _cuda.library()
    assert faults.classify(ei.value) == "permanent"


def test_tick_that_cannot_load_the_kernels_raises(monkeypatch):
    """A tick whose kernel library fails to load aborts with the error: it
    is neither retried nor dead-lettered, and the session lives on."""
    from repro_torch.etl.components import Filter
    _refuse_load(monkeypatch, OSError("cannot open shared object file"))
    armed = {"on": False}

    def needs_kernels(cache, rows):
        if armed["on"]:
            _cuda.library()
        return cache.col("v")[rows] >= 0

    b = repro_torch.flow("kernel-load").source(
        {"k": np.zeros(0, np.int64), "v": np.zeros(0, np.int64)})
    b._append(Filter("needs-kernels", needs_kernels, reads=["v"]))
    f = b.aggregate(["k"], {"s": ("v", "sum")}).sink()
    with _session().serve(f, fuse=False) as srv:
        armed["on"] = True
        with pytest.raises(RuntimeError, match="could not be built or "
                                               "loaded"):
            srv.tick(_tick_cols(0))
        assert not srv.dead_letters and srv.history == []
        armed["on"] = False
        assert srv.tick(_tick_cols(1)).rows_out > 0


# ---------------------------------------------------------------------------
#  aliasing: emitted deltas own their bytes
# ---------------------------------------------------------------------------
def test_delta_held_from_tick_zero_is_unchanged_later(monkeypatch):
    """A delta held from tick 0 keeps its bytes through three more ticks,
    with poisoned arena releases on: neither the delta's key columns nor
    the stored partials view a buffer a later tick reuses."""
    monkeypatch.setenv("REPRO_CACHE_GUARD", "1")
    data = _make_data(11)
    spec = (11, [("lookup", 3, 0, False), ("derive", 0, 4, True)],
            (1, 5, "sum"))
    f, _ = build_serving_flow(spec, data, empty_source=True)
    splits = np.array_split(np.arange(ROWS), 4)
    with _session().serve(f, fuse=True) as srv:
        first = srv.tick({c: a[splits[0]] for c, a in data.items()})
        held = {k: (v, v.copy()) for k, v in first.delta.items()}
        agg = next(c for c in f.flow.vertices.values()
                   if hasattr(c, "serving_snapshot"))
        parts = {p: [np.copy(x) for x in v]
                 for p, v in agg._serving.partials.items()}
        for idx in splits[1:]:
            srv.tick({c: a[idx] for c, a in data.items()})
        for k, (v, copy) in held.items():
            assert v.tobytes() == copy.tobytes(), k
            assert not np.shares_memory(v, agg._serving.partials["out"][0])
        n0 = len(parts["out"])
        for p, v in parts.items():
            # the first tick's groups merged on: their values may grow, but
            # each stored partial is a scalar of its own, not a view
            assert all(np.ndim(x) == 0 for x in agg._serving.partials[p])
            assert len(agg._serving.partials[p]) >= n0
