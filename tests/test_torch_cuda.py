"""The port's CUDA kernels on the card, against their plain torch versions,
and the ``torch`` backend against ``torch_cpu`` on a small SSB flow.

Marked ``cuda``: without a CUDA device (or ``nvcc``) every test skips.  On a
machine with one:  PYTHONPATH=src python -m pytest -m cuda
tests/test_torch_cuda.py

Tolerances: probe results and counts are byte-identical; integer-valued
sums are exact (below 2^24 in float32); a second launch on the same input is
bit-identical to the first.
"""
import numpy as np
import pytest
import torch

from repro_torch.core import OptimizedEngine, OptimizeOptions
from repro_torch.etl import queries, ssb
from repro_torch.kernels import launch_counts, reset_launches
from repro_torch.kernels.hash_join import (hash_build, hash_probe,
                                           hash_probe_cuda, hash_probe_ref,
                                           pack_table)
from repro_torch.kernels.radix_groupby import (radix_groupby,
                                               radix_groupby_ref)
from repro_torch.kernels.segment_sum import segment_sum, segment_sum_ref

pytestmark = pytest.mark.cuda
RNG = np.random.default_rng(5)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _same(a, b):
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(a, b)


@pytest.mark.parametrize("n_keys", [1, 2])
def test_hash_probe_kernel_matches_plain(dev, n_keys):
    rows = np.unique(RNG.integers(-3_000, 3_000, size=(5_000, n_keys)),
                     axis=0)
    RNG.shuffle(rows)
    built = hash_build(tuple(rows[:, j] for j in range(n_keys)))
    sk = tuple(torch.from_numpy(k.astype(np.int32)).to(dev)
               for k in built["slot_keys"])
    si = torch.from_numpy(built["slot_idx"]).to(dev)
    probes = RNG.integers(-3_100, 3_100, size=(70_001, n_keys))
    vals = tuple(torch.from_numpy(probes[:, j].astype(np.int32)).to(dev)
                 for j in range(n_keys))
    table = pack_table(sk, si)
    reset_launches()
    idx, found = hash_probe(table, vals, built["max_probes"])
    idx2, found2 = hash_probe(table, vals, built["max_probes"])
    assert launch_counts()["hash_probe"] == 2
    ridx, rfound = hash_probe_ref(sk, si, vals, built["max_probes"])
    assert _same(idx, ridx) and _same(found, rfound)
    assert _same(idx, idx2) and _same(found, found2)


# The probe against the plain version, byte for byte: 1-4 key columns,
# misses, duplicate keys (first row wins), n = 0, row counts that are not a
# multiple of the kernel's 4 rows a thread, key columns off 16-byte
# alignment (row-by-row loads), a short max_probes, enough rows that each
# thread takes several groups, and tables from 2 KB to the 4 MB of SSB SF1
# part.
@pytest.mark.parametrize("n_keys,d,n,dup,offset,max_probes", [
    (1, 600, 70_001, False, 0, None), (2, 600, 70_002, True, 0, None),
    (3, 600, 70_003, False, 1, None), (4, 600, 70_000, True, 3, None),
    (1, 600, 0, False, 0, None), (4, 600, 5, False, 0, None),
    (1, 600, 2_000_003, True, 0, None), (2, 600, 30_000, False, 0, 2),
    (1, 200_000, 1_000_001, False, 0, None),
    (2, 60_000, 300_001, True, 2, None)])
def test_hash_probe_packed_matches_plain(dev, n_keys, d, n, dup, offset,
                                         max_probes):
    span = max(400, d)
    rows = np.unique(RNG.integers(-span, span, size=(d, n_keys)), axis=0)
    RNG.shuffle(rows)
    if dup:
        rows = np.concatenate([rows, rows[: len(rows) // 3]])
    built = hash_build(tuple(rows[:, j] for j in range(n_keys)))
    sk = tuple(torch.from_numpy(k.astype(np.int32)).to(dev)
               for k in built["slot_keys"])
    si = torch.from_numpy(built["slot_idx"]).to(dev)
    table = pack_table(sk, si)
    mp = built["max_probes"] if max_probes is None else max_probes
    probes = RNG.integers(-span - 20, span + 20, size=(n, n_keys))
    hit = RNG.random(n) < 0.6
    probes[hit] = rows[RNG.integers(0, len(rows), int(hit.sum()))]

    def column(j):
        flat = torch.empty(n + offset, dtype=torch.int32, device=dev)
        out = flat[offset:]
        out.copy_(torch.from_numpy(probes[:, j].astype(np.int32)))
        return out
    vals = tuple(column(j) for j in range(n_keys))
    reset_launches()
    idx, found = hash_probe_cuda(table, vals, mp)
    idx2, found2 = hash_probe_cuda(table, vals, mp)
    assert launch_counts()["hash_probe"] == (2 if n else 0)
    ridx, rfound = hash_probe_ref(sk, si, vals, mp)
    assert _same(idx, ridx) and _same(found, rfound)
    assert _same(idx, idx2) and _same(found, found2)
    if n >= 1_000 and max_probes is None:
        assert bool(found.any()) and not bool(found.all())


def test_wide_aggregate_matches_torch_cpu(dev):
    """A keyed Aggregate with 40 sum outputs (above the 32 value columns of
    one grouped-sum launch) on torch: two radix-groupby launches, keys and
    integer sums identical to torch_cpu, float sums within oracle_rtol."""
    from repro_torch.core import resolve_backend
    from repro_torch.core.graph import Dataflow
    from repro_torch.etl.components import Aggregate, ArraySource, CollectSink
    n, outs = 50_000, 40
    cols = {"k1": RNG.integers(1992, 1999, n), "k2": RNG.integers(0, 21, n)}
    for i in range(outs):
        cols[f"v{i}"] = (RNG.integers(0, 1000, n) if i % 2
                         else RNG.random(n) * 1e3)
    got = {}
    for backend in ("torch", "torch_cpu"):
        flow = Dataflow("wide-aggregate")
        sink = CollectSink("sink")
        flow.chain(ArraySource("rows", cols),
                   Aggregate("sums", ["k1", "k2"],
                             {f"s{i}": (f"v{i}", "sum")
                              for i in range(outs)}), sink)
        reset_launches()
        OptimizedEngine(flow, OptimizeOptions(backend=backend,
                                              num_splits=4)).run()
        got[backend] = (sink.result(), launch_counts()["radix_groupby"])
    (res, launches), (want, cpu_launches) = got["torch"], got["torch_cpu"]
    assert launches == 2 and cpu_launches == 0
    assert list(res) == list(want)
    rtol = resolve_backend("torch").oracle_rtol
    for k, w in want.items():
        assert res[k].dtype == w.dtype and res[k].shape == w.shape
        if k in ("k1", "k2") or int(k[1:]) % 2:
            np.testing.assert_array_equal(res[k], w)
        else:
            np.testing.assert_allclose(res[k], w, rtol=rtol, atol=0)


@pytest.mark.parametrize("op,c", [("groupby", 40), ("groupby", 65),
                                  ("segsum", 33), ("segsum", 70)])
def test_grouped_sums_take_any_column_count(dev, op, c):
    """More than 32 value columns: one launch a batch of 32, counts once;
    integer sums and counts byte-identical to the plain version, two calls
    bit-identical on fractions."""
    n, g = 40_000, 147
    ids = torch.from_numpy(RNG.integers(-1, g + 1, n).astype(np.int32)
                           ).to(dev)
    exact = torch.from_numpy(RNG.integers(0, 64, (n, c)).astype(np.float32)
                             ).to(dev)
    frac = torch.from_numpy(RNG.random((n, c)).astype(np.float32)).to(dev)
    kernel, plain = ((radix_groupby, radix_groupby_ref) if op == "groupby"
                     else (segment_sum, segment_sum_ref))
    name = "radix_groupby" if op == "groupby" else "segment_sum"

    def run(vals):
        out = kernel(ids, vals, g)
        return out if op == "groupby" else (out,)
    reset_launches()
    got = run(exact)
    assert launch_counts()[name] == -(-c // 32)
    want = plain(ids, exact, g)
    for x, w in zip(got, want if op == "groupby" else (want,)):
        assert _same(x, w)
    for x, y in zip(run(frac), run(frac)):
        assert _same(x, y)


# 3.5M and 4M groups exceed the 12288 x 256 ids whose block counters fit
# shared memory, so those cases run the global-memory counters
@pytest.mark.parametrize("n,c,g", [(100_000, 1, 147), (50_000, 3, 70_000),
                                   (1_000, 0, 16), (10, 2, 5_000),
                                   (4_000_000, 1, 3_500_000)])
def test_radix_groupby_kernel_matches_plain(dev, n, c, g):
    ids = torch.from_numpy(RNG.integers(-1, g, n).astype(np.int32)).to(dev)
    vals = torch.from_numpy(RNG.integers(0, 64, (n, c)).astype(np.float32)
                            ).to(dev)
    sums, counts = radix_groupby(ids, vals, g)
    sums2, counts2 = radix_groupby(ids, vals, g)
    rs, rc = radix_groupby_ref(ids, vals, g)
    assert _same(sums, rs) and _same(counts, rc)
    assert _same(sums, sums2) and _same(counts, counts2)


@pytest.mark.parametrize("n,c,g", [(112_000, 1, 1), (300_000, 2, 4_096),
                                   (5, 1, 3), (4_000_000, 1, 4_000_000)])
def test_segment_sum_kernel_matches_plain(dev, n, c, g):
    ids = torch.from_numpy(RNG.integers(-1, g, n).astype(np.int32)).to(dev)
    vals = torch.from_numpy(RNG.integers(0, 100, (n, c)).astype(np.float32)
                            ).to(dev)
    out = segment_sum(ids, vals, g)
    assert _same(out, segment_sum_ref(ids, vals, g))
    assert _same(out, segment_sum(ids, vals, g))


# Both routes of the grouped sums (kernels/_grouped_sum.py): at the direct
# route's limit and one group above it, C = 0 and C = 32, all rows padding
# (ids -1 and >= n_groups), and fewer rows than one block's range.  Integer
# values: byte-identical to the plain version; fractional values: a second
# launch bit-identical to the first.
@pytest.mark.parametrize("op,n,c,g,pad,direct", [
    ("groupby", 5_000, 1, 768, 0.1, True),        # at the limit
    ("groupby", 5_000, 1, 769, 0.1, False),       # one group above
    ("segsum", 5_000, 1, 1_536, 0.1, True),
    ("segsum", 5_000, 1, 1_537, 0.1, False),
    ("groupby", 20_000, 0, 1_536, 0.1, True),     # counts only
    ("groupby", 20_000, 0, 1_537, 0.1, False),
    ("groupby", 30_000, 32, 46, 0.1, True),       # 32 columns + counts
    ("groupby", 30_000, 32, 47, 0.1, False),
    ("segsum", 30_000, 32, 48, 0.1, True),
    ("segsum", 30_000, 32, 49, 0.1, False),
    ("groupby", 96_000, 1, 147, 1.0, True),       # all rows padding
    ("segsum", 112_000, 1, 1, 1.0, True),
    ("groupby", 70_000, 2, 5_000, 1.0, False),
    ("groupby", 100, 2, 10, 0.1, True),           # under one block's rows
    ("segsum", 100, 1, 1, 0.0, True),
    ("segsum", 700_000, 3, 40, 0.05, True),       # 264 blocks, long ranges
])
def test_grouped_sum_routes_match_plain(dev, op, n, c, g, pad, direct):
    from repro_torch.kernels import _grouped_sum as gs
    p = gs.plan(n, g, c, op == "groupby")
    assert p.direct == direct
    ids = RNG.integers(0, g, n).astype(np.int32)
    drop = RNG.random(n) < pad
    ids[drop] = np.where(RNG.random(int(drop.sum())) < 0.5, -1,
                         g + RNG.integers(0, 3, int(drop.sum())))
    ids = torch.from_numpy(ids).to(dev)
    exact = torch.from_numpy(RNG.integers(0, 64, (n, c)).astype(np.float32)
                             ).to(dev)
    frac = torch.from_numpy(RNG.random((n, c)).astype(np.float32)).to(dev)
    kernel, plain = ((radix_groupby, radix_groupby_ref) if op == "groupby"
                     else (segment_sum, segment_sum_ref))
    name = "radix_groupby" if op == "groupby" else "segment_sum"

    def run(vals):
        out = kernel(ids, vals, g)
        return out if op == "groupby" else (out,)
    reset_launches()
    got, again = run(exact), run(exact)
    assert launch_counts()[name] == 2
    want = plain(ids, exact, g)
    want = want if op == "groupby" else (want,)
    for x, y, w in zip(got, again, want):
        assert _same(x, w) and _same(x, y)
    for x, y in zip(run(frac), run(frac)):
        assert _same(x, y)


def test_grouped_sum_on_two_streams(dev):
    """Each stream has its own direct-route scratch: calls queued on the
    default stream and on a side stream together give the same sums."""
    n, g = 96_000, 147
    ids = torch.from_numpy(RNG.integers(-1, g, n).astype(np.int32)).to(dev)
    vals = torch.from_numpy(RNG.random((n, 1)).astype(np.float32)).to(dev)
    want = radix_groupby(ids, vals, g)
    side = torch.cuda.Stream(dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    outs = []
    for _ in range(4):
        outs.append(radix_groupby(ids, vals, g))
        with torch.cuda.stream(side):
            outs.append(radix_groupby(ids, vals, g))
    torch.cuda.synchronize(dev)
    for sums, counts in outs:
        assert _same(sums, want[0]) and _same(counts, want[1])


def test_sort_route_groupby_over_4m_keys(dev, monkeypatch):
    """A keyed sum over 4M distinct keys on the sort route: the torch
    backend (segment-sum kernel) against torch_cpu, exact on integer
    values."""
    from repro_torch.core import resolve_backend
    monkeypatch.setenv("REPRO_GROUPBY_IMPL", "sort")
    n = 4_000_000
    keys = RNG.permutation(n).astype(np.int64) * 3 - 5_000_000
    vals = RNG.integers(0, 1_000, n).astype(np.int64)
    out = {}
    for name in ("torch", "torch_cpu"):
        bk = resolve_backend(name)
        reset_launches()
        cols, aggs = bk.groupby_reduce([keys], {"s": (vals, "sum"),
                                                "c": (vals, "count")}, n)
        out[name] = ([bk.to_host(k) for k in cols], bk.to_host(aggs["s"]),
                     np.asarray(aggs["c"]), launch_counts()["segment_sum"])
    (gk, gs, gc, launches), (wk, ws, wc, cpu_launches) = (out["torch"],
                                                         out["torch_cpu"])
    assert launches == 1 and cpu_launches == 0
    np.testing.assert_array_equal(gk[0], wk[0])
    np.testing.assert_array_equal(gc, wc)
    assert gs.dtype == ws.dtype and np.array_equal(gs, ws)


@pytest.mark.parametrize("qname", ["Q4.1", "Q1.1"])
def test_torch_backend_matches_torch_cpu(dev, qname):
    data = ssb.generate(lineorder_rows=60_000, customers=2_000,
                        suppliers=300, parts=1_500, seed=7)
    results = {}
    for backend in ("torch", "torch_cpu"):
        q = queries.BUILDERS[qname](data)
        reset_launches()
        run = OptimizedEngine(q.flow, OptimizeOptions(
            backend=backend, fuse_segments=True, num_splits=4)).run()
        results[backend] = (q.sink.result(), run, launch_counts())
    (got, run, counts), (want, cpu_run, cpu_counts) = (results["torch"],
                                                       results["torch_cpu"])
    assert counts["hash_probe"] > 0 and cpu_counts["hash_probe"] == 0
    for name in ("h2d_transfers", "d2h_transfers", "dispatch_calls"):
        assert getattr(run, name) == getattr(cpu_run, name)
    for col, w in want.items():
        if w.dtype.kind == "f":
            np.testing.assert_allclose(got[col], w, rtol=1e-5)
        else:
            np.testing.assert_array_equal(got[col], w)


def _served_q41_flow(data, sort=False):
    """SSB Q4.1 through ``repro_torch.flow`` (the declarative example's
    flow).  Without its sort it ends in the Aggregate and its source holds
    only the schema, as serving needs; with it, the source holds the whole
    lineorder table for a batch run."""
    import repro_torch
    from repro_torch.etl import DimTable
    from repro_torch.etl.ssb import mfgr_id, region_id
    col = repro_torch.col
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
    b = (repro_torch.flow("q4.1-served")
         .source(data.lineorder if sort else
                 {c: a[:0] for c, a in data.lineorder.items()},
                 name="lineorder")
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


def test_served_q41_matches_torch_cpu(dev):
    """Q4.1 served in 6 ticks and an empty one, fused, on torch against
    torch_cpu tick by tick: keys byte-identical, profit within 1e-5; each
    tick probes 4 x chunks times and reduces with one radix-groupby launch
    (none on the empty tick); warm ticks compile and upload nothing."""
    import repro_torch
    data = ssb.generate(lineorder_rows=200_000, customers=3_000,
                        suppliers=200, parts=2_000, seed=9)
    n = len(data.lineorder["lo_orderkey"])
    batches = [{c: a[idx] for c, a in data.lineorder.items()}
               for idx in np.array_split(np.arange(n), 6)]
    batches.insert(3, {c: a[:0] for c, a in data.lineorder.items()})
    ticks = {}
    for backend in ("torch", "torch_cpu"):
        session = repro_torch.Session(backend=backend, metadata=None)
        out = []
        with session.serve(_served_q41_flow(data), fuse=True,
                           num_splits=4) as srv:
            for b in batches:
                reset_launches()
                t = srv.tick(b)
                torch.cuda.synchronize()
                out.append((t, launch_counts()))
            chunk = srv.engine.runtime_plan.chunk_rows
        ticks[backend] = out
    for (t, counts), (w, cpu_counts) in zip(ticks["torch"],
                                            ticks["torch_cpu"]):
        assert not (t.retries or t.dead_lettered)
        assert list(t.delta) == list(w.delta)
        for k, v in w.delta.items():
            assert t.delta[k].dtype == v.dtype, k
            if v.dtype.kind == "f":
                np.testing.assert_allclose(t.delta[k], v, rtol=1e-5)
            else:
                assert t.delta[k].tobytes() == v.tobytes(), k
        chunks = -(-t.rows_in // chunk)
        assert counts["hash_probe"] == 4 * chunks, t.tick
        assert counts["radix_groupby"] == (1 if t.rows_in else 0), t.tick
        assert cpu_counts["hash_probe"] == cpu_counts["radix_groupby"] == 0
        if t.tick > 0:
            assert t.cache_stats["segment_compiles"] == 0, t.tick
            assert t.cache_stats["dim_h2d_transfers"] == 0, t.tick
        for name in ("h2d_transfers", "d2h_transfers", "segment_compiles",
                     "dim_h2d_transfers"):
            assert t.cache_stats[name] == w.cache_stats[name], (t.tick, name)
    assert ticks["torch"][3][0].rows_out == 0
    served = repro_torch.replay_deltas([t for t, _ in ticks["torch"]],
                                       group_by=["d_year", "c_nation"])
    batch = repro_torch.Session(backend="torch", metadata=None).run(
        _served_q41_flow(data, sort=True), engine="streaming", fuse=True,
        num_splits=4).table
    for k in ("d_year", "c_nation"):
        assert served[k].tobytes() == batch[k].tobytes(), k
    np.testing.assert_allclose(served["profit"], batch["profit"], rtol=1e-3)


@pytest.mark.parametrize("qname", ["Q4.1", "Q1.1"])
def test_kettle_on_torch_matches_torch_cpu(dev, qname):
    """The Kettle baseline through Session.run on the card equals the same
    run on torch_cpu: keys byte-identical, sums within 1e-5, the same copy
    and transfer counters."""
    import repro_torch
    data = ssb.generate(lineorder_rows=60_000, customers=2_000,
                        suppliers=300, parts=1_500, seed=7)
    res = {}
    for backend in ("torch", "torch_cpu"):
        res[backend] = repro_torch.Session(backend=backend).run(
            queries.BUILDERS[qname](data), engine="kettle")
    got, want = res["torch"], res["torch_cpu"]
    assert got.run.engine == "kettle"
    for name in ("copies", "h2d_transfers", "d2h_transfers",
                 "dispatch_calls"):
        assert getattr(got.run, name) == getattr(want.run, name), name
    assert list(got.table) == list(want.table)
    for col, w in want.table.items():
        assert got.table[col].dtype == w.dtype, col
        if w.dtype.kind == "f":
            np.testing.assert_allclose(got.table[col], w, rtol=1e-5)
        else:
            np.testing.assert_array_equal(got.table[col], w)


@pytest.mark.parametrize("qname", ["Q4.1", "Q1.1"])
@pytest.mark.parametrize("route", ["mesh", "inline"])
def test_sharded_on_torch_matches_torch_cpu(dev, qname, route):
    """A 4-shard run through Session.run on the card against the same run
    on torch_cpu: keys, order and dtypes identical, sums within 1e-5, the
    same transfer and dispatch counters; the mesh route's merge launches
    the segment-sum kernel, and a repeated run on the card is
    bit-identical."""
    import repro_torch
    data = ssb.generate(lineorder_rows=60_000, customers=2_000,
                        suppliers=300, parts=1_500, seed=7)
    res = {}
    for backend in ("torch", "torch", "torch_cpu"):
        reset_launches()
        got = repro_torch.Session(backend=backend, metadata=None).run(
            queries.BUILDERS[qname](data), fuse=True, num_splits=4, shards=4,
            shard_impl=route)
        torch.cuda.synchronize()
        res.setdefault(backend, []).append((got, launch_counts()))
    (a, counts), (b, _) = res["torch"]
    want, cpu_counts = res["torch_cpu"][0]
    assert a.run.shard.impl == route and a.run.degradations == 0
    assert counts["hash_probe"] > 0 and cpu_counts["hash_probe"] == 0
    if route == "mesh":
        # the combiner's float sums, plus Q1.1's four global partials
        assert counts["segment_sum"] == (1 if qname == "Q4.1" else 5)
    for name in ("h2d_transfers", "d2h_transfers", "dispatch_calls"):
        assert getattr(a.run, name) == getattr(want.run, name), name
    assert list(a.table) == list(want.table)
    for col, w in want.table.items():
        assert a.table[col].tobytes() == b.table[col].tobytes(), col
        assert a.table[col].dtype == w.dtype, col
        if w.dtype.kind == "f":
            np.testing.assert_allclose(a.table[col], w, rtol=1e-5)
        else:
            np.testing.assert_array_equal(a.table[col], w)


# ------------------------------------------------------- LM-path kernels
# Flash attention: the kernel against the plain version on the same card
# tensors.  fp32 (the FMA kernel) within rtol 2e-4 / atol 2e-5 (both sum the
# softmax in fp32, in other orders); bf16 (the tensor-core kernel) within
# 2e-2 (the output is rounded to bf16 and the probabilities to bf16 before
# the value product, at other points of the online softmax).  The bf16
# cases cross the tensor-core kernel's edges: 128-row q tiles (64 a
# warpgroup) and 64-row kv tiles (32 at hd 256), lengths that are not
# multiples of them, a window that cuts a tile, rows with no allowed key,
# Sq != Skv with causality, G > 1, and hd 8 (zero-padded to 16) through 256.
@pytest.mark.parametrize("B,Sq,Skv,Kh,G,hd,causal,window,softcap,dtype", [
    (1, 64, 64, 1, 1, 32, True, 0, 0.0, "float32"),
    (2, 128, 128, 2, 2, 64, True, 0, 0.0, "float32"),
    (2, 128, 128, 2, 2, 64, False, 0, 0.0, "float32"),
    (1, 96, 96, 2, 4, 32, True, 24, 0.0, "float32"),
    (1, 64, 64, 4, 1, 64, True, 0, 30.0, "float32"),
    (2, 80, 80, 1, 8, 16, True, 0, 0.0, "float32"),
    (1, 33, 57, 1, 2, 8, False, 0, 0.0, "float32"),
    (1, 100, 20, 1, 2, 16, False, 10, 0.0, "float32"),   # rows fully masked
    (2, 300, 300, 2, 4, 128, True, 100, 30.0, "bfloat16"),
    (1, 77, 213, 1, 2, 256, False, 0, 0.0, "bfloat16"),
    (2, 257, 257, 4, 1, 80, True, 0, 0.0, "bfloat16"),
    (1, 190, 190, 2, 1, 96, True, 0, 0.0, "float32"),
    (1, 100, 150, 2, 1, 64, False, 0, 0.0, "bfloat16"),
    (1, 200, 200, 2, 1, 128, True, 50, 0.0, "bfloat16"),  # window cuts tiles
    (1, 100, 20, 1, 2, 16, False, 10, 0.0, "bfloat16"),   # rows fully masked
    (1, 33, 57, 1, 2, 8, False, 0, 0.0, "bfloat16"),
    (2, 80, 80, 1, 8, 16, True, 0, 0.0, "bfloat16"),
    (1, 130, 130, 1, 2, 256, True, 0, 0.0, "bfloat16"),
    (1, 70, 200, 2, 2, 32, True, 0, 0.0, "bfloat16"),
    (1, 200, 70, 1, 1, 96, True, 0, 0.0, "bfloat16"),
    (2, 190, 190, 2, 3, 80, True, 64, 10.0, "bfloat16"),
    # fp32 at every head dim, crossing its tile edges (128 query rows, 64
    # keys; 256 / 32 at hd 8; 128 / 32 at hd 128; 64 / 32 at hd 256)
    (2, 257, 257, 4, 1, 80, True, 0, 0.0, "float32"),
    (2, 190, 190, 2, 3, 80, True, 64, 10.0, "float32"),
    (2, 300, 300, 2, 4, 128, True, 100, 30.0, "float32"),
    (1, 200, 200, 2, 1, 128, True, 50, 0.0, "float32"),
    (1, 77, 213, 1, 2, 256, False, 0, 0.0, "float32"),
    (1, 130, 130, 1, 2, 256, True, 0, 0.0, "float32"),
    (1, 100, 20, 1, 2, 8, False, 10, 0.0, "float32"),     # rows fully masked
    (1, 300, 300, 1, 2, 8, True, 0, 5.0, "float32"),
    (1, 70, 200, 2, 2, 32, True, 0, 0.0, "float32"),
    (1, 200, 70, 1, 1, 96, True, 0, 0.0, "float32"),
    (1, 100, 150, 2, 1, 64, False, 0, 0.0, "float32"),
])
def test_flash_attention_kernel_matches_plain(dev, B, Sq, Skv, Kh, G, hd,
                                              causal, window, softcap,
                                              dtype):
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_ref)
    dt = getattr(torch, dtype)
    q = torch.from_numpy(RNG.normal(size=(B, Sq, Kh, G, hd))).to(dev, dt)
    k = torch.from_numpy(RNG.normal(size=(B, Skv, Kh, hd))).to(dev, dt)
    v = torch.from_numpy(RNG.normal(size=(B, Skv, Kh, hd))).to(dev, dt)
    kw = dict(causal=causal, window=window, softcap=softcap)
    reset_launches()
    got = flash_attention(q, k, v, **kw)
    # either kernel (fp32 FMAs, bf16 tensor cores) counts one launch a call
    assert launch_counts()["flash_attention"] == 1
    again = flash_attention(q, k, v, **kw)
    assert launch_counts()["flash_attention"] == 2
    want = flash_attention_ref(q, k, v, **kw)
    assert got.dtype == dt and _same(got, again)
    tol = (2e-4, 2e-5) if dtype == "float32" else (2e-2, 2e-2)
    torch.testing.assert_close(got.float(), want.float(), rtol=tol[0],
                               atol=tol[1])


# Selective scan: delta and x in float32 or bfloat16 (the kernel widens
# them exactly; the plain version widens first), the rest float32; within
# rtol 1e-4 / atol 1e-4 of the plain version (the kernel fuses multiply-adds,
# takes exp as ex2 of a prescaled A and sums the N states in its own order).
def _scan_args(dev, Bt, T, d, N, dtype="float32", zero_h0=False):
    delta = np.abs(RNG.normal(size=(Bt, T, d))).clip(0.01, 1.0)
    h0 = (np.zeros((Bt, d, N)) if zero_h0
          else RNG.normal(size=(Bt, d, N)))
    args = [torch.from_numpy(a).to(dev, torch.float32) for a in (
        delta, RNG.normal(size=(Bt, T, d)), RNG.normal(size=(Bt, T, N)),
        RNG.normal(size=(Bt, T, N)), -np.abs(RNG.normal(size=(d, N))) - 0.05,
        h0)]
    args[0], args[1] = (a.to(getattr(torch, dtype)) for a in args[:2])
    return args


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("Bt,T,d,N", [(1, 16, 8, 4), (2, 48, 24, 8),
                                      (2, 100, 32, 16), (1, 64, 48, 16),
                                      (3, 333, 1000, 16), (2, 70, 130, 5),
                                      (1, 40, 64, 32)])
def test_mamba_scan_kernel_matches_plain(dev, Bt, T, d, N, dtype):
    from repro_torch.kernels.mamba_scan import mamba_scan, mamba_scan_ref
    args = _scan_args(dev, Bt, T, d, N, dtype)
    reset_launches()
    y, hT = mamba_scan(*args)
    y2, hT2 = mamba_scan(*args)
    assert launch_counts()["mamba_scan"] == 2
    assert _same(y, y2) and _same(hT, hT2)
    y_ref, hT_ref = mamba_scan_ref(*args)
    torch.testing.assert_close(y, y_ref, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(hT, hT_ref, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mamba_scan_kernel_continuation(dev, dtype):
    """Two halves with hT -> h0 give the full scan, bit for bit."""
    from repro_torch.kernels.mamba_scan import mamba_scan
    Bt, T, d, N = 2, 200, 96, 16
    dl, x, Bm, Cm, A, h0 = _scan_args(dev, Bt, T, d, N, dtype, zero_h0=True)
    y, hT = mamba_scan(dl, x, Bm, Cm, A, h0)
    h = slice(0, 77), slice(77, T)
    y1, h1 = mamba_scan(*(t[:, h[0]].contiguous() for t in (dl, x, Bm, Cm)),
                        A, h0)
    y2, h2 = mamba_scan(*(t[:, h[1]].contiguous() for t in (dl, x, Bm, Cm)),
                        A, h1)
    assert _same(torch.cat([y1, y2], 1), y) and _same(h2, hT)


@pytest.mark.parametrize("Bt,T,d,N,offset", [
    (4, 300, 512, 16, 0),          # 16-byte copies
    (2, 70, 130, 5, 0),            # 4-byte copies, padded states
    (2, 45, 131, 8, 0),            # odd d: bf16 rows at odd offsets
    (1, 33, 64, 16, 1)])           # inputs one element off alignment
def test_mamba_scan_bf16_kernel_equals_widened(dev, Bt, T, d, N, offset):
    """bf16 delta and x give, bit for bit, the kernel's result on
    ``delta.float()`` and ``x.float()``."""
    from repro_torch.kernels.mamba_scan import mamba_scan
    dl, x, Bm, Cm, A, h0 = _scan_args(dev, Bt, T, d, N, "bfloat16")

    def shifted(t):
        flat = torch.empty(t.numel() + offset, dtype=t.dtype, device=dev)
        out = flat[offset:].view(t.shape)
        out.copy_(t)
        return out
    dl, x = shifted(dl), shifted(x)
    y, hT = mamba_scan(dl, x, Bm, Cm, A, h0)
    y_w, hT_w = mamba_scan(dl.float(), x.float(), Bm, Cm, A, h0)
    assert _same(y, y_w) and _same(hT, hT_w)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mamba_scan_lane_splits_agree(dev, dtype):
    """1, 2 or 4 lanes a channel: the same state bits (each state's steps
    are the same), y within the tolerance (the states' sum in another
    tree)."""
    from repro_torch.kernels.mamba_scan import mamba_scan_ref
    from repro_torch.kernels.mamba_scan.ops import (default_lanes,
                                                    mamba_scan_cuda)
    args = _scan_args(dev, 2, 90, 200, 16, dtype)
    y_ref, _ = mamba_scan_ref(*args)
    runs = {lanes: mamba_scan_cuda(*args, lanes=lanes) for lanes in (1, 2, 4)}
    for y, hT in runs.values():
        assert _same(hT, runs[1][1])
        torch.testing.assert_close(y, y_ref, rtol=1e-4, atol=1e-4)
    assert _same(runs[default_lanes(2, 200)][0], mamba_scan_cuda(*args)[0])


def test_lm_kernels_refuse_what_they_do_not_take(dev):
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.mamba_scan import mamba_scan
    q = torch.zeros((1, 4, 1, 1, 24), device=dev)
    with pytest.raises(ValueError, match="head dim"):
        flash_attention(q, q[:, :, :, 0], q[:, :, :, 0].contiguous())
    # the bf16 kernel copies 16-byte pieces
    flat = torch.zeros(4 * 16 + 1, dtype=torch.bfloat16, device=dev)
    qb = flat[1:].view(1, 4, 1, 1, 16)
    kb = torch.zeros((1, 4, 1, 16), dtype=torch.bfloat16, device=dev)
    with pytest.raises(ValueError, match="16-byte"):
        flash_attention(qb, kb, kb)
    # so does the fp32 kernel
    flat = torch.zeros(4 * 16 + 1, device=dev)
    qf = flat[1:].view(1, 4, 1, 1, 16)
    kf = torch.zeros((1, 4, 1, 16), device=dev)
    with pytest.raises(ValueError, match="16-byte"):
        flash_attention(qf, kf, kf)
    z = torch.zeros((1, 4, 8), device=dev)
    s = torch.zeros((1, 4, 33), device=dev)
    with pytest.raises(ValueError, match="state size"):
        mamba_scan(z, z, s, s, torch.zeros((8, 33), device=dev),
                   torch.zeros((1, 8, 33), device=dev))
    s = torch.zeros((1, 4, 16), device=dev)
    A, h0 = torch.zeros((8, 16), device=dev), torch.zeros((1, 8, 16),
                                                          device=dev)
    with pytest.raises(TypeError, match="bfloat16"):      # mixed dtypes
        mamba_scan(z, z.bfloat16(), s, s, A, h0)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        mamba_scan(z.half(), z.half(), s, s, A, h0)
    with pytest.raises(TypeError, match="float32"):       # B stays fp32
        mamba_scan(z.bfloat16(), z.bfloat16(), s.bfloat16(), s, A, h0)
    from repro_torch.kernels.mamba_scan.ops import mamba_scan_cuda
    with pytest.raises(ValueError, match="lanes"):
        mamba_scan_cuda(z, z, s, s, A, h0, lanes=3)
