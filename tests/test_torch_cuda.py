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


# 3.5M and 4M groups: the partitioned route over 1,709 and 977 partitions
# (of 2,048 and 4,096 ids)
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


# The routes of the grouped sums (kernels/_grouped_sum.py): at the narrow
# direct route's limit and one group above it (the wide route), at the wide
# route's limit and one group above it (partitioned), the hash-mode
# supplier flow's shard and combiner, C = 0 and C = 32, all rows padding
# (ids -1 and >= n_groups), and fewer rows than one block's range.  The
# partitioned route (two launches) also past the partitions whose counters
# fit shared memory (12,500 partitions of 128 ids at 33 columns), over the
# sort route's 4M ascending ids, in slices (218 ids x 33 columns at 2M rows:
# 7 partitions in 38 slices), with counts alone, with one id holding half
# the rows and with fewer rows than a block's range.  Integer values:
# byte-identical to the plain version; fractional values: a second launch
# bit-identical to the first.
@pytest.mark.parametrize("op,n,c,g,pad,direct,layout", [
    ("groupby", 5_000, 1, 768, 0.1, True, "random"),   # at the narrow limit
    ("groupby", 5_000, 1, 769, 0.1, True, "random"),   # one above: wide
    ("segsum", 5_000, 1, 1_536, 0.1, True, "random"),
    ("segsum", 5_000, 1, 1_537, 0.1, True, "random"),
    ("groupby", 20_000, 0, 1_536, 0.1, True, "random"),  # counts only
    ("groupby", 20_000, 0, 1_537, 0.1, True, "random"),
    ("groupby", 30_000, 32, 46, 0.1, True, "random"),  # 32 columns + counts
    ("groupby", 30_000, 32, 47, 0.1, True, "random"),
    ("segsum", 30_000, 32, 48, 0.1, True, "random"),
    ("segsum", 30_000, 32, 49, 0.1, True, "random"),
    ("groupby", 400_000, 1, 3_584, 0.1, True, "random"),   # the wide limit
    ("groupby", 400_000, 1, 3_585, 0.1, False, "random"),  # partitioned
    ("segsum", 400_000, 1, 7_168, 0.1, True, "random"),
    ("segsum", 400_000, 1, 7_169, 0.1, False, "random"),
    ("groupby", 60_000, 32, 217, 0.1, True, "random"),  # 32 cols, wide limit
    ("groupby", 60_000, 32, 218, 0.1, False, "random"),
    ("groupby", 1_500_000, 1, 2_000, 0.0, True, "random"),  # supplier shard
    ("segsum", 2_000, 1, 2_000, 0.0, True, "random"),  # supplier combiner
    ("groupby", 96_000, 1, 147, 1.0, True, "random"),  # all rows padding
    ("segsum", 112_000, 1, 1, 1.0, True, "random"),
    ("groupby", 70_000, 2, 5_000, 1.0, False, "random"),
    ("groupby", 100, 2, 10, 0.1, True, "random"),   # under one block's rows
    ("segsum", 100, 1, 1, 0.0, True, "random"),
    ("segsum", 700_000, 3, 40, 0.05, True, "random"),  # 264 blocks, long
    ("groupby", 1_000_000, 32, 1_600_000, 0.1, False, "random"),  # global
    ("segsum", 4_000_000, 1, 4_000_000, 0.0, False, "ascending"),  # sort
    ("groupby", 2_000_000, 32, 218, 0.0, False, "random"),  # in slices
    ("groupby", 500_000, 0, 20_000, 0.1, False, "random"),  # counts only
    ("groupby", 1_000_000, 1, 50_000, 0.0, False, "skew"),  # a hot id
    ("groupby", 1_000, 1, 10_000, 0.1, False, "random"),  # under a block
])
def test_grouped_sum_routes_match_plain(dev, op, n, c, g, pad, direct,
                                        layout):
    from repro_torch.kernels import _grouped_sum as gs
    name = "radix_groupby" if op == "groupby" else "segment_sum"
    counts = op == "groupby"
    wide = gs.is_wide(g, c, counts)
    cap = (gs.wide_blocks(name, dev.index or 0, c, counts, g) if wide
           else 0)
    p = gs.plan(n, g, c, counts, cap)
    assert p.direct == direct and p.wide == wide
    assert p.launches == (1 if direct else 2)
    if wide:
        assert p.n_blocks <= cap
    if layout == "ascending":
        ids = (np.arange(n, dtype=np.int64) * g // n).astype(np.int32)
    else:
        ids = RNG.integers(0, g, n).astype(np.int32)
    if layout == "skew":
        ids[RNG.random(n) < 0.5] = g // 3
    drop = RNG.random(n) < pad
    ids[drop] = np.where(RNG.random(int(drop.sum())) < 0.5, -1,
                         g + RNG.integers(0, 3, int(drop.sum())))
    ids = torch.from_numpy(ids).to(dev)
    exact = torch.from_numpy(RNG.integers(0, 64, (n, c)).astype(np.float32)
                             ).to(dev)
    frac = torch.from_numpy(RNG.random((n, c)).astype(np.float32)).to(dev)
    kernel, plain = ((radix_groupby, radix_groupby_ref) if op == "groupby"
                     else (segment_sum, segment_sum_ref))

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


# ------------------------------------------------------- kernel failures
# The card has no degradation ladder: a kernel that fails on CUDA tensors
# aborts the run with its error and records no step.  Each test runs on a
# fresh ``torch`` backend; after the abort, the same backend runs Q4.1 again
# and matches torch_cpu, so the abort left no route behind.
LAUNCH_ERROR = "CUDA error 7 (too many resources requested for launch)"


@pytest.fixture
def fresh_torch():
    """A fresh ``torch`` backend for the test, dropped afterwards and the
    old one put back."""
    from repro_torch.core.backend import base as registry
    saved = registry._instances.pop("torch", None)
    yield
    registry._instances.pop("torch", None)
    if saved is not None:
        registry._instances["torch"] = saved


def _install_failure(m, failure):
    """Make ``failure`` happen through ``m`` (a monkeypatch context); returns
    the error type the run must abort with."""
    from repro_torch.core.backend.torch_backend import TorchBackend
    from repro_torch.kernels import KernelLibraryError, _cuda
    from repro_torch.kernels.hash_join import ops as probe_ops
    from repro_torch.kernels.radix_groupby import ops as groupby_ops
    if failure in ("probe", "groupby"):
        module, entry = ((probe_ops, "hash_probe_cuda") if failure == "probe"
                         else (groupby_ops, "radix_groupby_cuda"))
        real, failed = getattr(module, entry), []

        def fails_once(*args, **kwargs):
            if not failed:
                failed.append(1)
                raise RuntimeError(f"{entry}: {LAUNCH_ERROR}")
            return real(*args, **kwargs)
        m.setattr(module, entry, fails_once)
        return RuntimeError
    if failure == "segment":
        def broken(self, segment):
            def runner(cache):
                raise RuntimeError(f"segment: {LAUNCH_ERROR}")
            return runner
        m.setattr(TorchBackend, "compile_segment", broken)
        return RuntimeError

    def no_library():
        raise KernelLibraryError("the CUDA kernel library could not be "
                                 "built or loaded")
    m.setattr(_cuda, "library", no_library)
    return KernelLibraryError


@pytest.mark.parametrize("failure", ["probe", "groupby", "segment",
                                     "library"])
def test_degrade_never_on_the_card(dev, fresh_torch, monkeypatch, failure):
    """A probe and a radix groupby whose CUDA entry fails once, a fused
    segment whose runner fails outside the probe, and a kernel library that
    cannot load: each run aborts with its error and records no step, the
    backend keeps no route, and a rerun on it matches torch_cpu."""
    import repro_torch
    from repro_torch.core import faults, resolve_backend
    data = ssb.generate(lineorder_rows=20_000, customers=600, suppliers=60,
                        parts=800, seed=5)

    def run(backend):
        return repro_torch.Session(backend=backend, metadata=None).run(
            queries.build_q4(data), fuse=True, num_splits=4)
    with monkeypatch.context() as m:
        expected = _install_failure(m, failure)
        with faults.fault_recorder() as rec:
            with pytest.raises(expected):
                run("torch")
    assert rec.degradations == []
    bk = resolve_backend("torch")
    assert bk._join_route is None and bk._groupby_route is None
    got, want = run("torch"), run("torch_cpu")
    assert got.run.degradations == 0
    assert list(got.table) == list(want.table)
    for col, w in want.table.items():
        assert got.table[col].dtype == w.dtype, col
        if w.dtype.kind == "f":
            np.testing.assert_allclose(got.table[col], w, rtol=1e-5)
        else:
            np.testing.assert_array_equal(got.table[col], w)


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
    # llama-3.2-vision's cross-attention edge (Skv mod 64 = 1, as 1601 is:
    # the last kv tile holds one key) and hubert's non-causal encoder
    (1, 130, 65, 2, 4, 128, False, 0, 0.0, "bfloat16"),
    (2, 257, 257, 4, 1, 80, False, 0, 0.0, "bfloat16"),
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


# The MoE FFN on the card: plain torch (the reference computes it outside
# any kernel), held against the same block on the CPU in fp32 within rtol
# 1e-4 / atol 1e-4 (matmul sums in other orders), with the router's
# decisions equal.
@pytest.mark.parametrize("kw", [{}, dict(capacity_factor=0.25),
                                dict(mlp_kind="gelu", experts_per_token=1)])
def test_moe_block_on_the_card_matches_torch_cpu(dev, kw, monkeypatch):
    from repro_torch import configs
    from repro_torch.models import moe
    from repro_torch.models.layers import NO_RULES
    cfg = configs.get_config("mixtral-8x7b", smoke=True).replace(
        compute_dtype="float32", **kw)
    d, E, f = cfg.d_model, cfg.n_experts, cfg.d_ff
    rng = np.random.default_rng(8)
    w = {"router": rng.normal(0, d ** -0.5, (d, E)),
         "wg": rng.normal(0, d ** -0.5, (E, d, f)),
         "wu": rng.normal(0, d ** -0.5, (E, d, f)),
         "wd": rng.normal(0, f ** -0.5, (E, f, d))}
    x = rng.normal(size=(2, 37, d))
    routes = []
    real = moe.route

    def spy(*a, **k):
        routes.append(real(*a, **k))
        return routes[-1]

    monkeypatch.setattr(moe, "route", spy)
    runs = []
    for device in ("cpu", dev):
        p = {k: torch.tensor(v, dtype=torch.float32, device=device)
             for k, v in w.items()}
        xt = torch.tensor(x, dtype=torch.float32, device=device)
        runs.append(moe.moe_block(xt, p, cfg, NO_RULES))
    (out_c, aux_c), (out_g, aux_g) = runs
    assert out_g.device.type == dev.type and out_g.shape == out_c.shape
    assert torch.equal(routes[0].topi, routes[1].topi.cpu())
    assert torch.equal(routes[0].keep, routes[1].keep.cpu())
    torch.testing.assert_close(out_g.cpu(), out_c, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(aux_g.cpu(), aux_c, rtol=1e-4, atol=1e-4)


def test_mixtral_smoke_prefill_launches_flash_once_a_layer(dev):
    """A moe model's prefill on the card runs the flash kernel once a layer
    (sliding window, GQA) and agrees with the CPU's plain route in fp32."""
    from repro_torch import configs
    from repro_torch.models import transformer as tf
    cfg = configs.get_config("mixtral-8x7b", smoke=True).replace(
        compute_dtype="float32")
    p = tf.init_params(cfg, seed=0, device="cpu")
    toks = torch.from_numpy(RNG.integers(0, cfg.vocab_size, (2, 40)))
    want, want_cache = tf.forward_prefill(p, {"tokens": toks}, cfg)
    pg = _to_device(p, dev)
    reset_launches()
    got, cache = tf.forward_prefill(pg, {"tokens": toks.to(dev)}, cfg)
    assert launch_counts()["flash_attention"] == cfg.n_layers
    torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(cache["pos0"]["k"].cpu(),
                               want_cache["pos0"]["k"], rtol=1e-4, atol=1e-4)


def test_vlm_smoke_prefill_and_decode_on_the_card_match_torch_cpu(dev):
    """A vlm of 2 layers (self-attention, then a layer with a gated
    cross-attention over 65 vision tokens: the last kv tile holds one key),
    its gate nonzero: the prefill launches flash once for the self- and
    once for the cross-attention, and it and 3 decode steps over the cached
    vision K/V agree with the CPU's plain route in fp32 (rtol 1e-4 / atol
    1e-4)."""
    from repro_torch import configs
    from repro_torch.models import transformer as tf
    cfg = configs.get_config("llama-3.2-vision-11b", smoke=True).replace(
        n_layers=2, cross_attn_period=2, cross_attn_offset=1,
        n_vision_tokens=65, compute_dtype="float32")
    p = tf.init_params(cfg, seed=0, device="cpu")
    p["blocks"]["pos1"]["xattn"]["gate"].fill_(0.8)
    toks = torch.from_numpy(RNG.integers(0, cfg.vocab_size, (2, 43)))
    vis = torch.from_numpy(RNG.normal(size=(2, 65, cfg.d_model))).float()
    pg = _to_device(p, dev)
    runs = []
    for params, device in ((p, "cpu"), (pg, dev)):
        reset_launches()
        lg, cache = tf.forward_prefill(
            params, {"tokens": toks[:, :40].to(device),
                     "vision": vis.to(device)}, cfg)
        assert launch_counts()["flash_attention"] == (
            0 if device == "cpu" else 3)
        xk = cache["pos1"]["xk"].cpu()
        cache = tf.grow_cache(cache, cfg, 43)
        logits = [lg.cpu()]
        for t in range(40, 43):
            lg, cache = tf.decode_step(
                params, cache, {"tokens": toks[:, t:t + 1].to(device)}, cfg)
            logits.append(lg.cpu())
        runs.append((torch.cat(logits, 1), xk))
    (want, want_xk), (got, got_xk) = runs
    assert launch_counts()["flash_attention"] == 3       # none in decode
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(got_xk, want_xk, rtol=1e-4, atol=1e-4)


def test_hubert_smoke_encoder_on_the_card_matches_torch_cpu(dev):
    """The 2-layer audio encoder on stub frames: one non-causal flash launch
    a layer, and the hidden state at every position agrees with the CPU's
    plain route in fp32 (rtol 1e-4 / atol 1e-4)."""
    from repro_torch import configs
    from repro_torch.models import transformer as tf
    cfg = configs.get_config("hubert-xlarge", smoke=True).replace(
        compute_dtype="float32")
    p = tf.init_params(cfg, seed=0, device="cpu")
    frames = torch.from_numpy(RNG.normal(size=(2, 130, cfg.d_model))).float()
    pg = _to_device(p, dev)
    runs = []
    for params, device in ((p, "cpu"), (pg, dev)):
        x = tf._embed(params, {"frames": frames.to(device)}, cfg, tf.NO_RULES)
        pos = torch.arange(130, device=device)
        reset_launches()
        h, _, _ = tf.backbone(params, x, cfg, tf.NO_RULES, "prefill", pos,
                              pos)
        runs.append(h.cpu())
    assert launch_counts()["flash_attention"] == cfg.n_layers
    torch.testing.assert_close(runs[1], runs[0], rtol=1e-4, atol=1e-4)


def _to_device(tree, dev):
    if isinstance(tree, dict):
        return {k: _to_device(v, dev) for k, v in tree.items()}
    return tree.to(dev)


# ---------------------------------------------------------------- backward
# The backward kernels against their plain versions on the same inputs,
# with the forward kernels' own output and log-sum-exp (flash) or carries
# (the scan).  Flash: fp32 within rtol 1e-4 / atol 1e-5 (fp32 sums in
# other orders); bf16 within 2e-2 (the kernel rounds P and dS to bf16 for
# its tensor-core products and each gradient to bf16).  The scan: within
# rtol 1e-4 / atol 1e-4 in fp32 (ex2.approx of a prescaled A, the state
# sums in other orders), dA within rtol 1e-4 and 1e-4 of its largest
# value (it sums Bt * T products larger than most of its elements, so
# either side's fp32 rounding scales with them, as _torch_lm.close_grads
# holds gradient leaves); bf16 delta / x get exactly the rounded
# gradients of the same values widened to fp32.  A second launch is
# bit-identical.  bf16 flash is also held by relative norm on every
# 64-row tile of the sequence (keys for dK and dV, queries for dQ), within
# 1e-2: most dK and dV elements of late keys are far below the 2e-2 atol,
# and the kernel's tiles read at most 2.9e-3 (chip_smoke.py phase 2, whose
# FLASH_BWD_REL_BF16 this is).
FLASH_BWD_CASES = [
    # dtype, B, Sq, Skv, Kh, G, hd, causal, window, softcap
    ("bfloat16", 2, 200, 200, 2, 1, 80, True, 0, 0.0),
    ("bfloat16", 1, 130, 190, 2, 2, 80, True, 0, 0.0),    # Sq < Skv
    ("bfloat16", 1, 190, 70, 1, 4, 80, True, 48, 10.0),   # Sq > Skv
    ("bfloat16", 2, 257, 257, 2, 2, 128, True, 100, 0.0),  # window cuts
    ("bfloat16", 1, 77, 213, 1, 4, 128, False, 0, 30.0),
    ("bfloat16", 2, 150, 150, 1, 1, 128, False, 40, 0.0),
    ("bfloat16", 1, 100, 20, 1, 2, 80, False, 10, 0.0),   # rows masked
    ("bfloat16", 1, 70, 65, 2, 4, 8, False, 0, 0.0),
    ("bfloat16", 1, 96, 96, 1, 2, 16, True, 0, 0.0),
    ("bfloat16", 1, 100, 120, 2, 1, 32, True, 0, 5.0),
    ("bfloat16", 1, 129, 129, 1, 2, 64, True, 0, 0.0),
    ("bfloat16", 1, 90, 90, 1, 1, 96, True, 30, 0.0),
    ("bfloat16", 1, 130, 97, 1, 2, 256, True, 0, 0.0),
    ("bfloat16", 1, 70, 90, 1, 1, 256, False, 20, 30.0),
    ("float32", 2, 200, 200, 2, 1, 80, True, 0, 0.0),
    ("float32", 1, 130, 190, 2, 2, 80, True, 0, 0.0),
    ("float32", 1, 190, 70, 1, 4, 80, True, 48, 10.0),
    ("float32", 2, 257, 257, 2, 2, 128, True, 100, 0.0),
    ("float32", 1, 77, 213, 1, 4, 128, False, 0, 30.0),
    ("float32", 1, 100, 20, 1, 2, 80, False, 10, 0.0),
    ("float32", 1, 70, 65, 2, 4, 8, False, 0, 0.0),
    ("float32", 1, 100, 120, 2, 1, 32, True, 0, 5.0),
    ("float32", 1, 130, 97, 1, 2, 256, True, 0, 0.0),
]


def _worst_tile_rel_norm(got, want, tile=64):
    """The largest ||got - want|| / ||want|| over tiles of ``tile`` rows
    along dim 1 (a tile where want is zero: 0 if got is too, else inf)."""
    def tiles(t):
        t = t.double().square().transpose(0, 1).reshape(t.shape[1], -1)
        return torch.nn.functional.pad(t.sum(1), (0, -t.shape[0] % tile)
                                       ).view(-1, tile).sum(1)
    dsq, wsq = tiles(got.double() - want.double()), tiles(want)
    rel = torch.where(wsq > 0, (dsq / wsq.clamp_min(1e-300)).sqrt(),
                      torch.where(dsq > 0, float("inf"), 0.0))
    return float(rel.max())


def _flash_bwd_inputs(dev, dt, B, Sq, Skv, Kh, G, hd):
    return [torch.from_numpy(RNG.normal(size=s)).to(dev, dt) for s in (
        (B, Sq, Kh, G, hd), (B, Skv, Kh, hd), (B, Skv, Kh, hd),
        (B, Sq, Kh, G, hd))]


@pytest.mark.parametrize(
    "dtype,B,Sq,Skv,Kh,G,hd,causal,window,softcap", FLASH_BWD_CASES)
def test_flash_backward_kernel_matches_plain(dev, dtype, B, Sq, Skv, Kh, G,
                                             hd, causal, window, softcap):
    from repro_torch.kernels.flash_attention import (
        flash_attention_backward_ref, flash_attention_ref)
    from repro_torch.kernels.flash_attention.ops import (
        flash_attention_backward_cuda, flash_attention_cuda)
    dt = getattr(torch, dtype)
    q, k, v, dout = _flash_bwd_inputs(dev, dt, B, Sq, Skv, Kh, G, hd)
    kw = dict(causal=causal, window=window, softcap=softcap)
    out, lse = flash_attention_cuda(q, k, v, return_lse=True, **kw)
    assert _same(out, flash_attention_cuda(q, k, v, **kw))
    _, lse_ref = flash_attention_ref(q, k, v, return_lse=True, **kw)
    torch.testing.assert_close(lse, lse_ref, rtol=1e-5, atol=1e-5)
    reset_launches()
    got = flash_attention_backward_cuda(q, k, v, out, lse, dout, **kw)
    again = flash_attention_backward_cuda(q, k, v, out, lse, dout, **kw)
    assert launch_counts()["flash_attention_backward"] == 2
    want = flash_attention_backward_ref(q, k, v, out, lse, dout, **kw)
    tol = (1e-4, 1e-5) if dtype == "float32" else (2e-2, 2e-2)
    for name, a, b, w in zip("qkv", got, again, want):
        assert a.dtype == dt and _same(a, b), name
        assert bool(torch.isfinite(a).all()), name
        torch.testing.assert_close(a.float(), w.float(), rtol=tol[0],
                                   atol=tol[1])
        if dtype == "bfloat16":
            assert _worst_tile_rel_norm(a, w) <= 1e-2, name


@pytest.mark.parametrize("hd,G,window", [(64, 1, 0), (80, 1, 0),
                                          (96, 2, 300), (128, 4, 4096)])
def test_flash_backward_wgmma_reruns_are_bit_identical(dev, hd, G, window):
    """The bf16 wgmma route (hd 64 to 128) over many key blocks and query
    tiles a block (the TMA ring wraps many times): three launches give the
    same bits, the third after a launch at another shape."""
    from repro_torch.kernels.flash_attention.ops import (
        flash_attention_backward_cuda, flash_attention_cuda)
    q, k, v, dout = _flash_bwd_inputs(dev, torch.bfloat16, 2, 1030, 1030, 2,
                                      G, hd)
    kw = dict(causal=True, window=window, softcap=0.0)
    out, lse = flash_attention_cuda(q, k, v, return_lse=True, **kw)
    runs = [flash_attention_backward_cuda(q, k, v, out, lse, dout, **kw)
            for _ in range(2)]
    other = _flash_bwd_inputs(dev, torch.bfloat16, 1, 300, 300, 1, G, hd)
    o2, l2 = flash_attention_cuda(*other[:3], return_lse=True)
    flash_attention_backward_cuda(*other[:3], o2, l2, other[3])
    runs.append(flash_attention_backward_cuda(q, k, v, out, lse, dout, **kw))
    for name, a, b, c in zip("qkv", *runs):
        assert _same(a, b) and _same(a, c), name
        assert bool(torch.isfinite(a.float()).all()), name


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("Bt,T,d,N,lanes", [
    (2, 100, 48, 16, 1), (2, 100, 48, 16, 2), (1, 77, 130, 16, 4),
    (2, 45, 64, 4, 1), (1, 70, 96, 4, 4), (2, 33, 40, 32, 1),
    (1, 61, 64, 32, 2), (1, 29, 72, 32, 4), (2, 70, 131, 5, 2),
    (1, 64, 64, 8, 4),
    # several of the backward's 128-step time chunks, the last ragged
    (2, 300, 72, 16, 4), (1, 400, 64, 4, 1), (1, 273, 40, 32, 2),
    (2, 256, 64, 8, 1)])
def test_scan_backward_kernel_matches_plain(dev, Bt, T, d, N, lanes, dtype):
    """The backward kernels on the forward kernel's carries (under each
    lane split; the backward's own split is 4 lanes) against the plain
    walk and against the plain time-chunk decomposition."""
    from repro_torch.kernels.mamba_scan import (carry_steps,
                                                mamba_scan_backward_ref,
                                                mamba_scan_ref)
    from repro_torch.kernels.mamba_scan.ops import (TIME_CHUNK,
                                                    mamba_scan_backward_cuda,
                                                    mamba_scan_cuda)
    args = _scan_args(dev, Bt, T, d, N, dtype)
    dy = torch.from_numpy(RNG.normal(size=(Bt, T, d))).to(dev, torch.float32)
    dhT = torch.from_numpy(RNG.normal(size=(Bt, d, N))).to(dev,
                                                           torch.float32)
    y, hT, carries = mamba_scan_cuda(*args, lanes=lanes, carries=True)
    y2, hT2 = mamba_scan_cuda(*args, lanes=lanes)
    assert _same(y, y2) and _same(hT, hT2)
    _, _, carries_ref = mamba_scan_ref(*args, carries=True)
    assert carries.shape == (Bt, -(-T // carry_steps(N)), d, N)
    torch.testing.assert_close(carries, carries_ref, rtol=1e-4, atol=1e-4)
    reset_launches()
    got = mamba_scan_backward_cuda(*args, carries, dy, dhT)
    again = mamba_scan_backward_cuda(*args, carries, dy, dhT)
    assert launch_counts()["mamba_scan_backward"] == 2
    for name, a, b in zip(("delta", "x", "B", "C", "A", "h0"), got, again):
        assert _same(a, b), name
    wide = [t.float() for t in args[:2]] + args[2:]
    fp32 = mamba_scan_backward_cuda(*wide, carries, dy, dhT)
    want = mamba_scan_backward_ref(*wide, carries, dy, dhT)
    chunked = mamba_scan_backward_ref(*wide, carries, dy, dhT,
                                      time_chunk=TIME_CHUNK)
    for i, name in enumerate(("delta", "x", "B", "C", "A", "h0")):
        assert got[i].dtype == args[i].dtype, name
        assert _same(got[i], fp32[i].to(args[i].dtype)), name
        atol = 1e-4 * (float(want[i].abs().max()) if name == "A" else 1.0)
        torch.testing.assert_close(fp32[i], want[i], rtol=1e-4, atol=atol)
        torch.testing.assert_close(fp32[i], chunked[i], rtol=1e-4,
                                   atol=atol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_backward_functions_never_run_the_plain_versions(dev, dtype,
                                                         monkeypatch):
    """On a CUDA tensor that needs a gradient both Functions run the
    forward and backward kernels once each and no plain version."""
    import repro_torch.kernels.flash_attention.ops as fo
    import repro_torch.kernels.flash_attention.ref as fr
    import repro_torch.kernels.mamba_scan.ops as so
    import repro_torch.kernels.mamba_scan.ref as sr
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.mamba_scan import mamba_scan

    def boom(*a, **kw):
        raise AssertionError("a plain version ran on the card")
    for mod, names in ((fo, ("flash_attention_ref",)),
                       (fr, ("flash_attention_ref",
                             "flash_attention_backward_ref")),
                       (so, ("mamba_scan_ref",)),
                       (sr, ("mamba_scan_ref", "mamba_scan_backward_ref",
                             "mamba_scan_chunked"))):
        for name in names:
            monkeypatch.setattr(mod, name, boom)
    dt = getattr(torch, dtype)
    q, k, v, w = (t.requires_grad_(i < 3) for i, t in enumerate(
        _flash_bwd_inputs(dev, dt, 1, 100, 100, 2, 2, 80)))
    reset_launches()
    (flash_attention(q, k, v) * w).float().sum().backward()
    args = [t.requires_grad_(True) for t in _scan_args(dev, 1, 50, 64, 16,
                                                       dtype)]
    y, hT = mamba_scan(*args)
    (y.sum() + hT.sum()).backward()
    counts = launch_counts()
    assert [counts[n] for n in ("flash_attention", "flash_attention_backward",
                                "mamba_scan", "mamba_scan_backward")] == \
        [1, 1, 1, 1]
    assert all(t.grad is not None and bool(torch.isfinite(t.grad).all())
               for t in [q, k, v] + args)


# ---------------------------------------------------------------- training
# The kernels' Functions on the card: forward and backward are kernels (one
# launch each a call); the gradients are held against the plain route's on
# the same inputs, up to the order of fp32 sums (rtol 1e-4 / atol 1e-5 in
# fp32; bf16 inputs: 2e-2).
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal,window,softcap", [(True, 0, 0.0),
                                                   (True, 48, 10.0),
                                                   (False, 0, 0.0)])
def test_train_flash_function_on_the_card(dev, dtype, causal, window,
                                          softcap):
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_ref)
    dt = getattr(torch, dtype)
    B, S, Kh, G, hd = 2, 200, 2, 2, 80
    arrays = [RNG.normal(size=s) for s in ((B, S, Kh, G, hd), (B, S, Kh, hd),
                                           (B, S, Kh, hd))]
    w = torch.from_numpy(RNG.normal(size=(B, S, Kh, G, hd))).to(dev, dt)
    kw = dict(causal=causal, window=window, softcap=softcap)
    grads = []
    for impl in ("auto", "reference"):
        qkv = [torch.from_numpy(a).to(dev, dt).requires_grad_(True)
               for a in arrays]
        reset_launches()
        out = flash_attention(*qkv, impl=impl, **kw)
        (out.float() * w.float()).sum().backward()
        counts = launch_counts()
        assert counts["flash_attention"] == (impl == "auto")
        assert counts["flash_attention_backward"] == (impl == "auto")
        grads.append([t.grad for t in qkv])
    tol = (1e-4, 1e-5) if dtype == "float32" else (2e-2, 2e-2)
    for got, want in zip(*grads):
        assert got.dtype == dt
        torch.testing.assert_close(got.float(), want.float(), rtol=tol[0],
                                   atol=tol[1])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_train_scan_function_on_the_card(dev, dtype):
    """Gradients of delta, x, B, C, A and h0 through the kernel's Function
    against the plain chunked scan's on the card.  With bf16 delta and x
    their gradients are bf16, rounded from fp32 once on each route, so
    they are held exactly to the kernel route's fp32 gradients of the same
    values widened (which are held to the plain route's within the
    tolerance): the two routes' fp32 values may round to neighbouring bf16
    numbers."""
    from repro_torch.kernels.mamba_scan import mamba_scan, mamba_scan_chunked
    arrays = _scan_args(dev, 2, 100, 48, 16, dtype)
    wy = torch.from_numpy(RNG.normal(size=(2, 100, 48))).to(dev,
                                                            torch.float32)
    grads, launched = [], []
    wide = [t.float() for t in arrays[:2]] + arrays[2:]
    for fn, ins in ((mamba_scan, arrays),
                    (lambda *a: mamba_scan_chunked(*a, chunk=32), wide),
                    (mamba_scan, wide)):
        ts = [t.detach().clone().requires_grad_(True) for t in ins]
        reset_launches()
        y, hT = fn(*ts)
        ((y * wy).sum() + hT.sum()).backward()
        grads.append([t.grad for t in ts])
        counts = launch_counts()
        launched.append([counts["mamba_scan"],
                         counts["mamba_scan_backward"]])
    assert launched == [[1, 1], [0, 0], [1, 1]]
    for arg, got, want, fp32 in zip(arrays, *grads):
        torch.testing.assert_close(fp32, want, rtol=1e-4, atol=1e-4)
        assert got.dtype == arg.dtype
        assert _same(got, fp32.to(arg.dtype))


@pytest.mark.parametrize("arch", ["stablelm-3b", "falcon-mamba-7b"])
def test_train_step_on_the_card_matches_the_cpu(dev, arch):
    """A 2-layer smoke train step (grad_accum 2, fp32 compute) through the
    kernels' Functions on the card against the plain versions on the CPU,
    from the same weights: the loss within rtol 1e-4 and the accumulated
    gradients AdamW receives, leaf by leaf, within 1e-4 of the leaf's
    largest value plus rtol 1e-3 (fp32 sums in other orders).  The
    updated parameters are not compared: Adam's first step moves a weight
    by about lr whatever its gradient's size, so a gradient near eps
    whose rounding differs between the devices moves it by a few percent
    of lr (one wk element of 8192 moved by 2.8% of lr on an H100)."""
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as tf
    from repro_torch.train.optimizer import (OptConfig, init_opt_state,
                                             tree_leaves, tree_map)
    from repro_torch.train.train_step import make_train_step
    cfg = get_config(arch, smoke=True).replace(compute_dtype="float32",
                                               grad_accum=2)
    ocfg = OptConfig(lr=1e-2, warmup_steps=1, total_steps=4)
    toks = torch.from_numpy(RNG.integers(0, cfg.vocab_size, (4, 64)))
    kernel = "flash_attention" if arch == "stablelm-3b" else "mamba_scan"
    out = []
    for device in ("cpu", dev):
        p = tree_map(lambda t: t.to(device),
                     tf.init_params(cfg, seed=0, device="cpu"))
        opt = init_opt_state(p, cfg)
        seen = []

        def capture(g):
            seen.append([t.cpu() for t in tree_leaves(g)])
            return g
        reset_launches()
        _, _, m = make_train_step(cfg, ocfg, grad_transform=capture)(
            p, opt, {"tokens": toks.to(device)})
        # each layer, each microbatch: the forward and the remat recompute
        want = 2 * cfg.n_layers * 2 if device != "cpu" else 0
        assert launch_counts()[kernel] == want
        out.append((float(m["loss"]), seen[0]))
    np.testing.assert_allclose(out[1][0], out[0][0], rtol=1e-4)
    for a, b in zip(out[1][1], out[0][1]):
        torch.testing.assert_close(
            a, b, rtol=1e-3, atol=1e-4 * float(b.abs().max()) + 1e-12)


# Sharded steps on the card: a world of one nccl rank (NCCL puts no two
# ranks on one card) with the real make_rules on a 1x1 mesh.
@pytest.fixture
def mesh1(dev, tmp_path):
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_host_mesh
    dist.init_process_group("nccl", store=dist.FileStore(
        str(tmp_path / "store"), 1), rank=0, world_size=1)
    try:
        yield make_host_mesh(1, 1, device="cuda")
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("arch", ["stablelm-3b", "falcon-mamba-7b"])
def test_sharded_train_step_on_a_world1_mesh_equals_the_unsharded(
        dev, mesh1, arch):
    """Two smoke train steps (grad_accum 2, fp32, the kernels' Functions)
    through ``sharded_train_step`` against ``make_train_step`` from the
    same seed: losses and grad norms within rtol 1e-6, params within 1e-6,
    the kernel launched as often."""
    from repro_torch.configs import get_config
    from repro_torch.launch.train import build_state, sharded_setup
    from repro_torch.train.optimizer import OptConfig, tree_leaves
    from repro_torch.train.sharding import full
    from repro_torch.train.train_step import (make_train_step,
                                              sharded_train_step)
    cfg = get_config(arch, smoke=True).replace(compute_dtype="float32",
                                               grad_accum=2)
    ocfg = OptConfig(lr=1e-2, warmup_steps=1, total_steps=4)
    toks = [torch.from_numpy(RNG.integers(0, cfg.vocab_size, (4, 64))).to(dev)
            for _ in range(2)]
    kernel = "flash_attention" if arch == "stablelm-3b" else "mamba_scan"
    runs = []
    for sharded in (False, True):
        if sharded:
            scfg, rules, p_specs, b_specs = sharded_setup(cfg, mesh1, 4, 64)
            p, opt = build_state(scfg, 0, dev, mesh1, p_specs)
            step = sharded_train_step(scfg, ocfg, rules, p_specs, b_specs,
                                      mesh1)
        else:
            p, opt = build_state(cfg, 0, dev)
            step = make_train_step(cfg, ocfg)
        reset_launches()
        mets = [step(p, opt, {"tokens": t})[2] for t in toks]
        runs.append(([float(m[k]) for m in mets
                      for k in ("loss", "grad_norm")],
                     [full(t).cpu() for t in tree_leaves(p)],
                     launch_counts()[kernel]))
    (lw, pw, nw), (lg, pg, ng) = runs
    np.testing.assert_allclose(lg, lw, rtol=1e-6)
    for a, b in zip(pg, pw):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6)
    assert ng == nw == 2 * 2 * cfg.n_layers * 2


def test_flash_on_local_shards_matches_plain(dev, mesh1):
    """bf16 flash through ``local_map`` on the one card's 1x1 mesh, so the
    kernel gets the whole, unsplit tensor; its shape is the one a rank of
    stablelm-3b at model 2 would get (16 of its 32 kv heads of 80).  q and
    k/v DTensors placed as the model places them, one launch, the output
    placed as q.  Each output element within twice the worst case of bf16
    rounding of the probabilities and the output on either side,
    2^-6 * (attention over |v| + |want|), and the whole within 2^-6 of
    |want| in the 2-norm: a row of 2048 keys averages v down to a few
    hundredths, where a fixed atol of 2e-2 would pass a wrong kernel."""
    from torch.distributed.tensor import DTensor
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import flash_attention_ref
    from repro_torch.models.layers import _flash_local, on_shards
    from repro_torch.train.sharding import distribute, make_rules
    rules = make_rules(mesh1, "train", get_config("stablelm-3b"))
    B, S, Kh, hd = 2, 2048, 16, 80
    q = torch.from_numpy(RNG.normal(size=(B, S, Kh, 1, hd))).to(
        dev, torch.bfloat16)
    k, v = (torch.from_numpy(RNG.normal(size=(B, S, Kh, hd))).to(
        dev, torch.bfloat16) for _ in range(2))
    qs = distribute(q, mesh1, rules.spec("batch", None, "kv_heads_act",
                                         None, None))
    ks, vs = (distribute(t, mesh1, rules.spec("batch", None, "kv_heads_act",
                                              None)) for t in (k, v))
    qp = tuple(qs.placements)
    reset_launches()
    out = on_shards(lambda *a: _flash_local(*a, causal=True, window=0,
                                            softcap=0.0, impl="cuda"),
                    (qs, ks, vs), (qp, tuple(ks.placements),
                                   tuple(vs.placements)), qp)
    assert launch_counts()["flash_attention"] == 1
    assert isinstance(out, DTensor) and tuple(out.placements) == qp
    want = flash_attention_ref(q, k, v, causal=True).float()
    mass = flash_attention_ref(q.float(), k.float(), v.abs().float(),
                               causal=True)
    gap = (out.full_tensor().float() - want).abs()
    assert bool((gap <= 2.0 ** -6 * (mass + want.abs())).all()), \
        float((gap / (mass + want.abs())).max())
    assert float(gap.norm() / want.norm()) <= 2.0 ** -6


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_dryrun_kernel_ops_equal_the_direct_launches(dev, dtype):
    """The registered ops the models call on the card
    (``torch.ops.repro_torch.flash_attention`` / ``mamba_scan``, whose fake
    implementations ``launch/dryrun.py`` traces on meta tensors) launch
    the same kernels: bit-identical to the direct calls, one launch each,
    and counted by ``FlopCounterMode`` through their formulas."""
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch.kernels.flash_attention import ops as fo
    from repro_torch.kernels.mamba_scan import ops as so

    def rand(*shape, dt=dtype):
        return torch.from_numpy(RNG.normal(size=shape)).to(dev, dt)
    q, k, v = rand(2, 200, 2, 3, 64), rand(2, 200, 2, 64), rand(2, 200, 2,
                                                                 64)
    reset_launches()
    with FlopCounterMode(display=False) as fc:
        a = torch.ops.repro_torch.flash_attention(q, k, v, True, 64, 0.0)
    b = fo.flash_attention_cuda(q, k, v, causal=True, window=64)
    assert launch_counts()["flash_attention"] == 2
    assert _same(a, b)
    assert fc.get_total_flops() == 4 * 2 * 2 * 3 * 64 * fo.allowed_pairs(
        200, 200, True, 64)
    Bt, T, d, N = 2, 96, 40, 16
    scan_in = (rand(Bt, T, d).abs() * 0.1, rand(Bt, T, d),
               rand(Bt, T, N, dt=torch.float32),
               rand(Bt, T, N, dt=torch.float32),
               -rand(d, N, dt=torch.float32).abs(),
               rand(Bt, d, N, dt=torch.float32))
    reset_launches()
    y1, h1 = torch.ops.repro_torch.mamba_scan(*scan_in)
    y2, h2 = so.mamba_scan_cuda(*scan_in)
    assert launch_counts()["mamba_scan"] == 2
    assert _same(y1, y2) and _same(h1, h2)
