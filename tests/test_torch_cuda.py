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
                                           hash_probe_ref)
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
    reset_launches()
    idx, found = hash_probe(sk, si, vals, built["max_probes"])
    idx2, found2 = hash_probe(sk, si, vals, built["max_probes"])
    assert launch_counts()["hash_probe"] == 2
    ridx, rfound = hash_probe_ref(sk, si, vals, built["max_probes"])
    assert _same(idx, ridx) and _same(found, rfound)
    assert _same(idx, idx2) and _same(found, found2)


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
