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


# Selective scan: fp32 in both, within rtol 1e-4 / atol 1e-4 (the kernel
# fuses multiply-adds and sums the N states in its own order).
@pytest.mark.parametrize("Bt,T,d,N", [(1, 16, 8, 4), (2, 48, 24, 8),
                                      (2, 100, 32, 16), (1, 64, 48, 16),
                                      (3, 333, 1000, 16), (2, 70, 130, 5),
                                      (1, 40, 64, 32)])
def test_mamba_scan_kernel_matches_plain(dev, Bt, T, d, N):
    from repro_torch.kernels.mamba_scan import mamba_scan, mamba_scan_ref
    delta = np.abs(RNG.normal(size=(Bt, T, d))).clip(0.01, 1.0)
    args = [torch.from_numpy(a).to(dev, torch.float32) for a in (
        delta, RNG.normal(size=(Bt, T, d)), RNG.normal(size=(Bt, T, N)),
        RNG.normal(size=(Bt, T, N)), -np.abs(RNG.normal(size=(d, N))) - 0.05,
        RNG.normal(size=(Bt, d, N)))]
    reset_launches()
    y, hT = mamba_scan(*args)
    y2, hT2 = mamba_scan(*args)
    assert launch_counts()["mamba_scan"] == 2
    assert _same(y, y2) and _same(hT, hT2)
    y_ref, hT_ref = mamba_scan_ref(*args)
    torch.testing.assert_close(y, y_ref, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(hT, hT_ref, rtol=1e-4, atol=1e-4)


def test_mamba_scan_kernel_continuation(dev):
    """Two halves with hT -> h0 give the full scan, bit for bit."""
    from repro_torch.kernels.mamba_scan import mamba_scan
    Bt, T, d, N = 2, 200, 96, 16
    delta = np.abs(RNG.normal(size=(Bt, T, d))).clip(0.01, 1.0)
    dl, x, Bm, Cm = (torch.from_numpy(a).to(dev, torch.float32) for a in (
        delta, RNG.normal(size=(Bt, T, d)), RNG.normal(size=(Bt, T, N)),
        RNG.normal(size=(Bt, T, N))))
    A = torch.from_numpy(-np.abs(RNG.normal(size=(d, N))) - 0.05).to(
        dev, torch.float32)
    h0 = torch.zeros((Bt, d, N), dtype=torch.float32, device=dev)
    y, hT = mamba_scan(dl, x, Bm, Cm, A, h0)
    h = slice(0, 77), slice(77, T)
    y1, h1 = mamba_scan(*(t[:, h[0]].contiguous() for t in (dl, x, Bm, Cm)),
                        A, h0)
    y2, h2 = mamba_scan(*(t[:, h[1]].contiguous() for t in (dl, x, Bm, Cm)),
                        A, h1)
    assert _same(torch.cat([y1, y2], 1), y) and _same(h2, hT)


def test_lm_kernels_refuse_what_they_do_not_take(dev):
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.mamba_scan import mamba_scan
    q = torch.zeros((1, 4, 1, 1, 24), device=dev)
    with pytest.raises(ValueError, match="head dim"):
        flash_attention(q, q[:, :, :, 0], q[:, :, :, 0].contiguous())
    # the bf16 kernel copies 16-byte rows
    flat = torch.zeros(4 * 16 + 1, dtype=torch.bfloat16, device=dev)
    qb = flat[1:].view(1, 4, 1, 1, 16)
    kb = torch.zeros((1, 4, 1, 16), dtype=torch.bfloat16, device=dev)
    with pytest.raises(ValueError, match="16-byte"):
        flash_attention(qb, kb, kb)
    z = torch.zeros((1, 4, 8), device=dev)
    s = torch.zeros((1, 4, 33), device=dev)
    with pytest.raises(ValueError, match="state size"):
        mamba_scan(z, z, s, s, torch.zeros((8, 33), device=dev),
                   torch.zeros((1, 8, 33), device=dev))
