"""Keyed Aggregates of SSB lineorder whose id spaces take the grouped sums'
partitioned route on the card: by ``lo_partkey`` and by ``lo_custkey``,
serial on the optimized engine and over 4 mesh shards, in the port on
``torch_cpu`` (the kernels' plain versions) against the reference on
``jax`` over the same route and data.

At 40,000 rows over 20,000 parts and 9,000 customers each id space is past
the direct routes' 7,168 cells: every grouped sum of these flows (the
serial groupby, each shard's groupby over the whole key range, the mesh
combiner's segment sum) is recorded and must take the partitioned route.

Tolerances: group keys, counts, row order and dtypes are identical; float32
sums within rtol 1e-5 of the reference (another order of float32 adds)
and within the backend's ``oracle_rtol`` of a float64 ``np.unique`` +
``bincount`` oracle.
"""
import numpy as np
import pytest

from repro.core import Dataflow as RefDataflow
from repro.core import OptimizedEngine as RefOptimized
from repro.core import OptimizeOptions as RefOptions
from repro.core import StreamingEngine as RefStreaming
from repro.etl import components as ref_components
from repro.etl import ssb as ref_ssb
from repro_torch.core import (Dataflow, OptimizedEngine, OptimizeOptions,
                              StreamingEngine, get_backend)
from repro_torch.core.backend import torch_backend
from repro_torch.core.shard import mesh
from repro_torch.etl import components as port_components
from repro_torch.etl import ssb
from repro_torch.kernels import _grouped_sum as gs

BK = "torch_cpu"
SIZES = dict(lineorder_rows=40_000, customers=9_000, suppliers=60,
             parts=20_000, seed=11)


@pytest.fixture(scope="module")
def data():
    return ssb.generate(**SIZES), ref_ssb.generate(**SIZES)


def _flow(pkg, df, lineorder, key):
    """lineorder -> Aggregate(key: revenue sum, row count) -> sink."""
    flow = df(f"{key}-revenue")
    sink = pkg.CollectSink("sink")
    flow.chain(pkg.ArraySource("lineorder", lineorder),
               pkg.Aggregate(f"by_{key}", [key],
                             {"revenue": ("lo_revenue", "sum"),
                              "orders": ("lo_revenue", "count")}),
               sink)
    return flow, sink


def _grouped_calls(monkeypatch):
    """Record (op, n_groups, value columns) of every grouped sum the
    backend's groupby and the mesh combiner make."""
    calls = []

    def spy(op, fn, with_counts):
        def wrapped(ids, values, n_groups, **kw):
            calls.append((op, int(n_groups), values.shape[1], with_counts))
            return fn(ids, values, n_groups, **kw)
        return wrapped
    monkeypatch.setattr(torch_backend, "radix_groupby",
                        spy("groupby", torch_backend.radix_groupby, True))
    monkeypatch.setattr(mesh, "segment_sum",
                        spy("combiner", mesh.segment_sum, False))
    return calls


def _assert_close(got, want, label):
    assert list(got) == list(want), label
    for k in want:
        assert got[k].dtype == want[k].dtype, f"{label}: dtype of {k}"
        if want[k].dtype.kind == "f":
            np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=0,
                                       err_msg=f"{label}: column {k}")
        else:
            np.testing.assert_array_equal(got[k], want[k],
                                          err_msg=f"{label}: column {k}")


@pytest.mark.parametrize("key,groups", [("lo_partkey", SIZES["parts"]),
                                        ("lo_custkey", SIZES["customers"])])
@pytest.mark.parametrize("shards", [1, 4])
def test_keyed_aggregate_matches_reference(data, monkeypatch, key, groups,
                                           shards):
    td, rd = data
    calls = _grouped_calls(monkeypatch)
    flow, sink = _flow(port_components, Dataflow, td.lineorder, key)
    rflow, rsink = _flow(ref_components, RefDataflow, rd.lineorder, key)
    if shards == 1:
        run = OptimizedEngine(flow, OptimizeOptions(
            backend=BK, fuse_segments=True, num_splits=4)).run()
        rrun = RefOptimized(rflow, RefOptions(
            backend="jax", fuse_segments=True, num_splits=4)).run()
    else:
        run = StreamingEngine(flow, OptimizeOptions(
            backend=BK, fuse_segments=True, num_splits=4, shards=shards,
            shard_impl="mesh")).run()
        rrun = RefStreaming(rflow, RefOptions(
            backend="jax", fuse_segments=True, num_splits=4, shards=shards,
            shard_impl="mesh")).run()
        assert run.shard.impl == "mesh" and run.shard.mode == "hash"
        assert run.shard_rows == rrun.shard_rows
        assert sum(run.shard_rows) == SIZES["lineorder_rows"]
    got, want = sink.result(), rsink.result()
    label = f"{key} shards={shards}"
    _assert_close(got, want, label + " vs reference")
    assert run.degradations == rrun.degradations == 0
    uniq, inv = np.unique(td.lineorder[key], return_inverse=True)
    assert len(uniq) > gs.WIDE_FLOATS // 2
    np.testing.assert_array_equal(got[key], uniq)
    np.testing.assert_array_equal(got["orders"], np.bincount(inv))
    np.testing.assert_allclose(
        got["revenue"], np.bincount(
            inv, weights=td.lineorder["lo_revenue"].astype(np.float64)),
        rtol=get_backend(BK).oracle_rtol, atol=0)
    # every grouped sum of the flow takes the partitioned route: the
    # groupby (a shard's over the whole key range) and the combiner
    assert [op for op, *_ in calls].count("groupby") == shards
    assert [op for op, *_ in calls].count("combiner") == (shards > 1)
    # (the groupby's ids span a key range, the combiner's the keys)
    for op, n_groups, cols, counts in calls:
        assert n_groups == len(uniq) if op == "combiner" else \
            n_groups <= groups, (op, n_groups)
        assert not gs.is_direct(n_groups, cols, counts), (op, n_groups)
