"""Sharded flow equivalence in the port, the counterpart of
``test_sharded_flow_equivalence`` in ``tests/test_optimizer_equivalence.py``.

A hypothesis-driven generator (the reference's, built on the port's
components) draws random single-source chains of Filter / Lookup /
Expression / Aggregate / Sort components plus StageBoundary cuts; each flow
runs on ``torch_cpu`` serially and over 1, 2 or 3 shards, on the inline and
mesh routes, fused and unfused.  The sharded sink has the serial sink's
columns, dtypes, row count and order; integer columns are identical and
float32 sums agree within rtol 1e-5 (shards add in another order; the
generated values are integers, so the sums are exact below 2^24).
``REPRO_OPTEQ_EXAMPLES`` scales the example count as in the reference.
"""
import os

import numpy as np

try:
    import hypothesis.strategies as st
    from hypothesis import given, settings
except ImportError:        # pragma: no cover — env without the `test` extra
    from _hypothesis_compat import given, settings, st

from _torch_flows import ROWS, build_flow, flow_spec
from repro_torch.core import OptimizeOptions, StreamingEngine

N_EXAMPLES = int(os.environ.get("REPRO_OPTEQ_EXAMPLES", "100"))
BK = "torch_cpu"


def _assert_sharded_equivalent(spec, shards, route, fuse=False):
    _, num_splits, _ = spec
    flow_s, sink_s = build_flow(spec)
    StreamingEngine(flow_s, OptimizeOptions(
        backend=BK, num_splits=num_splits, fuse_segments=fuse)).run()
    serial = sink_s.result()

    flow_n, sink_n = build_flow(spec)
    run = StreamingEngine(flow_n, OptimizeOptions(
        backend=BK, num_splits=num_splits, fuse_segments=fuse,
        shards=shards, shard_impl=route)).run()
    sharded = sink_n.result()

    label = f"spec={spec} shards={shards} {route} fuse={fuse}"
    assert list(sharded) == list(serial), f"{label}: column sets differ"
    for k in serial:
        assert sharded[k].dtype == serial[k].dtype, \
            f"{label}: dtype of {k} differs"
        if serial[k].dtype.kind == "f":
            np.testing.assert_allclose(sharded[k], serial[k], rtol=1e-5,
                                       atol=0, err_msg=f"{label}: {k}")
        else:
            np.testing.assert_array_equal(
                sharded[k], serial[k], err_msg=f"{label}: column {k}")
    assert run.degradations == 0, label
    if run.shards > 1:
        assert run.shard.impl == route, label
        # every source row lands in exactly one shard
        assert sum(run.shard_rows) == ROWS, label


@given(flow_spec(), st.sampled_from([1, 2, 3]),
       st.sampled_from(["inline", "mesh"]), st.sampled_from([False, True]))
@settings(max_examples=max(N_EXAMPLES // 4, 10), deadline=None,
          derandomize=True)
def test_sharded_flow_equivalence(spec, shards, route, fuse):
    """For every generated DAG, running partitioned over N shards (N=1 is
    the serial fast path) on either in-process route gives the serial sink,
    with and without segment fusion."""
    _assert_sharded_equivalent(spec, shards, route, fuse)


def test_sharded_equivalence_all_rules_fire_together():
    """lookup/expr/filter/agg/sort in one flow, the aggregate keyed on a
    source column: the HASH partitioning mode (group-disjoint shards)."""
    spec = (7, 4, [("lookup", 3, 0, True),
                   ("expr", 3, 4, False),
                   ("filter", 4, 30, True),
                   ("agg", 2, 5, "sum"),
                   ("sort", 0)])
    for route in ("inline", "mesh"):
        _assert_sharded_equivalent(spec, 3, route)
        _assert_sharded_equivalent(spec, 3, route, fuse=True)


def test_sharded_equivalence_boundary_and_empty():
    spec = (11, 2, [("boundary",), ("expr", 0, 3, True), ("boundary",)])
    _assert_sharded_equivalent(spec, 2, "mesh")
    # two stacked filters can drop every row of a shard
    spec = (3, 2, [("filter", 3, 10, True), ("filter", 4, 10, True),
                   ("agg", 1, 2, "count")])
    _assert_sharded_equivalent(spec, 3, "mesh")
