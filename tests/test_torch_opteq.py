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
import warnings

import numpy as np

try:
    import hypothesis.strategies as st
    from hypothesis import given, settings
except ImportError:        # pragma: no cover — env without the `test` extra
    from _hypothesis_compat import given, settings, st

from repro_torch.core import Dataflow, OptimizeOptions, StreamingEngine
from repro_torch.core.component import StageBoundary
from repro_torch.etl.components import (Aggregate, ArraySource, CollectSink,
                                        DimTable, Expression, Filter, Lookup,
                                        Sort)

N_EXAMPLES = int(os.environ.get("REPRO_OPTEQ_EXAMPLES", "100"))
ROWS = 400
KEYSPACE = 40
BK = "torch_cpu"


def build_flow(spec):
    """A fresh Dataflow + sink from a drawn spec (the reference harness's
    builder on the port's components).  Deterministic: the same spec always
    builds the same flow over the same data."""
    seed, num_splits, ops = spec
    r = np.random.RandomState(seed)
    cols = {
        "k0": r.randint(1, KEYSPACE + 1, ROWS).astype(np.int64),
        "k1": r.randint(1, KEYSPACE + 1, ROWS).astype(np.int64),
        "g": r.randint(0, 4, ROWS).astype(np.int64),
        "v0": r.randint(0, 1000, ROWS).astype(np.int64),
        "v1": r.randint(-50, 50, ROWS).astype(np.int64),
    }
    flow = Dataflow(f"rand-{seed}")
    comps = [ArraySource("src", cols)]
    avail = list(cols.keys())

    for i, op in enumerate(ops):
        kind = op[0]
        if kind == "filter":
            col_i, thresh, declared = op[1:]
            col = avail[col_i % len(avail)]
            reads = [col] if declared else None
            with warnings.catch_warnings():
                if not declared:
                    # undeclared reads are part of the property space
                    warnings.simplefilter("ignore", DeprecationWarning)
                comps.append(Filter(
                    f"filter{i}",
                    lambda c, rows, col=col, t=thresh:
                        c.col(col)[rows] % 97 < t,
                    reads=reads))
        elif kind == "lookup":
            dim_seed, key_i, drop = op[1:]
            keyish = [c for c in avail if c.startswith("k")] or avail
            key = keyish[key_i % len(keyish)]
            rd = np.random.RandomState(dim_seed)
            nk = KEYSPACE if not drop else KEYSPACE // 2   # some unmatched
            dim = DimTable(np.arange(1, nk + 1, dtype=np.int64),
                           {"pay": rd.randint(0, 9, nk).astype(np.int64)})
            out = f"l{i}"
            comps.append(Lookup(f"lookup{i}", dim, key, {out: "pay"}))
            avail.append(out)
        elif kind == "expr":
            a_i, b_i, mul = op[1:]
            a, b = avail[a_i % len(avail)], avail[b_i % len(avail)]
            out = f"e{i}"
            if mul:
                fn = (lambda c, rows, a=a, b=b:
                      c.col(a)[rows] * (c.col(b)[rows] % 7 + 1))
            else:
                fn = (lambda c, rows, a=a, b=b:
                      c.col(a)[rows] + c.col(b)[rows])
            comps.append(Expression(f"expr{i}", out, fn, reads=[a, b]))
            avail.append(out)
        elif kind == "boundary":
            comps.append(StageBoundary(f"cut{i}"))
        elif kind == "agg":
            g_i, v_i, agg_op = op[1:]
            group = avail[g_i % len(avail)]
            val = avail[v_i % len(avail)]
            comps.append(Aggregate(f"agg{i}", [group],
                                   {f"a{i}": (val, agg_op)}))
            avail = [group, f"a{i}"]
        elif kind == "sort":
            by_i = op[1]
            comps.append(Sort(f"sort{i}", [avail[by_i % len(avail)]]))
    sink = CollectSink("sink")
    comps.append(sink)
    flow.chain(*comps)
    return flow, sink


@st.composite
def flow_spec(draw):
    seed = draw(st.integers(0, 10_000))
    num_splits = draw(st.sampled_from([1, 2, 4]))
    n_ops = draw(st.integers(1, 6))
    ops = []
    for _ in range(n_ops):
        kind = draw(st.sampled_from(
            ["filter", "lookup", "lookup", "expr", "expr", "boundary",
             "agg", "sort"]))
        if kind == "filter":
            ops.append(("filter", draw(st.integers(0, 9)),
                        draw(st.integers(10, 90)),
                        draw(st.sampled_from([True, True, False]))))
        elif kind == "lookup":
            ops.append(("lookup", draw(st.integers(0, 1000)),
                        draw(st.integers(0, 3)),
                        draw(st.sampled_from([True, False]))))
        elif kind == "expr":
            ops.append(("expr", draw(st.integers(0, 9)),
                        draw(st.integers(0, 9)),
                        draw(st.sampled_from([True, False]))))
        elif kind == "boundary":
            ops.append(("boundary",))
        elif kind == "agg":
            ops.append(("agg", draw(st.integers(0, 9)),
                        draw(st.integers(0, 9)),
                        draw(st.sampled_from(["sum", "min", "max", "count"]))))
        else:
            ops.append(("sort", draw(st.integers(0, 9))))
    return (seed, num_splits, ops)


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
