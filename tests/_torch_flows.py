"""The reference optimizer-equivalence harness's random flows, built on the
port's components: ``flow_spec`` draws a random single-source chain of
Filter / Lookup / Expression / Aggregate / Sort components plus
StageBoundary cuts, and ``build_flow`` builds it (the generator of
``tests/test_optimizer_equivalence.py``).  Shared by the port's property
tests."""
import warnings

import numpy as np

try:
    import hypothesis.strategies as st
except ImportError:        # pragma: no cover — env without the `test` extra
    from _hypothesis_compat import st

from repro_torch.core import Dataflow
from repro_torch.core.component import StageBoundary
from repro_torch.etl.components import (Aggregate, ArraySource, CollectSink,
                                        DimTable, Expression, Filter, Lookup,
                                        Sort)

ROWS = 400
KEYSPACE = 40


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
