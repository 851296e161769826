"""Algorithm 3 + Theorem 1 — estimate the optimal degree of pipeline
parallelization, plus the runtime plan for the streaming executor.

Cost model (paper §4.2): with m splits, staggering activity A_j of
per-split time t_j = t0 + lambda*N/m, and per-activity miscellaneous time
t0, the pipeline time is

    T_p(m) = c/m + (m-1)*t_j + n*t0
           = (c - lambda*N)/m + t0*m + lambda*N + (n-1)*t0

minimized at  m* = sqrt((c - lambda*N) / t0)          (Theorem 1)

where c = m * sum_i (t_i - t0) is the total *net* processing time of the
full input (independent of m) and N is the number of rows through A_j.

Beyond the paper: ``plan_runtime`` sizes the shared worker pool and the
per-inter-tree-edge channel depths from cache-size metadata (estimated bytes
crossing each tree boundary), so backpressure bounds in-flight copies to a
memory budget while keeping enough depth to decouple producer bursts.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from .component import ComponentType
from .graph import Dataflow
from .partitioner import ExecutionTreeGraph


# ---------------------------------------------------------------------------
#  Segment discovery — maximal fusable row-synchronized chains
# ---------------------------------------------------------------------------
def _segment_fusable(comp) -> bool:
    """A component may join a fused segment iff it is row-synchronized,
    declares segment ops (row-local by the §3 contract), is not an explicit
    stage cut, not order-sensitive, and not chunk-sensitive (its data
    semantics must not depend on where chunk boundaries fall, because fused
    device kernels pad chunks to a bucketed batch size)."""
    return (comp.ctype == ComponentType.ROW_SYNC
            and not comp.order_sensitive
            and not comp.tree_boundary
            and not getattr(comp, "chunk_sensitive", False)
            and comp.segment_ops() is not None)


def discover_segments(flow: Dataflow,
                      through_aggregates: bool = False) -> List[List[str]]:
    """Find every maximal chain of fusable row-synchronized components.

    A chain extends across an edge u -> v only when it is a simple chain
    segment (out-degree(u) == 1, in-degree(v) == 1) and both endpoints are
    fusable; fan-in/fan-out, block / semi-block components, sinks, explicit
    ``StageBoundary`` cuts, order-sensitive and chunk-sensitive members all
    terminate (or refuse) a segment.  Only chains of length >= 2 are
    returned — fusing a single component would only rename it.

    ``through_aggregates=True`` additionally extends each found chain through
    its single downstream consumer when that consumer declares
    ``segment_terminal_aggregate`` (the ``Aggregate`` block component): the
    aggregate then appears as the chain's LAST member.  It does not join the
    fused kernel — the optimizer strips it before collapsing — but marks the
    segment for keep-mask deferral: the per-chunk compact moves into
    ``Aggregate.finish``, applied once after the merge (the d2h mask sync a
    device backend would otherwise pay per chunk disappears)."""
    chains: List[List[str]] = []
    seen: set = set()
    for name in flow.topo_order():
        if name in seen or not _segment_fusable(flow.component(name)):
            continue
        preds = flow.pred(name)
        if (len(preds) == 1 and flow.out_degree(preds[0]) == 1
                and _segment_fusable(flow.component(preds[0]))):
            continue                 # not a chain head; covered upstream
        chain = [name]
        seen.add(name)
        cur = name
        while True:
            succs = flow.succ(cur)
            if len(succs) != 1:
                break
            nxt = succs[0]
            if (flow.in_degree(nxt) != 1
                    or not _segment_fusable(flow.component(nxt))):
                break
            chain.append(nxt)
            seen.add(nxt)
            cur = nxt
        if len(chain) < 2:
            continue
        if through_aggregates:
            succs = flow.succ(cur)
            if len(succs) == 1 and flow.in_degree(succs[0]) == 1:
                nxt = flow.component(succs[0])
                if getattr(nxt, "segment_terminal_aggregate", False):
                    chain.append(succs[0])
        chains.append(chain)
    return chains


# ---------------------------------------------------------------------------
#  Static schema inference — AST/declared provenance over the whole flow
# ---------------------------------------------------------------------------
def infer_schema(flow: Dataflow, strict: bool = False):
    """Propagate column schemas through the flow from source column sets and
    each component's ``output_schema`` hook.

    Returns ``{component_name: frozenset(columns) | None}`` — the column set
    each component EMITS (``None`` once an unknown-schema component poisons
    the walk).  With the expression DSL this is exact static provenance: the
    Session front end runs it at build time so a typo'd column name fails at
    ``sink()`` with the component and the missing column named, instead of a
    ``KeyError`` deep inside a worker thread mid-run.

    ``strict=True`` additionally requires every component's declared read set
    (``consumed_columns``) to be covered by its input schema whenever both
    are known, raising ``ValueError`` otherwise."""
    schemas: Dict[str, Optional[frozenset]] = {}
    for name in flow.topo_order():
        comp = flow.component(name)
        preds = flow.pred(name)
        if not preds:
            incols: Optional[frozenset] = frozenset()
        else:
            pred_schemas = [schemas[p] for p in preds]
            if any(s is None for s in pred_schemas):
                incols = None
            else:
                # fan-in: only columns present on EVERY input branch are
                # safely readable (concat across branches requires equal
                # schemas anyway) — a union would let strict mode pass a
                # read that exists on just one branch
                incols = frozenset.intersection(*pred_schemas)
        if incols is not None:
            reads = comp.consumed_columns()
            if strict and reads is not None and preds:
                missing = reads - incols
                if missing:
                    raise ValueError(
                        f"component {name!r} reads column(s) "
                        f"{sorted(missing)} that are not in its input "
                        f"schema {sorted(incols)} — check the flow's "
                        f"expressions and column names")
            schemas[name] = comp.output_schema(incols)
        else:
            schemas[name] = None
    return schemas


@dataclass
class PipelinePlan:
    n: int                    # number of activities in the execution tree
    t0: float                 # avg per-activity miscellaneous time  (line 1,3)
    c: float                  # total net processing time, full input (line 3)
    lam: float                # lambda: seconds per row at the staggering activity
    N: int                    # rows processed by the staggering activity
    staggering: str           # name of A_j                          (line 3)
    activity_times: Dict[str, float] = field(default_factory=dict)
    T_s: float = 0.0          # measured sequential time on the sample
    m_star: float = 1.0       # Theorem 1 optimum                    (line 5)

    def predict_T_p(self, m: float) -> float:
        m = max(1.0, float(m))
        return ((self.c - self.lam * self.N) / m + self.t0 * m
                + self.lam * self.N + (self.n - 1) * self.t0)

    def predict_T_s(self) -> float:
        return self.c + self.n * self.t0

    def predict_speedup(self, m: float) -> float:
        tp = self.predict_T_p(m)
        return self.predict_T_s() / tp if tp > 0 else float("inf")


def theorem1_m_star(c: float, lam: float, N: float, t0: float,
                    m_max: Optional[int] = None) -> float:
    """m* = sqrt((c - lambda*N)/t0), clamped to [1, m_max] (paper: 1<=m<=|Sigma|).

    Degenerate calibration statistics get explicit fallbacks instead of a
    division by zero or a NaN plan: non-finite inputs -> 1 (serial); zero
    per-activity time t0 with no net work (c <= lambda*N) -> 1; zero t0 with
    real work -> the cost model says "as parallel as allowed" -> m_max."""
    if not all(math.isfinite(x) for x in (c, lam, N, t0)):
        return 1.0
    net = c - lam * N
    if t0 <= 0:
        return 1.0 if net <= 0 else float(m_max or 1)
    inner = max(net, 0.0) / t0
    m = math.sqrt(inner)
    m = max(1.0, m)
    if m_max is not None:
        m = min(m, float(m_max))
    return m


def build_plan(activity_times: Dict[str, float],
               misc_total: float,
               sample_rows: int,
               full_rows: int,
               m_prime: int,
               staggering_rows_sample: Optional[int] = None) -> PipelinePlan:
    """Algorithm 3 from measured quantities.

    ``activity_times``: per-activity busy time from the *sequential* sample
        run over m' splits                                        (line 2)
    ``misc_total``: T_0 — busy time of a zero-row run              (line 1)
    ``sample_rows`` / ``full_rows``: |D| and |Sigma|-scale factor
    ``staggering_rows_sample``: rows through A_j in the sample (defaults to
        sample_rows; differs when upstream filters drop rows).
    """
    names = list(activity_times.keys())
    if not names:
        # degenerate calibration (no activities measured): serial plan
        return PipelinePlan(n=0, t0=0.0, c=0.0, lam=0.0, N=0,
                            staggering="", T_s=0.0, m_star=1.0)
    times = np.array([activity_times[k] for k in names], dtype=np.float64)
    n = len(names)
    T_s = float(times.sum())
    t0 = misc_total / max(n, 1)                                   # line 3
    j = int(times.argmax())                                       # line 3
    staggering = names[j]
    scale = full_rows / max(sample_rows, 1)
    c_sample = max(T_s - misc_total, 1e-12)
    c = c_sample * scale                                          # line 3
    N_s = staggering_rows_sample or sample_rows
    N = int(round(N_s * scale))
    # line 4: lambda from the staggering activity's per-split time
    t_j_split = times[j] / max(m_prime, 1)
    lam = max(t_j_split - t0, 1e-12) * max(m_prime, 1) / max(N_s, 1)
    m_star = theorem1_m_star(c, lam, N, t0, m_max=full_rows)      # line 5
    return PipelinePlan(n=n, t0=t0, c=c, lam=lam, N=N, staggering=staggering,
                        activity_times=dict(activity_times), T_s=T_s,
                        m_star=m_star)


def choose_degree(plan: PipelinePlan, cores: Optional[int] = None,
                  cap: int = 64, split_bytes: Optional[int] = None,
                  memory_budget_bytes: Optional[int] = None) -> int:
    """Practical degree: Theorem-1 optimum, bounded by a configured cap and
    (when known) by available cores — the paper observed the decline past the
    core count (Fig 12/13).  When cache-size metadata is available
    (``split_bytes``), the degree is additionally capped so m' in-flight
    shared caches fit the memory budget."""
    if not math.isfinite(plan.m_star):
        return 1                    # degenerate plan: explicit serial fallback
    m = int(round(plan.m_star))
    if cores is not None:
        m = min(m, max(1, cores))
    if split_bytes and memory_budget_bytes:
        m = min(m, max(1, memory_budget_bytes // max(split_bytes, 1)))
    return int(min(max(m, 1), cap))


# ---------------------------------------------------------------------------
#  Runtime plan — shared pool width + per-edge channel depths (executor.py)
# ---------------------------------------------------------------------------
#: default memory budget for in-flight cross-tree copies, per edge
DEFAULT_CHANNEL_BUDGET_BYTES = 256 * 1024 * 1024


@dataclass
class RuntimePlan:
    """Sizing decisions for one engine run of the streaming executor."""
    pool_width: int
    # (src_tree_id, dst_tree_id) -> bounded queue depth (splits in flight)
    channel_depth: Dict[Tuple[int, int], int] = field(default_factory=dict)
    # (src_tree_id, dst_tree_id) -> estimated bytes crossing the edge
    edge_bytes: Dict[Tuple[int, int], int] = field(default_factory=dict)
    # source chunk rows aligned to the backend's preferred batch size; None
    # when no backend preference was planned (executor falls back to
    # total/num_splits)
    chunk_rows: Optional[int] = None

    def spec(self) -> dict:
        """Metadata-store representation (cache-size planning info)."""
        return {
            "pool_width": self.pool_width,
            "chunk_rows": self.chunk_rows,
            "channels": [{"edge": list(k), "depth": d,
                          "est_bytes": self.edge_bytes.get(k, 0)}
                         for k, d in sorted(self.channel_depth.items())],
        }


def estimate_edge_bytes(flow: Dataflow,
                        g_tau: ExecutionTreeGraph) -> Dict[Tuple[int, int], int]:
    """Cache-size metadata per inter-tree edge: estimated bytes of the split
    stream crossing each tree->tree transition.  Source trees report their
    source's total bytes (``Component.est_output_bytes``); downstream trees
    inherit the sum of their inputs (a conservative no-attenuation bound —
    filters only shrink it).  Every out-edge carries the FULL replicated
    stream (the pipeline copies the output to each cross-tree successor),
    so fan-out does not divide the estimate."""
    tree_bytes: Dict[int, int] = {}
    for tid in g_tau.topo_tree_order():
        tree = g_tau.tree(tid)
        root = flow.component(tree.root)
        est = root.est_output_bytes()
        if est is None:
            ups = g_tau.upstream_trees(tid)
            est = sum(tree_bytes.get(u, 0) for u in ups)
        tree_bytes[tid] = int(est)
    return {(a, b): tree_bytes.get(a, 0) for (a, b) in g_tau.edges}


def choose_channel_depth(edge_nbytes: int, num_splits: int, m_prime: int,
                         memory_budget_bytes: int = DEFAULT_CHANNEL_BUDGET_BYTES
                         ) -> int:
    """Per-edge queue depth m'': deep enough to decouple producer bursts
    (>= 2), never deeper than m' (upstream admission already bounds in-flight
    splits), and shallow enough that the buffered cross-tree COPIES stay
    within the memory budget."""
    depth = max(1, int(m_prime))
    split_bytes = edge_nbytes // max(1, int(num_splits))
    if split_bytes > 0:
        by_mem = memory_budget_bytes // split_bytes
        depth = min(depth, max(2, int(by_mem)))
    return max(1, depth)


def choose_pool_width(num_trees: int, m_prime: int,
                      mt_threads: Optional[Dict[str, int]] = None,
                      wave_width: int = 1,
                      cores: Optional[int] = None, cap: int = 64) -> int:
    """Width of the single shared worker pool: enough runnable workers for
    m' in-flight splits per concurrently-active tree plus the widest §4.3
    row-range fan-out, capped (and capped at cores when known — the paper's
    Fig 12/13 decline past the core count).  ``wave_width`` is the number
    of trees active at once — the widest schedule wave, plus any streamed
    trees that overlap their upstream wave — and never exceeds
    ``num_trees``."""
    mt_max = max([1] + list((mt_threads or {}).values()))
    concurrency = max(1, min(wave_width, max(num_trees, 1)))
    want = max(2, m_prime * concurrency, mt_max)
    if cores is not None:
        want = min(want, max(1, cores))
    return int(min(want, cap))


def backend_chunk_rows(flow: Dataflow, num_splits: int, backend) -> Optional[int]:
    """Source chunk size honouring the backend's preferred batch alignment:
    total/num_splits rounded UP to a multiple of ``backend.batch_align`` so
    device runners see few distinct chunk shapes."""
    align = max(1, int(getattr(backend, "batch_align", 1)))
    if align == 1:
        return None          # no preference: keep per-source even splits
    total = 0
    from .component import SourceComponent   # local import (module cycle)
    for sname in flow.sources():
        comp = flow.component(sname)
        if isinstance(comp, SourceComponent):
            total = max(total, comp.total_rows())
    if total <= 0:
        return None
    base = -(-total // max(1, int(num_splits)))
    return int(-(-base // align) * align)


def plan_runtime(flow: Dataflow, g_tau: ExecutionTreeGraph, *,
                 num_splits: int, m_prime: int,
                 mt_threads: Optional[Dict[str, int]] = None,
                 cores: Optional[int] = None,
                 pool_width: Optional[int] = None,
                 channel_capacity: Optional[int] = None,
                 memory_budget_bytes: int = DEFAULT_CHANNEL_BUDGET_BYTES,
                 streaming: bool = False,
                 backend=None,
                 edge_bytes_override: Optional[Dict[Tuple[int, int], int]]
                 = None) -> RuntimePlan:
    """Build the executor sizing plan for one run.  Explicit ``pool_width`` /
    ``channel_capacity`` overrides win; otherwise widths come from the
    schedule's widest wave (plus streamed-boundary overlap when
    ``streaming``) and depths from cache-size metadata.  When an operator
    ``backend`` is given, source splits are batched to its preferred size
    (``RuntimePlan.chunk_rows``) and edge-byte estimates already reflect its
    dtype widths via ``Component.est_output_bytes``.

    ``edge_bytes_override`` replaces the static ``est_output_bytes`` guesses
    with MEASURED per-edge bytes (``optimizer.measured_edge_bytes``) — the
    adaptive path where channel depths reflect observed attenuation instead
    of the conservative no-attenuation bound."""
    from .partitioner import streamable_tree_ids
    from .scheduler import plan_schedule     # local import (module cycle)
    wave_width = max((len(w) for w in plan_schedule(g_tau)), default=1)
    if streaming:
        # a streamed stage-boundary tree runs concurrently with its
        # upstream wave rather than after it
        wave_width += len(streamable_tree_ids(flow, g_tau))
    width = pool_width if pool_width is not None else choose_pool_width(
        len(g_tau.trees), m_prime, mt_threads, wave_width, cores=cores)
    edge_bytes = (dict(edge_bytes_override) if edge_bytes_override is not None
                  else estimate_edge_bytes(flow, g_tau))
    depths: Dict[Tuple[int, int], int] = {}
    for edge, nbytes in edge_bytes.items():
        depths[edge] = (channel_capacity if channel_capacity is not None
                        else choose_channel_depth(nbytes, num_splits, m_prime,
                                                  memory_budget_bytes))
    chunk = (backend_chunk_rows(flow, num_splits, backend)
             if backend is not None else None)
    return RuntimePlan(pool_width=max(1, int(width)),
                       channel_depth=depths, edge_bytes=edge_bytes,
                       chunk_rows=chunk)
