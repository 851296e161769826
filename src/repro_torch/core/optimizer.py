"""Cost-based adaptive optimizer — statistics-driven dataflow rewriting and
re-partitioning.

The partitioner (Algorithm 1) and runtime planner run once, up front, with
static ``est_output_bytes`` guesses; a mis-estimated selectivity or a skewed
source leaves pool width, channel depths and tree cuts wrong for the whole
run.  This module closes the loop:

1. **Statistics** — ``run_calibration`` executes the flow over a small source
   prefix (separate caches, sinks suppressed) and harvests per-component
   observations: rows in/out, selectivity, per-row time, emitted cache bytes.
   ``FlowStatistics.from_flow`` harvests the same numbers from the
   instrumented counters of any prior engine run instead.

2. **Rewriting** — ``CostBasedOptimizer`` applies provably row-safe graph
   transformations whose *profitability* (never their correctness) is judged
   from the measured statistics:

   - *filter commute*: hop a row-dropping ``Filter`` ahead of an adjacent
     row-preserving component (Lookup / Expression / Converter / Project)
     when the filter's declared read set is disjoint from the neighbour's
     produced columns, so the expensive neighbour processes fewer rows;
   - *expression fusion*: collapse chains of adjacent ``Expression``
     components into one fused activity, removing per-activity
     miscellaneous time (the t0 of Theorem 1) from the pipeline;
   - *stage-boundary insert/remove*: add a ``StageBoundary`` cut where the
     observed bytes and stage times justify cross-tree overlap under the
     streaming executor, and remove an existing cut whose observed edge
     bytes no longer pay for the per-split copy.

   Each rule REFUSES when safety cannot be proven: undeclared read/write
   sets, non-row-preserving or block/semi-block neighbours, fan-in/fan-out,
   order-sensitive members, ``chunk_sensitive`` sources (whose calibration
   prefix is not representative of full-run data).

3. **Re-planning** — ``measured_edge_bytes`` projects the observed
   per-component output bytes onto the REWRITTEN flow's inter-tree edges so
   ``plan_runtime`` sizes the pool and channel depths from measurements
   instead of source-size guesses, and ``suggest_pipeline_degree`` feeds the
   observed activity times through Algorithm 3 / Theorem 1.

The engine exposes all of this as ``OptimizeOptions(optimize_level=2)``; the
metadata store records the before/after partitions, plans and the applied
rewrite list (``MetadataStore.register_adaptive``).
"""
from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from .component import ComponentType, SourceComponent
from .graph import Dataflow
from .partitioner import ExecutionTreeGraph
from .planner import build_plan, choose_degree, discover_segments

#: estimated seconds to copy one byte across a tree->tree transition —
#: used only to weigh boundary-cut profitability, not correctness
COPY_SECONDS_PER_BYTE = 1.0 / (4 * 1024 ** 3)
#: a stage cut is never inserted for streams smaller than this
MIN_STREAM_BYTES = 1 * 1024 * 1024
#: commute only filters observed to actually drop rows
COMMUTE_SELECTIVITY_MAX = 0.999


# ---------------------------------------------------------------------------
#  Statistics
# ---------------------------------------------------------------------------
@dataclass
class ComponentStats:
    """Observed per-component numbers, scaled to the full input."""
    rows_in: int = 0
    rows_out: int = 0
    busy_time: float = 0.0
    calls: int = 0
    out_bytes: int = 0            # bytes of the caches this component emitted

    @property
    def selectivity(self) -> float:
        """rows_out / rows_in (1.0 when nothing was observed)."""
        return self.rows_out / self.rows_in if self.rows_in > 0 else 1.0

    @property
    def per_row_time(self) -> float:
        return self.busy_time / self.rows_in if self.rows_in > 0 else 0.0

    def spec(self) -> dict:
        return {"rows_in": self.rows_in, "rows_out": self.rows_out,
                "busy_time": self.busy_time, "calls": self.calls,
                "out_bytes": self.out_bytes,
                "selectivity": self.selectivity,
                "per_row_time": self.per_row_time}


@dataclass
class FlowStatistics:
    """Per-component statistics for one flow, scaled to the full input."""
    components: Dict[str, ComponentStats] = field(default_factory=dict)
    sample_rows: int = 0          # calibration prefix size (0 => full run)
    scale: float = 1.0            # full_rows / sample_rows applied already

    def get(self, name: str) -> Optional[ComponentStats]:
        return self.components.get(name)

    def spec(self) -> dict:
        return {"sample_rows": self.sample_rows, "scale": self.scale,
                "components": {n: s.spec()
                               for n, s in sorted(self.components.items())}}

    @classmethod
    def from_flow(cls, flow: Dataflow, scale: float = 1.0) -> "FlowStatistics":
        """Harvest the instrumented counters left on the components by a
        prior engine run (cheapest statistics source: re-planning a flow
        that already ran once costs nothing extra)."""
        out = cls(scale=scale)
        for name, comp in flow.vertices.items():
            bk = comp.get_backend()
            row_bytes = _est_row_bytes(comp, bk)
            out.components[name] = ComponentStats(
                rows_in=int(comp.rows_in * scale),
                rows_out=int(comp.rows_out * scale),
                busy_time=comp.busy_time * scale,
                calls=comp.calls,
                out_bytes=int(comp.rows_out * scale * row_bytes))
        return out


def _est_row_bytes(comp, backend) -> int:
    """Approximate bytes per emitted row (source columns as a proxy for the
    flow's working row width when the component doesn't know better)."""
    est = comp.est_output_bytes()
    if est is not None and comp.rows_out > 0:
        return max(1, est // max(comp.rows_out, 1))
    return 64          # conservative default row width


# ---------------------------------------------------------------------------
#  Calibration — run a source prefix through the flow, sinks suppressed
# ---------------------------------------------------------------------------
def run_calibration(flow: Dataflow, sample_rows: int = 4096,
                    backend=None) -> FlowStatistics:
    """Execute the flow sequentially over a prefix of every source (separate
    caches, ordinary-scheme semantics) and harvest scaled statistics.

    Sinks are counted but NOT written (``SinkComponent.write`` is skipped) so
    calibration never pollutes the run's results.  Component counters are
    reset before and after — the real run starts from clean instrumentation.
    """
    flow.validate()
    flow.reset_stats()
    if backend is not None:
        for comp in flow.vertices.values():
            comp.backend = backend

    out_bytes: Dict[str, int] = {n: 0 for n in flow.vertices}
    states: Dict[str, list] = {
        n: c.new_state() for n, c in flow.vertices.items()
        if c.ctype in (ComponentType.BLOCK, ComponentType.SEMI_BLOCK)}

    def push(name: str, cache) -> None:
        comp = flow.component(name)
        if comp.ctype in (ComponentType.BLOCK, ComponentType.SEMI_BLOCK):
            comp.accumulate(states[name], cache)
            return
        if comp.ctype == ComponentType.SINK:
            # count rows without writing — calibration must not leak into
            # the sink's buffered results
            comp.rows_in += cache.n
            comp.rows_out += cache.n
            comp.calls += 1
            return
        outs = comp.process(cache, shared=False)
        out_bytes[name] += sum(c.nbytes() for c in outs)
        route(name, outs)

    def route(name: str, outs) -> None:
        succs = flow.succ(name)
        per_port = len(outs) == len(succs) and len(outs) > 1
        for i, u in enumerate(succs):
            src = outs[i] if per_port else outs[0]
            push(u, src.copy())

    total_rows = 0
    for sname in flow.sources():
        src = flow.component(sname)
        if not isinstance(src, SourceComponent):
            raise TypeError(f"source {sname!r} is not a SourceComponent")
        total_rows = max(total_rows, src.total_rows())
        taken = 0
        chunk = max(1, min(sample_rows, 4096))
        for cache in src.chunks(chunk):
            out_bytes[sname] += cache.nbytes()
            route(sname, [cache])
            taken += cache.n
            if taken >= sample_rows:
                break
    for name in flow.topo_order():
        comp = flow.component(name)
        if comp.ctype in (ComponentType.BLOCK, ComponentType.SEMI_BLOCK):
            out = comp.finish(states[name])
            out_bytes[name] += out.nbytes()
            route(name, [out])

    sample = min(sample_rows, total_rows) if total_rows else sample_rows
    scale = total_rows / sample if sample > 0 else 1.0
    stats = FlowStatistics(sample_rows=sample, scale=scale)
    for name, comp in flow.vertices.items():
        stats.components[name] = ComponentStats(
            rows_in=int(comp.rows_in * scale),
            rows_out=int(comp.rows_out * scale),
            busy_time=comp.busy_time * scale,
            calls=comp.calls,
            out_bytes=int(out_bytes[name] * scale))
    flow.reset_stats()
    return stats


# ---------------------------------------------------------------------------
#  Rewrite rules
# ---------------------------------------------------------------------------
@dataclass
class Rewrite:
    """One applied graph transformation (recorded in the metadata store)."""
    rule: str                  # "filter-commute" | "fuse-expressions" |
    #                            "insert-boundary" | "remove-boundary"
    detail: str

    def spec(self) -> dict:
        return {"rule": self.rule, "detail": self.detail}


@dataclass
class Refusal:
    """One rewrite the optimizer REFUSED for safety, with the reason —
    surfaced on ``EngineRun.refusals`` so silently-disabled optimizations
    (e.g. an undeclared lambda read set) are visible instead of just absent.
    Refusals whose reason contains ``"undeclared"`` are exactly the ones the
    expression DSL eliminates (provenance derived from the AST)."""
    rule: str
    detail: str

    def spec(self) -> dict:
        return {"rule": self.rule, "detail": self.detail}


def _is_chain_edge(flow: Dataflow, u: str, v: str) -> bool:
    return ((u, v) in flow.edges and flow.out_degree(u) == 1
            and flow.in_degree(v) == 1)


def _chunk_sensitive_sources(flow: Dataflow) -> bool:
    return any(isinstance(c, SourceComponent) and c.chunk_sensitive
               for c in flow.vertices.values())


def fuse_segments_flow(flow: Dataflow) -> List[Rewrite]:
    """Segment fusion: collapse every maximal fusable row-synchronized chain
    (``planner.discover_segments``) into a single ``FusedSegment`` activity
    executed as ONE backend dispatch per chunk (``Backend.compile_segment``).

    Purely structural — safety comes from the chain shape and the row-local
    §3 contract of the members, not from statistics — so it applies at any
    optimize level when enabled (``OptimizeOptions.fuse_segments`` /
    ``REPRO_FUSION=1``).  Refuses across block / semi-block components,
    fan-in/fan-out, explicit ``StageBoundary`` cuts, order-sensitive and
    chunk-sensitive members (the discovery rules).

    Chains are discovered THROUGH a terminal ``Aggregate`` consumer
    (``discover_segments(through_aggregates=True)``): the aggregate never
    joins the fused kernel, but its presence lets the segment defer its
    combined keep-mask (``FusedSegment.defer_mask_to``) — deferral-capable
    backends then skip the per-chunk compact, the mask rides downstream as a
    device column, and ``Aggregate.finish`` applies it once after the merge.
    """
    from ..etl.components import FusedSegment   # deferred (layering)
    out: List[Rewrite] = []
    for chain in discover_segments(flow, through_aggregates=True):
        tail = flow.component(chain[-1])
        agg = (tail if getattr(tail, "segment_terminal_aggregate", False)
               else None)
        members = chain[:-1] if agg is not None else chain
        comps = [flow.component(n) for n in members]
        fused = FusedSegment.from_components(comps)
        flow.collapse_chain(members, fused)
        out.append(Rewrite("fuse-segment",
                           f"{'+'.join(members)} -> {fused.name} "
                           f"({len(members)} dispatches -> 1)"))
        if agg is not None:
            fused.defer_mask_to(agg)
            out.append(Rewrite(
                "fuse-segment-aggregate",
                f"{fused.name} defers keep-mask to {agg.name} "
                f"(per-chunk mask sync -> one at finish)"))
    if out:
        flow.validate()
    return out


class CostBasedOptimizer:
    """Rewrites a ``Dataflow`` IN PLACE from measured statistics.

    Every rule is row-safe by construction — the statistics only decide
    *profitability*.  ``optimize()`` iterates the rules to a fixpoint
    (bounded) and returns the applied ``Rewrite`` records.
    """

    def __init__(self, flow: Dataflow, stats: FlowStatistics, *,
                 streaming: bool = False,
                 min_stream_bytes: int = MIN_STREAM_BYTES,
                 copy_seconds_per_byte: float = COPY_SECONDS_PER_BYTE,
                 max_passes: int = 8,
                 max_boundary_inserts: int = 1,
                 fuse_segments: bool = False):
        self.flow = flow
        self.stats = stats
        self.streaming = streaming
        self.min_stream_bytes = min_stream_bytes
        self.copy_seconds_per_byte = copy_seconds_per_byte
        self.max_passes = max_passes
        #: run segment fusion (fuse_segments_flow) after the statistics-
        #: driven rules settle, so commutes/cuts see individual activities
        self.fuse_segments = fuse_segments
        # the overlap model (min(T_up, T_down) gained per cut) reasons about
        # ONE producer/consumer pair; chained cuts do not compose gains, so
        # inserts are capped per optimize() round
        self.max_boundary_inserts = max_boundary_inserts
        self._inserted = 0
        self.rewrites: List[Rewrite] = []
        #: rewrites refused for safety, with reasons (deduplicated across
        #: the fixpoint passes) — zero "undeclared" entries on DSL-built
        #: flows is an acceptance gate
        self.refusals: List[Refusal] = []
        self._refused_keys: set = set()

    def _refuse(self, rule: str, detail: str) -> None:
        key = (rule, detail)
        if key not in self._refused_keys:
            self._refused_keys.add(key)
            self.refusals.append(Refusal(rule, detail))

    # ------------------------------------------------------------- driver
    def optimize(self) -> List[Rewrite]:
        for _ in range(self.max_passes):
            changed = (self._commute_filters()
                       or self._fuse_expressions()
                       or self._boundary_rules())
            if not changed:
                break
        if self.fuse_segments:
            # structural segment fusion LAST: the statistics-driven rules
            # above reason about individual activities
            self.rewrites.extend(fuse_segments_flow(self.flow))
        self.flow.validate()
        return self.rewrites

    # ------------------------------------------- rule 1: filter commute
    def can_commute(self, up: str, filt: str) -> Tuple[bool, str]:
        """Row-safety of hoisting ``filt`` ahead of its upstream ``up``.
        Returns (ok, reason-when-refused)."""
        flow = self.flow
        f = flow.component(filt)
        u = flow.component(up)
        if not _is_chain_edge(flow, up, filt):
            return False, "not a simple chain segment"
        if u.ctype != ComponentType.ROW_SYNC:
            return False, f"upstream {up!r} is {u.ctype.value}, not row-sync"
        if not u.row_preserving:
            return False, f"upstream {up!r} is not row-preserving"
        if u.tree_boundary:
            return False, f"upstream {up!r} is an explicit stage cut"
        if u.order_sensitive or f.order_sensitive:
            return False, "order-sensitive neighbour"
        reads = f.consumed_columns()
        if reads is None:
            return False, f"filter {filt!r} has an undeclared read set"
        if f.produced_columns() != frozenset():
            # only pure row-droppers commute: a component that also ADDS
            # columns could feed something its new upstream needs
            return False, f"{filt!r} produces columns — not a pure filter"
        writes = u.produced_columns()
        if writes is None:
            return False, f"upstream {up!r} has an undeclared write set"
        overlap = reads & writes
        if overlap:
            return False, (f"filter reads columns produced by {up!r}: "
                           f"{sorted(overlap)}")
        if flow.in_degree(up) != 1:
            return False, f"upstream {up!r} has fan-in"
        return True, ""

    def _commute_filters(self) -> bool:
        flow = self.flow
        for name in list(flow.topo_order()):
            comp = flow.vertices.get(name)
            if comp is None or comp.ctype != ComponentType.ROW_SYNC:
                continue
            # a filter is any non-row-preserving row-sync activity with a
            # declared read set (it drops rows, never adds columns)
            if comp.row_preserving:
                continue
            if comp.consumed_columns() is None:
                if comp.produced_columns() == frozenset():
                    # a would-be commute candidate silently disabled by an
                    # opaque predicate — exactly what the DSL eliminates
                    self._refuse("filter-commute",
                                 f"filter {name!r} has an undeclared read "
                                 f"set — no commute considered")
                continue
            preds = flow.pred(name)
            if len(preds) != 1:
                continue
            up = preds[0]
            ok, why = self.can_commute(up, name)
            if not ok:
                self._refuse("filter-commute", f"{name} over {up}: {why}")
                continue
            s_f = self.stats.get(name)
            s_u = self.stats.get(up)
            if s_f is None or s_u is None:
                continue            # no measurements: keep the flow as given
            if s_f.selectivity > COMMUTE_SELECTIVITY_MAX:
                continue            # filter observed to drop ~nothing
            # benefit: the hopped component stops processing dropped rows
            saved = (1.0 - s_f.selectivity) * s_u.rows_in * s_u.per_row_time
            if saved <= 0:
                continue
            flow.swap_adjacent(up, name)
            self.rewrites.append(Rewrite(
                "filter-commute",
                f"{name} ahead of {up} "
                f"(selectivity={s_f.selectivity:.3f}, "
                f"saves~{saved * 1e3:.2f}ms)"))
            return True
        return False

    # ------------------------------------------ rule 2: expression fusion
    def can_fuse(self, a: str, b: str) -> Tuple[bool, str]:
        from ..etl.components import Expression, FusedExpression
        flow = self.flow
        ca, cb = flow.component(a), flow.component(b)
        if not isinstance(ca, (Expression, FusedExpression)) or \
                not isinstance(cb, (Expression, FusedExpression)):
            return False, "both components must be Expressions"
        if not _is_chain_edge(flow, a, b):
            return False, "not a simple chain segment"
        if ca.order_sensitive or cb.order_sensitive:
            return False, "order-sensitive neighbour"
        if ca.tree_boundary or cb.tree_boundary:
            return False, "explicit stage cut between expressions"
        return True, ""

    def _fuse_expressions(self) -> bool:
        from ..etl.components import FusedExpression
        flow = self.flow
        for (a, b) in list(flow.edges):
            if a not in flow.vertices or b not in flow.vertices:
                continue
            ok, _ = self.can_fuse(a, b)
            if not ok:
                continue
            ca, cb = flow.component(a), flow.component(b)
            fused = FusedExpression.fuse(ca, cb)
            # splice pred(a) -> fused -> succ(b) IN PLACE: edge positions
            # carry per-port routing order for fan-out predecessors and
            # successors, so each rewired edge keeps its slot
            p = flow.pred(a)[0] if flow.pred(a) else None
            flow.vertices.pop(a)
            flow.vertices.pop(b)
            flow.vertices[fused.name] = fused
            new_edges = []
            for e in flow.edges:
                if e == (p, a):
                    new_edges.append((p, fused.name))
                elif e == (a, b):
                    continue
                elif e[0] == b:
                    new_edges.append((fused.name, e[1]))
                else:
                    new_edges.append(e)
            flow.edges = new_edges
            flow._reindex()
            self.rewrites.append(Rewrite(
                "fuse-expressions", f"{a} + {b} -> {fused.name}"))
            return True
        return False

    # ------------------------------- rule 3: stage-boundary insert/remove
    def can_cut(self, u: str, v: str) -> Tuple[bool, str]:
        """Row-safety of inserting a StageBoundary on edge u -> v."""
        flow = self.flow
        if (u, v) not in flow.edges:
            return False, "no such edge"
        cu, cv = flow.component(u), flow.component(v)
        if cu.ctype not in (ComponentType.ROW_SYNC,):
            return False, f"{u!r} is {cu.ctype.value}; cut only after row-sync"
        if cu.tree_boundary:
            return False, f"{u!r} is already a stage cut"
        if cv.ctype.roots_tree or cv.tree_boundary:
            return False, f"{v!r} already roots a tree — cut is redundant"
        if cv.ctype == ComponentType.SINK and flow.in_degree(v) > 1:
            return False, "shared sink"
        if _chunk_sensitive_sources(flow):
            # a chunk-sensitive source's calibration prefix used different
            # chunk boundaries than the real run will — the byte statistics
            # driving this cut are not representative
            return False, "chunk-sensitive source"
        # streamable_tree_ids needs the downstream members order-insensitive
        down = self._downstream_members(v)
        if any(flow.component(n).order_sensitive for n in down):
            return False, "order-sensitive downstream member"
        return True, ""

    def _downstream_members(self, start: str) -> List[str]:
        """Row-sync members reachable from ``start`` without crossing a
        tree-rooting component (the would-be streamed tree)."""
        out, frontier = [], [start]
        seen = set()
        while frontier:
            n = frontier.pop()
            if n in seen:
                continue
            seen.add(n)
            c = self.flow.component(n)
            if c.ctype.roots_tree or (c.tree_boundary and n != start):
                continue
            out.append(n)
            frontier.extend(self.flow.succ(n))
        return out

    def _boundary_rules(self) -> bool:
        return self._remove_boundary() or (self.streaming
                                           and self._insert_boundary())

    def _remove_boundary(self) -> bool:
        flow = self.flow
        for name in list(flow.vertices):
            comp = flow.vertices.get(name)
            if comp is None or not comp.tree_boundary:
                continue
            if flow.in_degree(name) != 1 or flow.out_degree(name) != 1:
                continue
            up = flow.pred(name)[0]
            s_up = self.stats.get(up)
            if s_up is None:
                continue
            if s_up.out_bytes >= self.min_stream_bytes and self.streaming:
                continue            # the cut still pays for itself
            flow.remove_passthrough(name)
            self.rewrites.append(Rewrite(
                "remove-boundary",
                f"{name} (observed {s_up.out_bytes / 1e6:.2f}MB "
                f"< {self.min_stream_bytes / 1e6:.1f}MB threshold"
                + ("" if self.streaming else "; streaming off") + ")"))
            return True
        return False

    def _insert_boundary(self) -> bool:
        """Insert the single most profitable cut: the edge where overlapping
        the two stages under the streaming executor buys the most, net of
        the per-split copy cost.  Capped at ``max_boundary_inserts`` per
        round — the overlap gain of chained cuts does not compose."""
        from .component import StageBoundary
        flow = self.flow
        if self._inserted >= self.max_boundary_inserts:
            return False
        best = None          # (net_gain, u, v)
        for (u, v) in flow.edges:
            ok, _ = self.can_cut(u, v)
            if not ok:
                continue
            if not _is_chain_edge(flow, u, v):
                continue
            s_u = self.stats.get(u)
            if s_u is None or s_u.out_bytes < self.min_stream_bytes:
                continue
            t_up = self._upstream_time(u)
            t_down = self._downstream_time(v)
            overlap = min(t_up, t_down)
            copy_cost = s_u.out_bytes * self.copy_seconds_per_byte
            net = overlap - copy_cost
            if net > 0 and (best is None or net > best[0]):
                best = (net, u, v)
        if best is None:
            return False
        _, u, v = best
        cut_name = f"autocut_{u}"
        if cut_name in flow.vertices:
            return False
        flow.insert_between(u, v, StageBoundary(cut_name))
        self._inserted += 1
        self.rewrites.append(Rewrite(
            "insert-boundary",
            f"{cut_name} on {u} -> {v} (net~{best[0] * 1e3:.2f}ms)"))
        return True

    def _upstream_time(self, end: str) -> float:
        """Total observed busy time of ``end`` and everything upstream of it
        inside the same would-be stage."""
        total, frontier, seen = 0.0, [end], set()
        while frontier:
            n = frontier.pop()
            if n in seen:
                continue
            seen.add(n)
            s = self.stats.get(n)
            if s is not None:
                total += s.busy_time
            frontier.extend(self.flow.pred(n))
        return total

    def _downstream_time(self, start: str) -> float:
        total, frontier, seen = 0.0, [start], set()
        while frontier:
            n = frontier.pop()
            if n in seen:
                continue
            seen.add(n)
            s = self.stats.get(n)
            if s is not None:
                total += s.busy_time
            frontier.extend(self.flow.succ(n))
        return total


# ---------------------------------------------------------------------------
#  Re-planning from measurements
# ---------------------------------------------------------------------------
def measured_edge_bytes(flow: Dataflow, g_tau: ExecutionTreeGraph,
                        stats: FlowStatistics) -> Dict[Tuple[int, int], int]:
    """Observed bytes crossing each inter-tree edge of the (possibly
    rewritten) flow: the sum of the measured output bytes of the dataflow
    edges feeding the transition.  Components the statistics have never seen
    (e.g. a freshly inserted StageBoundary) inherit their predecessor's
    observation."""
    def observed_out(name: str) -> int:
        seen = set()
        while name not in seen:
            seen.add(name)
            s = stats.get(name)
            if s is not None and s.calls > 0:
                return s.out_bytes
            preds = flow.pred(name)
            if len(preds) != 1:
                break
            name = preds[0]
        return 0

    out: Dict[Tuple[int, int], int] = {}
    for (u, v) in flow.edges:
        a = g_tau.tree_of.get(u)
        b = g_tau.tree_of.get(v)
        if a is None or b is None or a == b:
            continue
        out[(a, b)] = out.get((a, b), 0) + observed_out(u)
    # edges with no dataflow observation at all fall back to zero and the
    # planner's floor of depth >= 1 still applies
    for e in g_tau.edges:
        out.setdefault(e, 0)
    return out


def suggest_pipeline_degree(stats: FlowStatistics, num_splits: int,
                            cores: Optional[int] = None) -> int:
    """Algorithm 3 over MEASURED activity times: build the cost-model plan
    from the calibration statistics and pick a practical degree, capped at
    the split count (more in-flight splits than splits is meaningless)."""
    times = {n: s.busy_time for n, s in stats.components.items()
             if s.busy_time > 0 and s.calls > 0}
    if not times or stats.sample_rows <= 0:
        return max(1, num_splits)
    # FlowStatistics.busy_time is ALREADY extrapolated to the full input, so
    # build_plan must not scale again: hand it sample_rows == full_rows.
    rows = max(int(stats.sample_rows * stats.scale), 1)
    # per-call busy of the cheapest activity approximates the per-activity
    # miscellaneous time t0 (we have no zero-row run during a live rewrite);
    # per-CALL overhead does not grow with the input, so unscale it
    t0_est = min(s.busy_time / max(s.calls, 1)
                 for s in stats.components.values()
                 if s.calls > 0 and s.busy_time > 0) / max(stats.scale, 1e-9)
    plan = build_plan(times, misc_total=t0_est * len(times),
                      sample_rows=rows, full_rows=rows,
                      m_prime=max(1, num_splits))
    cores = cores if cores is not None else (os.cpu_count() or 1)
    return max(1, min(choose_degree(plan, cores=cores), num_splits))
