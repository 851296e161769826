"""Dataflow DAG — Definition 1: G(V, E), V = activities over row sets,
E = logical transitions."""
from __future__ import annotations

from typing import Dict, Iterable, List, Optional, Sequence, Tuple

from .component import Component, ComponentType


class Dataflow:
    """A directed acyclic graph of components."""

    def __init__(self, name: str = "dataflow"):
        self.name = name
        self.vertices: Dict[str, Component] = {}
        self.edges: List[Tuple[str, str]] = []
        self._succ: Dict[str, List[str]] = {}
        self._pred: Dict[str, List[str]] = {}

    # ------------------------------------------------------------- building
    def add(self, comp: Component) -> Component:
        if comp.name in self.vertices:
            raise ValueError(f"duplicate component name {comp.name!r}")
        self.vertices[comp.name] = comp
        self._succ[comp.name] = []
        self._pred[comp.name] = []
        return comp

    def connect(self, u, v) -> None:
        """Add edge u -> v.  Accepts names or components."""
        un = u if isinstance(u, str) else u.name
        vn = v if isinstance(v, str) else v.name
        for n in (un, vn):
            if n not in self.vertices:
                raise KeyError(f"unknown component {n!r}")
        self.edges.append((un, vn))
        self._succ[un].append(vn)
        self._pred[vn].append(un)

    def chain(self, *comps) -> None:
        """Convenience: add (if needed) and connect comps in sequence."""
        prev = None
        for c in comps:
            if (c.name if isinstance(c, Component) else c) not in self.vertices:
                self.add(c)
            if prev is not None:
                self.connect(prev, c)
            prev = c

    # ------------------------------------------------------------- surgery
    #
    # In-place graph rewriting used by the cost-based optimizer
    # (core/optimizer.py).  Every method keeps the edge list and the
    # succ/pred indices consistent by rebuilding the indices from the edge
    # list — surgery is rare (a handful per run) so clarity wins over
    # incremental updates.
    def _reindex(self) -> None:
        self._succ = {n: [] for n in self.vertices}
        self._pred = {n: [] for n in self.vertices}
        for u, v in self.edges:
            self._succ[u].append(v)
            self._pred[v].append(u)

    def insert_between(self, u: str, v: str, comp: Component) -> Component:
        """Splice ``comp`` onto the edge u -> v (u -> comp -> v)."""
        if (u, v) not in self.edges:
            raise KeyError(f"no edge {u!r} -> {v!r}")
        self.add(comp)
        self.edges[self.edges.index((u, v))] = (u, comp.name)
        self.edges.append((comp.name, v))
        self._reindex()
        return comp

    def remove_passthrough(self, name: str) -> Component:
        """Remove a single-in / single-out component, reconnecting its
        predecessor directly to its successor."""
        if self.in_degree(name) != 1 or self.out_degree(name) != 1:
            raise ValueError(
                f"remove_passthrough({name!r}): needs in-degree 1 and "
                f"out-degree 1, got {self.in_degree(name)}/{self.out_degree(name)}")
        p, s = self._pred[name][0], self._succ[name][0]
        comp = self.vertices.pop(name)
        # splice IN PLACE: a predecessor's successor ORDER is semantic (the
        # pipeline routes splitter output ports positionally), so the
        # reconnect edge must take the removed edge's position, not be
        # appended after p's other outbound edges
        self.edges[self.edges.index((p, name))] = (p, s)
        self.edges.remove((name, s))
        self._reindex()
        return comp

    def collapse_chain(self, names: Sequence[str], comp: Component) -> Component:
        """Replace a simple chain ``names[0] -> ... -> names[-1]`` with the
        single component ``comp`` (segment fusion).  Every link must be a
        simple chain edge (out-degree 1 into in-degree 1); the head keeps its
        single inbound edge's position and the tail's outbound edges keep
        their slots (successor order is semantic for per-port routing)."""
        names = list(names)
        if len(names) < 2:
            raise ValueError("collapse_chain: need at least two components")
        for a, b in zip(names, names[1:]):
            if (a, b) not in self.edges:
                raise KeyError(f"no edge {a!r} -> {b!r}")
            if self.out_degree(a) != 1 or self.in_degree(b) != 1:
                raise ValueError(
                    f"collapse_chain: {a!r} -> {b!r} is not a simple chain "
                    f"segment")
        head, tail = names[0], names[-1]
        chain = set(names)
        for n in names:
            self.vertices.pop(n)
        self.vertices[comp.name] = comp
        new_edges = []
        for (a, b) in self.edges:
            if a in chain and b in chain:
                continue
            elif b == head:
                new_edges.append((a, comp.name))
            elif a == tail:
                new_edges.append((comp.name, b))
            else:
                new_edges.append((a, b))
        self.edges = new_edges
        self._reindex()
        return comp

    def swap_adjacent(self, u: str, v: str) -> None:
        """Swap two chained components: ... -> u -> v -> ... becomes
        ... -> v -> u -> ... .  Requires the pair to form a simple chain
        segment (edge u->v, out-degree(u) == 1, in-degree(v) == 1); the
        caller (optimizer) is responsible for SEMANTIC safety."""
        if (u, v) not in self.edges:
            raise KeyError(f"no edge {u!r} -> {v!r}")
        if self.out_degree(u) != 1 or self.in_degree(v) != 1:
            raise ValueError(
                f"swap_adjacent({u!r}, {v!r}): not a simple chain segment")
        new_edges = []
        for (a, b) in self.edges:
            if (a, b) == (u, v):
                new_edges.append((v, u))
            else:
                # redirect u's inbound edges to v, v's outbound edges to u
                a2 = u if a == v else a
                b2 = v if b == u else b
                new_edges.append((a2, b2))
        self.edges = new_edges
        self._reindex()

    # ------------------------------------------------------------- queries
    def succ(self, name: str) -> List[str]:
        return self._succ[name]

    def pred(self, name: str) -> List[str]:
        return self._pred[name]

    def in_degree(self, name: str) -> int:
        return len(self._pred[name])

    def out_degree(self, name: str) -> int:
        return len(self._succ[name])

    def sources(self) -> List[str]:
        return [n for n in self.vertices if self.in_degree(n) == 0]

    def sinks(self) -> List[str]:
        return [n for n in self.vertices if self.out_degree(n) == 0]

    def component(self, name: str) -> Component:
        return self.vertices[name]

    # ---------------------------------------------------------- validation
    def topo_order(self) -> List[str]:
        indeg = {n: self.in_degree(n) for n in self.vertices}
        ready = sorted([n for n, d in indeg.items() if d == 0])
        order: List[str] = []
        ready_set = list(ready)
        while ready_set:
            n = ready_set.pop(0)
            order.append(n)
            for s in self._succ[n]:
                indeg[s] -= 1
                if indeg[s] == 0:
                    ready_set.append(s)
        if len(order) != len(self.vertices):
            raise ValueError(f"dataflow {self.name!r} has a cycle")
        return order

    def validate(self) -> None:
        self.topo_order()  # acyclicity
        for n, comp in self.vertices.items():
            d_in, d_out = self.in_degree(n), self.out_degree(n)
            t = comp.ctype
            if t == ComponentType.SOURCE and d_in != 0:
                raise ValueError(f"source {n!r} has incoming edges")
            if d_in > 1 and t not in (ComponentType.SEMI_BLOCK, ComponentType.SINK):
                raise ValueError(
                    f"{n!r} ({t.value}) has in-degree {d_in}; only semi-block "
                    f"components may merge multiple upstreams (paper §3)")
            if t == ComponentType.BLOCK and d_in > 1:
                raise ValueError(f"block component {n!r} must have a single upstream")
            if t == ComponentType.SINK and d_out != 0:
                raise ValueError(f"sink {n!r} has outgoing edges")
            if d_in == 0 and t not in (ComponentType.SOURCE,):
                raise ValueError(f"{n!r} has in-degree 0 but is not a source")

    def reset_stats(self) -> None:
        for c in self.vertices.values():
            c.reset_stats()

    def __len__(self) -> int:
        return len(self.vertices)

    def __repr__(self) -> str:
        return (f"Dataflow({self.name!r}, |V|={len(self.vertices)}, "
                f"|E|={len(self.edges)})")
