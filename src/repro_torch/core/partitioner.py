"""Algorithm 1 — partition a dataflow graph G into an execution-tree graph G_tau.

Definition 2: an execution tree T(V', E') is a subgraph of G whose root has
in-degree 0 *within the tree*; vertices with out-degree 0 are leaves.  Block
and semi-block components always ROOT a new tree, because they must
accumulate rows in their own cache before processing (paper §3/§4.1);
everything row-synchronized streams inside its parent's tree on a shared
cache.  Extension: a component with ``tree_boundary`` set (StageBoundary)
also roots a new tree even though it is row-synchronized — an explicit stage
cut that the streaming executor pipes splits across as they arrive.

Faithfulness note: the paper's pseudocode recurses `DFS(G, G_tau, u, T)` even
after rooting a new tree T' at u (line 17-21).  Taken literally that would
attach u's row-synchronized descendants to the OLD tree, contradicting
Figure 6 (e.g. `sort` streams inside T_2 rooted at the `sum` aggregator).  We
recurse with T' for block/semi-block u — the behaviour Figure 6 depicts — and
test exactly that shape in tests/test_core_partitioner.py.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from .component import Component, ComponentType
from .graph import Dataflow


class ExecutionTree:
    """One partition: a root plus its streamed (row-sync / sink) descendants."""

    def __init__(self, tree_id: int, root: str):
        self.tree_id = tree_id
        self.root = root
        self.members: List[str] = [root]       # topo-ordered within the tree
        self.edges: List[Tuple[str, str]] = [] # intra-tree edges

    def add_member(self, u: str, parent: str) -> None:
        self.members.append(u)
        self.edges.append((parent, u))

    def activities(self, flow: Dataflow) -> List[Component]:
        return [flow.component(n) for n in self.members]

    def __repr__(self) -> str:
        return f"ExecutionTree(#{self.tree_id}, root={self.root!r}, members={self.members})"


class ExecutionTreeGraph:
    """G_tau(V_tau, E_tau): vertices are execution trees, edges are the
    tree->tree transitions that require a COPY (paper §4.1)."""

    def __init__(self, flow: Dataflow):
        self.flow = flow
        self.trees: List[ExecutionTree] = []
        self.edges: List[Tuple[int, int]] = []        # (tree_id, tree_id)
        self.tree_of: Dict[str, int] = {}             # component -> tree_id

    def new_tree(self, root: str) -> ExecutionTree:
        t = ExecutionTree(len(self.trees), root)
        self.trees.append(t)
        self.tree_of[root] = t.tree_id
        return t

    def add_edge(self, src_tree: int, dst_tree: int) -> None:
        e = (src_tree, dst_tree)
        if e not in self.edges:
            self.edges.append(e)

    def tree(self, tid: int) -> ExecutionTree:
        return self.trees[tid]

    def topo_tree_order(self) -> List[int]:
        indeg = {t.tree_id: 0 for t in self.trees}
        for a, b in self.edges:
            indeg[b] += 1
        ready = sorted([t for t, d in indeg.items() if d == 0])
        order: List[int] = []
        while ready:
            t = ready.pop(0)
            order.append(t)
            for a, b in self.edges:
                if a == t:
                    indeg[b] -= 1
                    if indeg[b] == 0:
                        ready.append(b)
        if len(order) != len(self.trees):
            raise ValueError("execution-tree graph has a cycle")
        return order

    def upstream_trees(self, tid: int) -> List[int]:
        return [a for a, b in self.edges if b == tid]

    def __repr__(self) -> str:
        return f"ExecutionTreeGraph(|V_tau|={len(self.trees)}, E_tau={self.edges})"


def streamable_tree_ids(flow: Dataflow, g_tau: ExecutionTreeGraph) -> set:
    """Trees whose input splits may be consumed AS THEY ARRIVE by the
    streaming executor: the root streams (row-sync / sink — an explicit
    stage boundary, not a source and not block/semi-block), exactly one
    cross-tree dataflow edge feeds the tree and it targets the root (unique,
    consecutive split indices), and no member is ``order_sensitive`` —
    arrival order is arbitrary, and an order-sensitive activity fed out of
    order could fill the admission gate with later splits and stall."""
    out = set()
    for tree in g_tau.trees:
        root = flow.component(tree.root)
        if root.ctype.roots_tree or flow.in_degree(tree.root) == 0:
            continue
        inbound = [(u, v) for (u, v) in flow.edges
                   if g_tau.tree_of.get(u) != tree.tree_id
                   and g_tau.tree_of.get(v) == tree.tree_id]
        if len(inbound) != 1 or inbound[0][1] != tree.root:
            continue
        if any(flow.component(n).order_sensitive for n in tree.members):
            continue
        out.add(tree.tree_id)
    return out


def partition(flow: Dataflow) -> ExecutionTreeGraph:
    """Algorithm 1.  DFS from every in-degree-0 vertex; block/semi-block
    vertices root new trees; row-synchronized vertices join the current tree.

    A semi-block component reachable from several trees gets ONE tree (rooted
    at itself) with an inter-tree edge from each upstream tree.
    """
    flow.validate()
    g_tau = ExecutionTreeGraph(flow)
    visited: Dict[str, bool] = {n: False for n in flow.vertices}

    def dfs(v: str, tree: ExecutionTree) -> None:
        visited[v] = True
        for u in flow.succ(v):
            u_comp = flow.component(u)
            u_type = u_comp.ctype
            if not (u_type.roots_tree or u_comp.tree_boundary):
                # row-synchronized (or sink): joins the current tree
                if not visited[u]:
                    tree.add_member(u, parent=v)
                    g_tau.tree_of[u] = tree.tree_id
                    dfs(u, tree)
                else:
                    # already a member of SOME tree. Intra-tree diamond joins
                    # are excluded by validation (in-degree>1 => semi-block),
                    # so this can only happen across trees; record the edge.
                    g_tau.add_edge(tree.tree_id, g_tau.tree_of[u])
            else:
                # block/semi-block (or an explicit stage boundary): roots a
                # new execution tree
                if not visited[u]:
                    visited[u] = True
                    t_new = g_tau.new_tree(u)
                    g_tau.add_edge(tree.tree_id, t_new.tree_id)
                    dfs(u, t_new)            # paper typo fixed: recurse with T'
                else:
                    g_tau.add_edge(tree.tree_id, g_tau.tree_of[u])

    for v in flow.topo_order():
        if flow.in_degree(v) == 0 and not visited[v]:
            visited[v] = True
            tree = g_tau.new_tree(v)
            dfs(v, tree)
    return g_tau
