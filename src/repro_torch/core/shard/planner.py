"""ShardPlanner: decide whether / how to shard a run.

``plan_shards`` is the single entry point the engine calls.  It either
returns a ``ShardPlan`` (shard count, partitioning mode + key, resolved
impl route, the flow's cut components) or ``None`` for the serial path —
recording a ``shard_plan`` degradation when sharding was requested but the
flow cannot support it, so the fallback is observable rather than silent.

The auto shard count (``shards=0`` / ``REPRO_SHARDS=0``) mirrors how
``plan_runtime`` picks pipeline degree: bounded by the hardware core
count and the split count, and by a minimum rows-per-shard floor so tiny
inputs never pay multi-pass overhead for nothing.
"""
from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Set, Tuple

import numpy as np

from .. import config, faults
from ..component import ComponentType

#: below this many rows per shard, extra shards cost more than they win
MIN_SHARD_ROWS = 4096
#: auto mode never picks more than this many shards
MAX_AUTO_SHARDS = 8


@dataclass
class ShardPlan:
    """One sharded run's layout, as chosen by ``plan_shards``."""
    shards: int
    impl: str                              # resolved: process | mesh | inline
    mode: str                              # "range" | "hash"
    key: Tuple[str, ...] = ()              # hash key columns (mode == "hash")
    sources: List[str] = field(default_factory=list)
    cuts: List[str] = field(default_factory=list)

    def spec(self) -> Dict[str, object]:
        return {"shards": self.shards, "impl": self.impl, "mode": self.mode,
                "key": list(self.key), "sources": list(self.sources),
                "cuts": list(self.cuts)}


def choose_shards(total_rows: int, num_splits: int,
                  cores: Optional[int] = None) -> int:
    """Auto shard count — same shape as ``planner.choose_degree``: capped
    by hardware parallelism and by the split count (more shards than
    splits just idles), with a rows-per-shard floor."""
    hw = cores if cores is not None else (os.cpu_count() or 1)
    by_rows = max(1, total_rows // MIN_SHARD_ROWS)
    return max(1, min(hw, max(num_splits, 1), by_rows, MAX_AUTO_SHARDS))


def _degrade(requested: int, reason: str, component=None) -> None:
    faults.record_degradation("shard_plan", f"shards={requested}", "serial",
                              component=component)
    _ = reason        # reasons surface via the degradation component field


def _first_contact(flow) -> Tuple[Set[str], bool]:
    """Walk from every source through row-synchronized components only.
    Returns (cut components reached first, whether any sink is reachable
    without crossing a cut)."""
    firsts: Set[str] = set()
    sink_direct = False
    seen: Set[str] = set()
    stack = list(flow.sources())
    while stack:
        name = stack.pop()
        if name in seen:
            continue
        seen.add(name)
        for succ in flow.succ(name):
            comp = flow.component(succ)
            if comp.ctype.roots_tree:
                firsts.add(succ)
            elif comp.ctype is ComponentType.SINK:
                sink_direct = True
            else:
                stack.append(succ)
    return firsts, sink_direct


def _pick_mode(flow, sources: List[str]) -> Tuple[str, Tuple[str, ...]]:
    """``hash`` when every source→sink path first meets an Aggregate keyed
    on integer source columns (all first-layer aggregates sharing one key
    set) — then shards are group-disjoint and even float partials merge
    exactly.  Everything else takes ``range``, whose shard-order reassembly
    preserves serial row order."""
    firsts, sink_direct = _first_contact(flow)
    if sink_direct or not firsts:
        return "range", ()
    keys: Set[Tuple[str, ...]] = set()
    for name in firsts:
        comp = flow.component(name)
        if not (hasattr(comp, "shard_partial") and hasattr(comp, "group_by")):
            return "range", ()
        if not comp.group_by:
            return "range", ()       # global aggregate: nothing to key on
        keys.add(tuple(comp.group_by))
    if len(keys) != 1:
        return "range", ()
    key = keys.pop()
    for sname in sources:
        cols = flow.component(sname).columns
        for k in key:
            col = cols.get(k)
            if col is None or np.asarray(col).dtype.kind not in "iub":
                return "range", ()
    return "hash", key


def plan_shards(flow, g_tau, requested: int, impl: str, opts,
                backend) -> Optional[ShardPlan]:
    """Decide the shard layout for one run, or ``None`` for serial.

    ``requested`` is the resolved shard count (0 = auto); ``impl`` the
    requested route (``auto`` resolves here: ``mesh`` on the accelerated
    backends, ``torch`` and ``torch_cpu``, ``inline`` on ``numpy`` —
    ``process`` only when asked for, since spawning workers is a policy
    choice, not a default)."""
    if requested == 1:
        return None
    if impl not in config.SHARD_IMPLS:
        raise ValueError(f"unknown shard impl {impl!r}; "
                         f"expected one of {config.SHARD_IMPLS}")
    sources = list(flow.sources())
    if not sources:
        _degrade(requested, "no sources")
        return None
    for sname in sources:
        comp = flow.component(sname)
        if not (hasattr(comp, "set_data") and hasattr(comp, "total_rows")
                and hasattr(comp, "columns")):
            _degrade(requested, "unshardable source", component=sname)
            return None
        if getattr(comp, "chunk_sensitive", False):
            _degrade(requested, "chunk-sensitive source", component=sname)
            return None
    for sink in flow.sinks():
        comp = flow.component(sink)
        if not (hasattr(comp, "drain") and hasattr(comp, "clear")):
            _degrade(requested, "unshardable sink", component=sink)
            return None
        trees = {g_tau.tree_of[p] for p in flow.pred(sink)}
        trees.add(g_tau.tree_of[sink])
        if len(trees) > 1:
            # a sink shared across trees interleaves shard-pass and
            # merge-pass rows; the reassembly rule has no serial order for
            # that, so it stays on the serial path
            _degrade(requested, "cross-tree sink", component=sink)
            return None
    total_rows = sum(flow.component(s).total_rows() for s in sources)
    n = requested
    if n == 0:
        n = choose_shards(total_rows, opts.num_splits, cores=opts.cores)
    if n <= 1:
        return None
    if impl == "auto":
        impl = ("mesh" if getattr(backend, "name", "").startswith("torch")
                else "inline")
    mode, key = _pick_mode(flow, sources)
    cuts = [t.root for t in g_tau.trees
            if flow.component(t.root).ctype.roots_tree]
    return ShardPlan(shards=n, impl=impl, mode=mode, key=key,
                     sources=sources, cuts=cuts)
