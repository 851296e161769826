"""Partial→shuffle→merge state for sharded runs.

Every block/semi-block tree root (a "cut") gets a ``shard_role`` for the
run's duration and the executor routes its ``finish`` through the shared
``ShardContext`` here:

``partial`` (shard passes)
    Aggregate-like cuts (anything with ``shard_partial``) reduce their
    accumulated input to a keyed partial table — the serving
    ``(sum,count)`` decomposition — and stash it.  Every other
    cut (Sort/Union/Merge/custom) stashes its raw accumulated caches as
    host snapshots tagged ``(pass, src_tree, split)``.  Both return an
    empty schema-shaped cache, so downstream components see the run's
    shape but no rows: no full-table broadcast ever crosses a shard
    boundary, only partials ("shuffle" is the stash hand-off to the
    coordinator).

``merge`` (one final coordinator pass over empty sources)
    Aggregate cuts second-stage-reduce the stashed partials (plus any
    partials from their own final-pass input, for cut-ancestored
    aggregates).  Generic cuts reassemble their serial input: per source
    tree, either the stashed shard rows in (shard, split) order — a
    row-synchronized-fed tree, whose final-pass deliveries are empty — or
    the final-pass deliveries themselves (a cut-ancestored tree, already
    serial-exact).  Split indices are renumbered sequentially so the real
    ``finish`` sees exactly the serial accumulation order.

The merge pass is replayable: stashes are read without being consumed and
reconstructed caches copy the stashed arrays (``finish`` mutates its
input in place), so a transient merge-pass fault just reruns the pass.
"""
from __future__ import annotations

import threading
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..shared_cache import SharedCache

#: (pass_k, src_tree, split_index, host columns, n_rows)
GenericStash = Tuple[int, int, int, Dict[str, np.ndarray], int]


def reduce_partials(cat: Dict[str, np.ndarray], group_names: Sequence[str],
                    ops: Dict[str, str]
                    ) -> Tuple[List[np.ndarray], Dict[str, np.ndarray]]:
    """Host second-stage reduce over concatenated per-shard partial tables.

    Deterministic dtype-preserving numpy (``reduceat`` over a stable
    lexsort): value partials re-reduce with their own op, count partials
    sum — keeping each partial's stage-1 dtype, so e.g. an int64 count
    stays int64 exactly as the serial one-shot reduce emits it."""
    keys = [np.asarray(cat[g]) for g in group_names]
    if not keys:
        out: Dict[str, np.ndarray] = {}
        for p, op in ops.items():
            v = np.asarray(cat[p])
            if op == "sum":
                out[p] = np.array([v.sum()], dtype=v.dtype)
            elif op == "min":
                out[p] = np.array([v.min()], dtype=v.dtype)
            elif op == "max":
                out[p] = np.array([v.max()], dtype=v.dtype)
            else:
                raise ValueError(f"unmergeable second-stage op {op!r}")
        return [], out
    n = len(keys[0])
    order = np.lexsort(keys[::-1])
    sk = [k[order] for k in keys]
    boundary = np.zeros(n, dtype=bool)
    if n:
        boundary[0] = True
    for k in sk:
        boundary[1:] |= k[1:] != k[:-1]
    starts = np.flatnonzero(boundary)
    group_cols = [k[starts] for k in sk]
    part_cols: Dict[str, np.ndarray] = {}
    for p, op in ops.items():
        v = np.asarray(cat[p])[order]
        if op == "sum":
            part_cols[p] = np.add.reduceat(v, starts)
        elif op == "min":
            part_cols[p] = np.minimum.reduceat(v, starts)
        elif op == "max":
            part_cols[p] = np.maximum.reduceat(v, starts)
        else:
            raise ValueError(f"unmergeable second-stage op {op!r}")
    return group_cols, part_cols


class ShardContext:
    """Shared stash + finish-interception for one sharded run.

    Installed on every cut component as ``_shard_ctx`` alongside
    ``shard_role``; cut finishes run on pool threads, so stash mutation is
    lock-guarded.  ``combiner`` is the optional mesh-route second-stage
    reducer (``mesh.make_combiner``) Aggregate cuts merge through."""

    def __init__(self, combiner: Optional[Callable] = None):
        self._lock = threading.Lock()
        self.pass_k: Optional[int] = None        # None => merge pass
        self.combiner = combiner
        #: cut name -> [(pass_k, partial table)]
        self.agg_partials: Dict[str, List[Tuple[int, dict]]] = {}
        #: cut name -> [GenericStash]
        self.generic: Dict[str, List[GenericStash]] = {}
        #: bytes stashed for the coordinator merge (the "shuffle" volume)
        self.shuffle_bytes = 0

    # ------------------------------------------------------------- passes
    def begin_pass(self, k: int) -> None:
        self.pass_k = k

    def begin_merge(self) -> None:
        self.pass_k = None

    def rollback_pass(self, k: int) -> None:
        """Drop everything pass ``k`` stashed — a failed shard replays from
        its source snapshot, and completed shards' stashes stay intact."""
        with self._lock:
            for lst in self.agg_partials.values():
                lst[:] = [e for e in lst if e[0] != k]
            for lst in self.generic.values():
                lst[:] = [e for e in lst if e[0] != k]

    def absorb(self, cut_aggs: Dict[str, List[Tuple[int, dict]]],
               cut_generic: Dict[str, List[GenericStash]]) -> None:
        """Fold a process-route worker's stashes into the coordinator."""
        with self._lock:
            for name, lst in cut_aggs.items():
                self.agg_partials.setdefault(name, []).extend(lst)
                for _, t in lst:
                    self.shuffle_bytes += sum(
                        np.asarray(v).nbytes for v in t.values())
            for name, lst in cut_generic.items():
                self.generic.setdefault(name, []).extend(lst)
                for e in lst:
                    self.shuffle_bytes += sum(
                        np.asarray(v).nbytes for v in e[3].values())

    def export(self) -> Tuple[dict, dict]:
        """The stashes, for shipping from a process-route worker."""
        with self._lock:
            return dict(self.agg_partials), dict(self.generic)

    # ------------------------------------------------------ interception
    def intercept_finish(self, root, state: List[SharedCache],
                         tags: List[Tuple[int, int]]) -> SharedCache:
        """Replacement for ``root.finish(state)`` while ``shard_role`` is
        set.  ``tags`` carries the executor's ``(src_tree, split_index)``
        per accumulated cache, in accumulation order."""
        if root.shard_role == "partial":
            if hasattr(root, "shard_partial"):
                return self._partial_agg(root, state)
            return self._partial_generic(root, state, tags)
        if hasattr(root, "shard_partial"):
            return self._merge_agg(root, state)
        return self._merge_generic(root, state, tags)

    # ---------------------------------------------------------- partials
    def _partial_agg(self, root, state: List[SharedCache]) -> SharedCache:
        part = root.shard_partial(state)          # consumes + recycles state
        if part is not None:
            with self._lock:
                self.agg_partials.setdefault(root.name, []).append(
                    (self.pass_k, part))
                self.shuffle_bytes += sum(
                    np.asarray(v).nbytes for v in part.values())
        return root.shard_empty()

    def _partial_generic(self, root, state: List[SharedCache],
                         tags: List[Tuple[int, int]]) -> SharedCache:
        entries: List[GenericStash] = []
        schema: Optional[Dict[str, np.ndarray]] = None
        for (src, idx), cache in zip(tags, state):
            cols = cache.to_dict()
            if schema is None:
                schema = cols
            entries.append((self.pass_k, src, idx, cols, cache.n))
            cache.recycle()
        with self._lock:
            self.generic.setdefault(root.name, []).extend(entries)
            self.shuffle_bytes += sum(
                np.asarray(v).nbytes
                for (_, _, _, cols, n) in entries if n for v in cols.values())
        if schema is None:
            return SharedCache({}, 0)
        return SharedCache({k: v[:0] for k, v in schema.items()}, 0)

    # ------------------------------------------------------------ merges
    def _merge_agg(self, root, state: List[SharedCache]) -> SharedCache:
        with self._lock:
            stash = sorted(self.agg_partials.get(root.name, []),
                           key=lambda e: e[0])
        return root.shard_merge(state, [t for _, t in stash],
                                combiner=self.combiner)

    def _merge_generic(self, root, state: List[SharedCache],
                       tags: List[Tuple[int, int]]) -> SharedCache:
        with self._lock:
            stash = list(self.generic.get(root.name, []))
        fin: Dict[int, List[Tuple[int, SharedCache]]] = {}
        for (src, idx), cache in zip(tags, state):
            fin.setdefault(src, []).append((idx, cache))
        by_src: Dict[int, List[GenericStash]] = {}
        for e in stash:
            by_src.setdefault(e[1], []).append(e)
        ordered: List[SharedCache] = []
        dropped: List[SharedCache] = []
        split = 0
        for src in sorted(set(by_src) | set(fin)):
            st = sorted(by_src.get(src, []), key=lambda e: (e[0], e[2]))
            fn = sorted(fin.get(src, []), key=lambda e: e[0])
            if any(n for (_, _, _, _, n) in st):
                # row-synchronized-fed tree: the shard passes carried the
                # real rows; the final pass (empty sources) delivered
                # nothing worth keeping
                chosen = st
                dropped.extend(c for _, c in fn)
            elif fn:
                # cut-ancestored tree: the final-pass deliveries ARE the
                # serial input; shard-pass stashes were schema-empties
                for _, cache in fn:
                    cache.split_index = split
                    split += 1
                    ordered.append(cache)
                continue
            else:
                chosen = st       # degenerate all-empty tree: schema reps
            for (_, _, _, cols, n) in chosen:
                # copies, not views: finish() mutates in place and a merge
                # replay must reread pristine stashes
                cache = SharedCache({k: np.array(v) for k, v in cols.items()},
                                    n, split_index=split)
                split += 1
                ordered.append(cache)
        for cache in dropped:
            cache.recycle()
        return root.finish(ordered)
