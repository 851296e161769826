"""Row partitioning for sharded execution.

Two schemes, chosen by the planner:

``range``  contiguous even slices (the same ``linspace`` arithmetic
           ``SharedCache.split`` uses) — always correct, because shard
           passes replay in shard order and the merge pass reassembles
           per-tree deliveries in (shard, split) order, restoring the
           serial row order exactly.
``hash``   rows scattered by a splitmix64 hash of the group-key columns
           (DOD-ETL's scheme) — group-disjoint shards, so keyed partials
           never meet across shards; the planner only picks it when every
           source→sink path runs through a first-layer Aggregate keyed on
           source columns (downstream of which row order is canonical).
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np

Table = Dict[str, np.ndarray]


def range_bounds(n_rows: int, shards: int) -> np.ndarray:
    """Shard boundary offsets ``[b0..bN]`` — even contiguous slices, same
    arithmetic as ``SharedCache.split`` so shard sizes match split sizes."""
    if shards < 1:
        raise ValueError(f"shards must be >= 1, got {shards}")
    return np.linspace(0, n_rows, shards + 1).astype(int)


def _splitmix64(x: np.ndarray) -> np.ndarray:
    """Vectorized splitmix64 finalizer (wrapping uint64 arithmetic)."""
    with np.errstate(over="ignore"):
        x = x + np.uint64(0x9E3779B97F4A7C15)
        x = (x ^ (x >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
        x = (x ^ (x >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
        return x ^ (x >> np.uint64(31))


def hash_shard_ids(key_cols: Sequence[np.ndarray], shards: int) -> np.ndarray:
    """Shard id per row from the hash of the key column tuple.  Chained
    per-column splitmix64 mixing, so (a, b) and (b, a) land differently."""
    if not key_cols:
        raise ValueError("hash partitioning needs at least one key column")
    n = len(key_cols[0])
    h = np.zeros(n, dtype=np.uint64)
    for c in key_cols:
        h = _splitmix64(h ^ np.asarray(c).astype(np.uint64, copy=False))
    return (h % np.uint64(shards)).astype(np.int64)


def shard_tables(tables: Dict[str, Table], shards: int, mode: str,
                 key: Tuple[str, ...] = ()) -> List[Dict[str, Table]]:
    """Partition every source table into per-shard tables.

    Returns one ``{source_name: {col: rows}}`` dict per shard.  Range mode
    slices each source independently into contiguous views; hash mode
    scatters by ``key`` with ``np.flatnonzero`` index takes, which preserve
    each shard's rows in original relative order (exactness of per-group
    accumulation does not depend on cross-shard order)."""
    out: List[Dict[str, Table]] = [dict() for _ in range(shards)]
    for name, table in tables.items():
        n = len(next(iter(table.values()))) if table else 0
        if mode == "range":
            bounds = range_bounds(n, shards)
            for k in range(shards):
                lo, hi = int(bounds[k]), int(bounds[k + 1])
                out[k][name] = {c: v[lo:hi] for c, v in table.items()}
        elif mode == "hash":
            ids = hash_shard_ids([table[c] for c in key], shards)
            for k in range(shards):
                idx = np.flatnonzero(ids == k)
                out[k][name] = {c: np.asarray(v)[idx]
                                for c, v in table.items()}
        else:
            raise ValueError(f"unknown shard mode {mode!r}")
    return out


def table_rows(table: Table) -> int:
    return len(next(iter(table.values()))) if table else 0


def table_bytes(table: Table) -> int:
    return sum(np.asarray(v).nbytes for v in table.values())
