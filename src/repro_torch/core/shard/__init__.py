"""Sharded execution subsystem.

One process behind the GIL caps the framework's parallelism; this package
scales a dataflow ACROSS shards while keeping every sink's keys, row order
and dtypes identical to the serial route:

  ShardPlanner   hash/range-partitions the source rows over N shards
                 (``planner.plan_shards`` — N chosen from the same
                 signals ``plan_runtime`` uses for pipeline degree)
  shard workers  run the FULL per-shard flow: in-process passes
                 (``inline``), spawned worker processes shipping a
                 picklable flow spec (``process``), or inline passes whose
                 Aggregate partials merge on the backend's device
                 (``mesh``) — selected by ``REPRO_SHARD_IMPL`` /
                 OptimizeOptions
  partial→shuffle→merge
                 block/semi-block cut components stash per-shard partials
                 (Aggregate reuses the serving ``(sum,count)`` partial
                 machinery) and a single coordinator merge pass combines
                 them into the exact serial result (``merge.py``)

The runtime composes with the existing layers: ``OptimizedEngine.run``
drives it under the run's ``cache_stats_scope``/Tracer (per-shard scopes
and shard-tagged Perfetto pids merge into one ``EngineRun``), and
``faults.py`` chunk/edge retries escalate to whole-shard replay from the
shard's source snapshot instead of aborting the run.
"""
from .merge import ShardContext
from .partitioner import hash_shard_ids, range_bounds, shard_tables
from .planner import ShardPlan, choose_shards, plan_shards
from .runtime import ShardResult, ShardRunner

__all__ = [
    "ShardContext", "ShardPlan", "ShardResult", "ShardRunner",
    "choose_shards", "hash_shard_ids", "plan_shards", "range_bounds",
    "shard_tables",
]
