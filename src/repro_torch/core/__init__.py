# The paper's primary contribution: component classification (§3),
# execution-tree partitioning (Algorithm 1), shared caching scheme (§3),
# pipeline parallelization (Algorithm 2 + Theorem 1), inside-component
# multithreading (§4.3), and the dataflow task planner (§2) — extended with
# a streaming inter-tree executor on one shared worker pool (executor.py).
from . import config
from .backend import (Backend, available_backends, get_backend,
                      get_default_backend, register_backend, resolve_backend,
                      set_default_backend)
from .component import (BlockComponent, Component, ComponentType, FnComponent,
                        SemiBlockComponent, SinkComponent, SourceComponent,
                        StageBoundary)
from .engine import (EngineRun, OptimizedEngine, OptimizeOptions,
                     OrdinaryEngine, ServingEngine, StreamingEngine)
from .executor import (ChannelGroup, ExecutionAborted, RunAbort,
                       SharedWorkerPool, StreamingExecutor, TaskFuture)
from .expr import Col, ColumnsView, Expr, Lit, col, expr_reads, lit, where
from .faults import (Degradation, FaultError, FaultPlan, PermanentFault,
                     PoisonFault, TransientFault, fault_recorder, fault_scope,
                     retry_call, with_retries)
from .graph import Dataflow
from .metadata import MetadataStore
from .optimizer import (ComponentStats, CostBasedOptimizer, FlowStatistics,
                        Refusal, Rewrite, fuse_segments_flow,
                        measured_edge_bytes, run_calibration,
                        suggest_pipeline_degree)
from .partitioner import ExecutionTree, ExecutionTreeGraph, partition
from .pipeline import TreePipeline
from .planner import (PipelinePlan, RuntimePlan, backend_chunk_rows,
                      build_plan, choose_channel_depth, choose_degree,
                      choose_pool_width, discover_segments,
                      estimate_edge_bytes, infer_schema, plan_runtime,
                      theorem1_m_star)
from .scheduler import plan_schedule, run_tree_graph
from .shared_cache import (GLOBAL_ARENA, GLOBAL_CACHE_STATS, CacheArena,
                           CacheStats, SharedCache, cache_stats_scope,
                           concat_caches)
from .simulate import (SimResult, cpu_usage_curve, multithreading_curve,
                       simulate_tree, speedup_curve)

__all__ = [
    "config",
    "Backend", "available_backends", "get_backend", "get_default_backend",
    "register_backend", "resolve_backend", "set_default_backend",
    "BlockComponent", "Component", "ComponentType", "FnComponent",
    "SemiBlockComponent", "SinkComponent", "SourceComponent", "StageBoundary",
    "EngineRun", "OptimizedEngine", "OptimizeOptions", "OrdinaryEngine",
    "ServingEngine", "StreamingEngine",
    "ChannelGroup", "ExecutionAborted", "RunAbort", "SharedWorkerPool",
    "StreamingExecutor", "TaskFuture",
    "Col", "ColumnsView", "Expr", "Lit", "col", "expr_reads", "lit", "where",
    "Degradation", "FaultError", "FaultPlan", "PermanentFault", "PoisonFault",
    "TransientFault", "fault_recorder", "fault_scope", "retry_call",
    "with_retries",
    "Dataflow", "MetadataStore",
    "ComponentStats", "CostBasedOptimizer", "FlowStatistics", "Refusal",
    "Rewrite", "fuse_segments_flow", "measured_edge_bytes", "run_calibration",
    "suggest_pipeline_degree",
    "ExecutionTree", "ExecutionTreeGraph", "partition",
    "TreePipeline",
    "PipelinePlan", "RuntimePlan", "backend_chunk_rows", "build_plan",
    "choose_channel_depth", "choose_degree", "choose_pool_width",
    "discover_segments", "estimate_edge_bytes", "infer_schema",
    "plan_runtime", "theorem1_m_star",
    "plan_schedule", "run_tree_graph",
    "GLOBAL_ARENA", "GLOBAL_CACHE_STATS", "CacheArena", "CacheStats",
    "SharedCache", "cache_stats_scope", "concat_caches",
    "SimResult", "cpu_usage_curve", "multithreading_curve", "simulate_tree",
    "speedup_curve",
]
