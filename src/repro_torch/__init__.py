"""repro_torch — the PyTorch/CUDA port of ``repro``, the ETL dataflow
framework of "Optimizing ETL Dataflow Using Shared Caching and
Parallelization Methods", for one NVIDIA H100.

The operator backend ``"torch"`` keeps device columns on the card and runs
the hash-probe, radix-groupby and segment-sum kernels written in CUDA
(``csrc/``); ``"torch_cpu"`` is the same backend pinned to the CPU, running
the kernels' plain torch versions (the CPU tests use it).  ``"numpy"`` is
the host reference.

    from repro_torch.core import OptimizedEngine, OptimizeOptions
    from repro_torch.etl import build_q4, generate
    q = build_q4(generate(lineorder_rows=100_000))
    OptimizedEngine(q.flow, OptimizeOptions(backend="torch",
                                            fuse_segments=True)).run()
    q.sink.result()
"""
from .core.config import snapshot as config_snapshot
from .core.expr import Col, Expr, Lit, col, lit, where

__all__ = ["Col", "Expr", "Lit", "col", "config_snapshot", "lit", "where"]
