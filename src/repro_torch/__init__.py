"""repro_torch — the PyTorch/CUDA port of ``repro``, the ETL dataflow
framework of "Optimizing ETL Dataflow Using Shared Caching and
Parallelization Methods", for one NVIDIA H100.

The operator backend ``"torch"`` keeps device columns on the card and runs
the hash-probe, radix-groupby and segment-sum kernels written in CUDA
(``csrc/``); ``"torch_cpu"`` is the same backend pinned to the CPU, running
the kernels' plain torch versions (the CPU tests use it).  ``"numpy"`` is
the host reference.

The LM side (``configs``, ``models``, ``train.serve_step``,
``launch.serve``) serves the dense and SSM families on the card through the
flash-attention and selective-scan kernels:

    from repro_torch.configs import get_config
    from repro_torch.launch.serve import BatchedServer, make_requests
    cfg = get_config("stablelm-3b")
    BatchedServer(cfg, batch=4).run(make_requests(cfg, 8, 2048, 32))

    import repro_torch
    from repro_torch.etl import build_q4, generate
    q = build_q4(generate(lineorder_rows=100_000))
    res = repro_torch.Session(backend="torch").run(q, engine="streaming",
                                                   fuse=True)
    res.table                    # {column: np.ndarray}

``Session.serve`` keeps a flow resident (worker pool, compiled segments,
device dimension tables) and feeds it micro-batches tick by tick; a flow
ending in an ``Aggregate`` emits upsert deltas (``replay_deltas``).
CPU runs pass ``backend="torch_cpu"``.
"""
from .core.config import snapshot as config_snapshot
from .core.engine import ServingEngine
from .core.expr import Col, Expr, Lit, col, lit, where
from .session import (Flow, FlowBuilder, ServeSession, Session, SessionRun,
                      TickResult, flow, replay_deltas)

__all__ = [
    "Col", "Expr", "Lit", "col", "lit", "where",
    "Flow", "FlowBuilder", "ServeSession", "ServingEngine", "Session",
    "SessionRun", "TickResult", "flow", "replay_deltas",
    "config_snapshot",
]
