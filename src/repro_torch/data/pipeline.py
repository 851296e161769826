"""LM training input pipeline AS an ETL dataflow on the core engine.

The host-side token pipeline is expressed with the paper's own abstractions
and executed by the paper's optimized engine:

    doc source (SOURCE) -> length filter (ROW_SYNC) -> eos append (ROW_SYNC)
        -> sequence packer (BLOCK) -> batch sink (SINK)

Algorithm 1 partitions this into two execution trees (the packer roots the
second); inside each tree the shared caching scheme mutates one columnar
cache in place, and Algorithm 2's pipeline parallelization streams the
horizontal splits.  Each engine run processes one *window* of documents and
yields the packed [global_batch, seq_len+1] token blocks; `PrefetchQueue`
overlaps the next window's ETL with the device train step (the BlockingQueue
at the host/device boundary).

A copy of ``repro/data/pipeline.py`` on the port's own core.  One
deliberate difference: the reference runs this host dataflow on its
default ``numpy`` backend, and the port's default backend is ``torch`` (the
card), so ``InputPipeline`` names ``backend="numpy"``: the token blocks are
host arrays, byte-identical to the reference's.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Iterator, List, Optional

import numpy as np

from ..core.component import BlockComponent, SourceComponent
from ..core.engine import OptimizedEngine, OptimizeOptions
from ..core.expr import col
from ..core.graph import Dataflow
from ..core.shared_cache import SharedCache, concat_caches
from ..etl.components import CollectSink, Filter
from ..obs import trace


@dataclass(frozen=True)
class PipelineConfig:
    seq_len: int = 1024
    global_batch: int = 8
    vocab_size: int = 32000
    max_doc_len: int = 512
    min_doc_len: int = 16
    docs_per_window: int = 4096
    num_splits: int = 8                # m  (horizontal splits per window)
    pipeline_degree: int = 4           # m' (in-flight bound)
    prefetch_depth: int = 2            # host->device staging queue
    eos_id: int = 1
    seed: int = 0


class SyntheticTokenSource(SourceComponent):
    """Documents of random length with a Zipf-ish token distribution.
    Columns: tokens [n, max_doc_len] int32 (padded), length [n] int32."""

    # the RNG stream is chunk-granular: the emitted documents change with the
    # chunk size, so the executor must not realign it to a backend preference
    chunk_sensitive = True

    def __init__(self, name: str, cfg: PipelineConfig, window: int):
        super().__init__(name)
        self.cfg = cfg
        self.window = window

    def total_rows(self) -> int:
        return self.cfg.docs_per_window

    def chunks(self, chunk_rows: int) -> Iterator[SharedCache]:
        cfg = self.cfg
        rng = np.random.default_rng((cfg.seed, self.window))
        remaining = cfg.docs_per_window
        idx = 0
        while remaining > 0:
            n = min(chunk_rows, remaining)
            # lengths ~ uniform over [2, max_doc_len]; filter drops < min
            lengths = rng.integers(2, cfg.max_doc_len + 1, n).astype(np.int32)
            ranks = rng.zipf(1.3, size=(n, cfg.max_doc_len)).astype(np.int64)
            toks = (ranks % (cfg.vocab_size - 2) + 2).astype(np.int32)
            toks[np.arange(cfg.max_doc_len)[None, :] >= lengths[:, None]] = 0
            cache = SharedCache({"tokens": toks, "length": lengths}, n,
                                split_index=idx)
            self.rows_out += n
            yield cache
            remaining -= n
            idx += 1


class SequencePacker(BlockComponent):
    """BLOCK component: concatenates document tokens (with an EOS separator)
    and re-blocks into rows of seq_len+1 — the aggregation of this dataflow."""

    def __init__(self, name: str, seq_len: int, eos_id: int,
                 carry: Optional[np.ndarray] = None):
        super().__init__(name)
        self.seq_len = seq_len
        self.eos_id = eos_id
        self.carry = carry if carry is not None else np.zeros(0, np.int32)
        self.leftover = np.zeros(0, np.int32)

    def finish(self, state: List[SharedCache]) -> SharedCache:
        merged = concat_caches(state, ordered=True)
        toks = merged.col("tokens")
        lens = merged.col("length")
        parts = [self.carry]
        for i in range(merged.n):
            parts.append(toks[i, : lens[i]])
            parts.append(np.array([self.eos_id], np.int32))
        stream = np.concatenate(parts) if parts else np.zeros(0, np.int32)
        L = self.seq_len + 1
        n_seq = len(stream) // L
        self.leftover = stream[n_seq * L:]
        out = stream[: n_seq * L].reshape(n_seq, L)
        self.rows_out += n_seq
        return SharedCache({"tokens": out}, n_seq)


def build_lm_dataflow(cfg: PipelineConfig, window: int,
                      carry: Optional[np.ndarray] = None):
    """The LM token dataflow for one document window."""
    flow = Dataflow(f"lm-input-w{window}")
    src = SyntheticTokenSource("doc_source", cfg, window)
    filt = Filter("length_filter", col("length") >= cfg.min_doc_len)
    packer = SequencePacker("sequence_packer", cfg.seq_len, cfg.eos_id,
                            carry=carry)
    sink = CollectSink("batch_sink")
    flow.chain(src, filt, packer, sink)
    return flow, packer, sink


class InputPipeline:
    """Iterator of training batches produced by the optimized ETL engine."""

    def __init__(self, cfg: PipelineConfig):
        self.cfg = cfg
        self._window = 0
        self._carry = np.zeros(0, np.int32)
        self._pool = np.zeros((0, cfg.seq_len + 1), np.int32)
        self.engine_runs = []

    def _refill(self) -> None:
        """One engine run over the next window of documents (span
        ``data.refill``: ``window``, the ``rows`` it packed)."""
        with (trace.span("data", "data.refill", counter="data_refills",
                         window=self._window)
              if trace.ACTIVE.get() else trace.NULL_SPAN) as sp:
            cfg = self.cfg
            flow, packer, sink = build_lm_dataflow(cfg, self._window,
                                                   self._carry)
            run = OptimizedEngine(flow, OptimizeOptions(
                num_splits=cfg.num_splits,
                pipeline_degree=cfg.pipeline_degree, backend="numpy")).run()
            self.engine_runs.append(run)
            self._carry = packer.leftover
            got = sink.result()["tokens"].astype(np.int32)
            self._pool = (np.concatenate([self._pool, got])
                          if len(self._pool) else got)
            self._window += 1
            sp.set(rows=len(got))

    def __iter__(self) -> Iterator[np.ndarray]:
        return self

    def __next__(self) -> np.ndarray:
        B = self.cfg.global_batch
        while len(self._pool) < B:
            self._refill()
        batch, self._pool = self._pool[:B], self._pool[B:]
        return batch


def make_lm_batch_fn(cfg) -> Callable[[np.ndarray], Dict[str, np.ndarray]]:
    """Adapt packed token blocks [B, S+1] to the model-family batch dict.
    Modality frontends are STUBS per the assignment: frames / vision patches
    are deterministic embeddings of the token ids."""
    if cfg.family == "audio":
        rng = np.random.default_rng(7)
        proj = rng.normal(scale=0.02,
                          size=(min(cfg.vocab_size, 512), cfg.d_model)
                          ).astype(np.float32)

        def fn(tok_block: np.ndarray) -> Dict[str, np.ndarray]:
            toks = tok_block[:, :-1] % min(cfg.vocab_size, 512)
            return {"frames": proj[toks],
                    "labels": (tok_block[:, :-1] % cfg.vocab_size
                               ).astype(np.int32)}
        return fn

    if cfg.family == "vlm":
        rng = np.random.default_rng(11)
        patches = rng.normal(scale=0.02,
                             size=(cfg.n_vision_tokens, cfg.d_model)
                             ).astype(np.float32)

        def fn(tok_block: np.ndarray) -> Dict[str, np.ndarray]:
            B = tok_block.shape[0]
            return {"tokens": (tok_block[:, :-1] % cfg.vocab_size
                               ).astype(np.int32),
                    "vision": np.broadcast_to(
                        patches, (B,) + patches.shape).copy()}
        return fn

    def fn(tok_block: np.ndarray) -> Dict[str, np.ndarray]:
        return {"tokens": (tok_block[:, :-1] % cfg.vocab_size
                           ).astype(np.int32)}
    return fn
