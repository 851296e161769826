# Training input pipeline BUILT ON core/: the host-side token pipeline IS an
# ETL dataflow (source -> tokenize/pack transforms -> batch block), executed
# by the paper's optimized engine with shared caching + pipelined prefetch.
from .pipeline import (InputPipeline, PipelineConfig, SyntheticTokenSource,
                       make_lm_batch_fn)
from .prefetch import PrefetchQueue

__all__ = ["InputPipeline", "PipelineConfig", "SyntheticTokenSource",
           "make_lm_batch_fn", "PrefetchQueue"]
