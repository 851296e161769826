"""qwen2-72b [dense] — 80L d_model=8192 64H (GQA kv=8) d_ff=29568
vocab=152064, QKV bias [arXiv:2407.10671]."""
from .base import ModelConfig, lm_shapes

CONFIG = ModelConfig(
    name="qwen2-72b", family="dense",
    n_layers=80, d_model=8192, n_heads=64, n_kv_heads=8, d_ff=29568,
    vocab_size=152064, attn_bias=True,
    # adopted from EXPERIMENTS §Perf (it2/it3): sequence parallelism shards
    # the residual stream + remat saves over the TP axis (peak 20.4 -> 8.6
    # GiB/chip — the HBM fit) and bf16 microbatch grad accumulation trims
    # the accumulator (8.6 -> 8.1 GiB).  Both are semantics-preserving.
    seq_shard=True,
    grad_accum_dtype="bfloat16",
    grad_accum=16,
)

SMOKE_CONFIG = CONFIG.replace(
    name="qwen2-smoke", n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
    d_ff=128, vocab_size=256, grad_accum=2)

SHAPES = lm_shapes(train_accum=16, skip_long=True)  # full attention
