"""mixtral-8x7b [moe] — 32L d_model=4096 32H (GQA kv=8) d_ff=14336
vocab=32000, MoE 8e top-2, sliding-window attention [arXiv:2401.04088]."""
from .base import ModelConfig, lm_shapes

CONFIG = ModelConfig(
    name="mixtral-8x7b", family="moe",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8, d_ff=14336,
    vocab_size=32000, n_experts=8, experts_per_token=2,
    sliding_window=4096,
    grad_accum=8,
)

SMOKE_CONFIG = CONFIG.replace(
    name="mixtral-smoke", n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
    d_ff=128, vocab_size=256, n_experts=4, experts_per_token=2,
    sliding_window=32, moe_group_size=32, grad_accum=2)

# SWA -> bounded KV ring buffer: long_500k runs
SHAPES = lm_shapes(train_accum=8)
