"""stablelm-3b [dense] — 32L d_model=2560 32H (MHA kv=32) d_ff=6912
vocab=50304 [hf:stabilityai/stablelm-2-1_6b family]."""
from .base import ModelConfig, lm_shapes

CONFIG = ModelConfig(
    name="stablelm-3b", family="dense",
    n_layers=32, d_model=2560, n_heads=32, n_kv_heads=32, d_ff=6912,
    vocab_size=50304,
    grad_accum=4,
)

SMOKE_CONFIG = CONFIG.replace(
    name="stablelm-smoke", n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
    d_ff=128, vocab_size=256, grad_accum=2)

SHAPES = lm_shapes(train_accum=4, skip_long=True)   # full attention
