"""granite-20b [dense] — 52L d_model=6144 48H (MQA kv=1) d_ff=24576
vocab=49152, llama-arch code model [arXiv:2405.04324]."""
from .base import ModelConfig, lm_shapes

CONFIG = ModelConfig(
    name="granite-20b", family="dense",
    n_layers=52, d_model=6144, n_heads=48, n_kv_heads=1, d_ff=24576,
    vocab_size=49152,
    # GPT-BigCode-style 4x gelu MLP (2 matrices) — swiglu at d_ff=4d would
    # put the model at ~28B, not the advertised 20B
    mlp_kind="gelu",
    grad_accum=8,
)

SMOKE_CONFIG = CONFIG.replace(
    name="granite-smoke", n_layers=2, d_model=64, n_heads=4, n_kv_heads=1,
    d_ff=128, vocab_size=256, grad_accum=2)

SHAPES = lm_shapes(train_accum=8, skip_long=True)   # full attention
