"""llama-3.2-vision-11b [vlm] — 40L d_model=4096 32H (GQA kv=8) d_ff=14336
vocab=128256, cross-attn image layers every 5th layer; vision frontend is a
STUB: input_specs() provides precomputed patch embeddings
[hf:meta-llama/Llama-3.2-11B-Vision]."""
from .base import ModelConfig, lm_shapes

CONFIG = ModelConfig(
    name="llama-3.2-vision-11b", family="vlm",
    n_layers=40, d_model=4096, n_heads=32, n_kv_heads=8, d_ff=14336,
    vocab_size=128256,
    cross_attn_period=5, cross_attn_offset=3,
    n_vision_tokens=1601,            # 1 CLS + 40x40 patches
    grad_accum=8,
)

SMOKE_CONFIG = CONFIG.replace(
    name="llama-vision-smoke", n_layers=5, d_model=64, n_heads=4,
    n_kv_heads=2, d_ff=128, vocab_size=256, n_vision_tokens=17,
    grad_accum=2)

SHAPES = lm_shapes(train_accum=8, skip_long=True)   # full self-attention
