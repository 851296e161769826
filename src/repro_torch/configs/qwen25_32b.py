"""qwen2.5-32b [dense] — 64L d_model=5120 40H (GQA kv=8) d_ff=27648
vocab=152064, QKV bias [hf:Qwen/Qwen2.5-32B]."""
from .base import ModelConfig, lm_shapes

CONFIG = ModelConfig(
    name="qwen2.5-32b", family="dense",
    n_layers=64, d_model=5120, n_heads=40, n_kv_heads=8, d_ff=27648,
    vocab_size=152064, attn_bias=True,
    # 40 heads / kv=8: no kv_repeat makes kh*r divide TP=16 while keeping
    # query groups even (DESIGN §5) -> scores stay head-unsharded; q-chunking
    # bounds the materialized [q_chunk, S] block instead
    attn_q_chunk=1024,
    grad_accum=16,
)

SMOKE_CONFIG = CONFIG.replace(
    name="qwen25-smoke", n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
    d_ff=160, vocab_size=256, grad_accum=2)

SHAPES = lm_shapes(train_accum=16, skip_long=True)   # full attention
