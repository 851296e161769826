"""falcon-mamba-7b [ssm] — 64L d_model=4096 attn-free, vocab=65024,
ssm_state=16 (mamba1 arch) [arXiv:2410.05355]."""
from .base import ModelConfig, lm_shapes

CONFIG = ModelConfig(
    name="falcon-mamba-7b", family="ssm",
    n_layers=64, d_model=4096, n_heads=0, n_kv_heads=0, d_ff=0,
    vocab_size=65024, ssm_state=16, expand=2, d_conv=4,
    mlp_kind="swiglu", grad_accum=8,
)

SMOKE_CONFIG = CONFIG.replace(
    name="falcon-mamba-smoke", n_layers=2, d_model=64, vocab_size=256,
    ssm_state=8, ssm_chunk=16, grad_accum=2)

# attn-free SSM: O(1) decode state — runs every shape including long_500k
SHAPES = lm_shapes(train_accum=8)
