"""hubert-xlarge [audio] — 48L d_model=1280 16H d_ff=5120 vocab=504,
encoder-only (w2v2 arch); modality frontend is a STUB: input_specs()
provides precomputed frame embeddings [arXiv:2106.07447]."""
from .base import ModelConfig, lm_shapes

CONFIG = ModelConfig(
    name="hubert-xlarge", family="audio",
    n_layers=48, d_model=1280, n_heads=16, n_kv_heads=16, d_ff=5120,
    vocab_size=504, causal=False, mlp_kind="gelu",
    grad_accum=4,
)

SMOKE_CONFIG = CONFIG.replace(
    name="hubert-smoke", n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
    d_ff=128, vocab_size=32, grad_accum=2)

# encoder-only: no decode step -> decode_32k / long_500k skipped
SHAPES = lm_shapes(train_accum=4, skip_decode=True)
