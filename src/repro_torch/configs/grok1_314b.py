"""grok-1-314b [moe] — 64L d_model=6144 48H (GQA kv=8) d_ff=32768
vocab=131072, MoE 8e top-2 [hf:xai-org/grok-1]."""
from .base import ModelConfig, lm_shapes

CONFIG = ModelConfig(
    name="grok-1-314b", family="moe",
    n_layers=64, d_model=6144, n_heads=48, n_kv_heads=8, d_ff=32768,
    vocab_size=131072, n_experts=8, experts_per_token=2,
    logit_softcap=30.0,
    # 314B params: bf16 params + bf16 moments (DESIGN §6 memory policy)
    param_dtype="bfloat16", opt_state_dtype="bfloat16",
    grad_accum=16,
)

SMOKE_CONFIG = CONFIG.replace(
    name="grok1-smoke", n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
    d_ff=128, vocab_size=256, n_experts=4, experts_per_token=2,
    moe_group_size=32, param_dtype="float32", opt_state_dtype="float32",
    grad_accum=2)

# full attention -> long_500k skipped (quadratic prefill / unbounded KV)
SHAPES = lm_shapes(train_accum=16, skip_long=True)
