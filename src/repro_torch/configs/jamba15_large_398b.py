"""jamba-1.5-large-398b [hybrid] — 72L d_model=8192 64H (GQA kv=8)
d_ff=24576 vocab=65536, MoE 16e top-2, Mamba:attn 7:1 interleave
[arXiv:2403.19887]."""
from .base import ModelConfig, lm_shapes

CONFIG = ModelConfig(
    name="jamba-1.5-large-398b", family="hybrid",
    n_layers=72, d_model=8192, n_heads=64, n_kv_heads=8, d_ff=24576,
    vocab_size=65536, n_experts=16, experts_per_token=2,
    moe_layer_period=2,              # MoE every other layer (jamba paper)
    attn_layer_period=8,             # 1 attention layer per 8 (1:7 ratio)
    attn_layer_offset=4,
    ssm_state=16, expand=2, d_conv=4,
    # 398B params: bf16 params + bf16 moments (DESIGN §6 memory policy)
    param_dtype="bfloat16", opt_state_dtype="bfloat16",
    grad_accum=16,
)

SMOKE_CONFIG = CONFIG.replace(
    name="jamba-smoke", n_layers=8, d_model=64, n_heads=4, n_kv_heads=2,
    d_ff=128, vocab_size=256, n_experts=4, experts_per_token=2,
    ssm_state=8, ssm_chunk=16, moe_group_size=32,
    param_dtype="float32", opt_state_dtype="float32", grad_accum=2)

# attention only every 8th layer; long-context KV sharded over `data`
SHAPES = lm_shapes(train_accum=16)
