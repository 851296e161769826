"""Model/shape configuration system (host-only; a copy of the reference's).

Two differences from the reference: ``attn_impl`` / ``ssm_impl`` take
``auto | cuda | reference`` and default to ``auto``, which runs the
hand-written CUDA kernel on a CUDA tensor and its plain torch version on a
CPU tensor (the reference defaults to its plain jnp route); and three
fields the reference lacks, whose defaults are its behaviour:
``mixer_norms``, ``use_rope`` and ``tie_embeddings`` (the published
Jamba's, which the benchmark's ``jamba2-3b`` configuration turns on).

Every assigned architecture gets a `configs/<id>.py` exporting:
  CONFIG        — full-size ModelConfig (exact paper/public numbers)
  SMOKE_CONFIG  — reduced same-family config for CPU smoke tests
  SHAPES        — the shape cells this arch runs (with principled skips)
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass, field
from typing import Dict, Optional, Tuple


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # dense | moe | ssm | hybrid | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                # 0 -> d_model // n_heads
    # --- MoE ---
    n_experts: int = 0
    experts_per_token: int = 0
    capacity_factor: float = 1.25
    moe_layer_period: int = 1        # MoE FFN every k-th layer (jamba: 2)
    moe_group_size: int = 1024       # GShard dispatch group size
    # --- SSM (mamba1) ---
    ssm_state: int = 0
    d_conv: int = 4
    expand: int = 2
    ssm_chunk: int = 128             # inner sequential-scan chunk (remat unit)
    # --- attention ---
    sliding_window: int = 0          # 0 = full attention
    attn_bias: bool = False          # qwen-style QKV bias
    causal: bool = True              # False -> encoder (hubert)
    attn_layer_period: int = 1       # jamba: attention every k-th layer (8)
    attn_layer_offset: int = 0       # position of attn layer within period
    cross_attn_period: int = 0       # vlm: cross-attn every k-th layer
    cross_attn_offset: int = 0
    n_vision_tokens: int = 0         # vlm stub frontend sequence length
    mlp_kind: str = "swiglu"         # swiglu | gelu
    attn_impl: str = "auto"          # auto | cuda | reference
    ssm_impl: str = "auto"           # auto | cuda | reference
    attn_q_chunk: int = 0            # 0 = auto (chunk when Sq >= 8192);
                                     # else chunk q at this size (bounds the
                                     # materialized [q_chunk, Skv] scores)
    kv_repeat: int = 1               # replicate kv heads r-x so kh*r divides
                                     # the TP axis (math-identical GQA; set
                                     # per-mesh by launch/specs.py)
    expert_parallel: bool = False    # EP: shard MoE experts over 'model'
                                     # (needs n_experts % TP == 0); baseline
                                     # replicates experts and TPs d_ff
    seq_shard: bool = False          # Megatron-style sequence parallelism:
                                     # residual stream sharded over 'model'
                                     # on the SEQ dim between TP blocks (the
                                     # per-layer all-reduce becomes
                                     # reduce-scatter + all-gather)
    ssm_fused_ref: bool = False      # compute dA/dBx per step inside the
                                     # scan (no [chunk,d,N] HBM tensors) —
                                     # the pure-jnp analogue of the Pallas
                                     # kernel's VMEM fusion
    ssm_unroll: int = 1              # unroll factor of the inner time-step
                                     # scan: h stays in registers across k
                                     # fused steps (h HBM round-trips / k)
    rope_theta: float = 1_000_000.0
    use_rope: bool = True            # False: attention layers carry no
                                     # positional encoding (jamba)
    mixer_norms: bool = False        # jamba's weighted RMSNorms on the
                                     # mixer's dt, B and C (eps norm_eps)
    tie_embeddings: bool = False     # the head is tok_embed^T (no head_w)
    norm_eps: float = 1e-5
    logit_softcap: float = 0.0       # grok-style tanh softcap
    # --- numerics / memory policy ---
    param_dtype: str = "float32"     # giant archs use bfloat16 (see DESIGN §6)
    compute_dtype: str = "bfloat16"
    opt_state_dtype: str = "float32"
    grad_accum_dtype: str = ""       # microbatch grad accumulator dtype;
                                     # "" = opt_state_dtype.  bf16 halves the
                                     # per-microbatch grad reduce-scatter
                                     # payload (§Perf lever)
    remat_policy: str = "full"       # full | none
    scan_layers: bool = True
    # --- medium-level partitioning (paper: horizontal splits) ---
    grad_accum: int = 1              # microbatches per train step

    @property
    def hd(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // self.n_heads if self.n_heads else 0

    @property
    def kh_eff(self) -> int:
        """kv-head count after TP replication (see kv_repeat)."""
        return self.n_kv_heads * self.kv_repeat

    @property
    def d_inner(self) -> int:
        return self.expand * self.d_model

    @property
    def dt_rank(self) -> int:
        return math.ceil(self.d_model / 16)

    @property
    def is_encoder(self) -> bool:
        return not self.causal

    def layer_kind(self, i: int) -> str:
        """'attn' or 'mamba' mixer for layer i (hybrid interleave)."""
        if self.family == "ssm":
            return "mamba"
        if self.family == "hybrid":
            return ("attn" if i % self.attn_layer_period == self.attn_layer_offset
                    else "mamba")
        return "attn"

    def ffn_kind(self, i: int) -> str:
        """'moe' or 'dense' FFN for layer i."""
        if self.n_experts and i % self.moe_layer_period == (self.moe_layer_period - 1):
            return "moe"
        return "dense"

    def has_cross_attn(self, i: int) -> bool:
        return (self.cross_attn_period > 0
                and i % self.cross_attn_period == self.cross_attn_offset)

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    # ------------------------------------------------------- param counting
    def param_count(self) -> int:
        """Total parameters — mirrors models/transformer._layer_defs."""
        d, f, V = self.d_model, self.d_ff, self.vocab_size
        h, k, hd = self.n_heads, self.n_kv_heads, self.hd
        if self.family == "audio":
            total = d * d + 2 * d          # in_proj_w, in_proj_b, in_ln
        else:
            total = V * d                  # tok_embed
        total += d                         # final_ln
        if not self.tie_embeddings:
            total += d * V                 # head_w
        for i in range(self.n_layers):
            total += d                     # ln1
            if self.layer_kind(i) == "attn":
                total += d * h * hd + 2 * d * k * hd + h * hd * d
                if self.attn_bias:
                    total += h * hd + 2 * k * hd
            else:                          # mamba
                di, N, dtr = self.d_inner, self.ssm_state, self.dt_rank
                total += (d * 2 * di + self.d_conv * di + di   # in/conv_w/b
                          + di * (dtr + 2 * N) + dtr * di + di  # x/dt_proj/bias
                          + di * N + di + di * d)               # A_log, D, out
                if self.mixer_norms:
                    total += dtr + 2 * N                        # dt/b/c_norm
            if self.has_cross_attn(i):
                total += d + d * h * hd + 2 * d * k * hd + h * hd * d + 1
            if f > 0:
                total += d                 # ln2
                nm = 3 if self.mlp_kind == "swiglu" else 2
                if self.ffn_kind(i) == "moe":
                    total += d * self.n_experts               # router
                    total += self.n_experts * nm * d * f
                else:
                    total += nm * d * f
        return total

    def active_param_count(self) -> int:
        """Parameters active per token (MoE: top-k of experts)."""
        if not self.n_experts:
            return self.param_count()
        d, f = self.d_model, self.d_ff
        nm = 3 if self.mlp_kind == "swiglu" else 2
        inactive = 0
        for i in range(self.n_layers):
            if self.ffn_kind(i) == "moe":
                inactive += (self.n_experts - self.experts_per_token) * nm * d * f
        return self.param_count() - inactive


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                        # train | prefill | decode
    grad_accum: int = 1              # microbatch count for train shapes

    @property
    def tokens(self) -> int:
        return self.seq_len * self.global_batch


def lm_shapes(*, train_accum: int = 8, skip_decode: bool = False,
              skip_long: bool = False) -> Dict[str, ShapeConfig]:
    """The assigned LM shape set with per-arch principled skips."""
    shapes = {
        "train_4k": ShapeConfig("train_4k", 4096, 256, "train",
                                grad_accum=train_accum),
        "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    }
    if not skip_decode:
        shapes["decode_32k"] = ShapeConfig("decode_32k", 32768, 128, "decode")
        if not skip_long:
            shapes["long_500k"] = ShapeConfig("long_500k", 524288, 1, "decode")
    return shapes
