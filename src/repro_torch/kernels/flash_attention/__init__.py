from .ops import FlashAttentionFunction, flash_attention
from .ref import flash_attention_backward_ref, flash_attention_ref

__all__ = ["FlashAttentionFunction", "flash_attention",
           "flash_attention_backward_ref", "flash_attention_ref"]
