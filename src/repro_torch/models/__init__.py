from .layers import NO_RULES, Rules
from .moe import moe_block
from .transformer import (backbone, decode_step, forward_prefill, grow_cache,
                          init_params, make_cache_shapes, n_periods,
                          param_count, param_shapes, period)

__all__ = ["NO_RULES", "Rules", "backbone", "decode_step", "forward_prefill",
           "grow_cache", "init_params", "make_cache_shapes", "moe_block", "n_periods",
           "param_count", "param_shapes", "period"]
