"""``repro_torch::flash_attention(q, k, v, causal, window, softcap)``."""
from portbench.counts.flash_common import forward


def work(dims, types, scalars) -> dict:
    return forward(dims, types, scalars, with_lse=False)
