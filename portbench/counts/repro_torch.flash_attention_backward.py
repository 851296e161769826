"""``repro_torch::flash_attention_backward(q, k, v, out, lse, dout, causal,
window, softcap)`` -> dq, dk, dv."""
from portbench.counts.flash_common import backward


def work(dims, types, scalars) -> dict:
    return backward(dims, types, scalars)
