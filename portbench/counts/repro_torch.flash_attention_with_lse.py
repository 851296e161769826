"""``repro_torch::flash_attention_with_lse(q, k, v, causal, window,
softcap)``: the forward, also writing each row's log-sum-exp."""
from portbench.counts.flash_common import forward


def work(dims, types, scalars) -> dict:
    return forward(dims, types, scalars, with_lse=True)
