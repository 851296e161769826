"""``repro_torch::mamba_scan_backward(delta, x, B, C, A, h0, carries,
grad_y, grad_hT)`` -> the six inputs' gradients."""
from portbench.counts.scan_common import backward


def work(dims, types, scalars) -> dict:
    return backward(dims, types, scalars)
