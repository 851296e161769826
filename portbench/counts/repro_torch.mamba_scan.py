"""``repro_torch::mamba_scan(delta, x, B, C, A, h0)`` -> y, hT."""
from portbench.counts.scan_common import forward


def work(dims, types, scalars) -> dict:
    return forward(dims, types, scalars)
