"""``repro_torch::mamba_scan_with_carries(delta, x, B, C, A, h0)`` -> y,
hT and the states it saves for the backward.  The saved states are the
kernel's own choice and are not counted: the least work is the plain
scan's."""
from portbench.counts.scan_common import forward


def work(dims, types, scalars) -> dict:
    return forward(dims, types, scalars)
