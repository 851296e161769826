"""The selective scan's forward calls in the traced step, the first
forward and the checkpoint's recompute: their least time over their
device time, in percent."""
from portbench.readers import roofline_share

OPS = ("repro_torch::mamba_scan", "repro_torch::mamba_scan_with_carries")


def read(run):
    return roofline_share(run, OPS)
