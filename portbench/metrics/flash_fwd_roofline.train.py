"""The flash forward's calls in the traced step, the first forward and
the checkpoint's recompute: their least time over their device time, in
percent."""
from portbench.readers import roofline_share

OPS = ("repro_torch::flash_attention", "repro_torch::flash_attention_with_lse")


def read(run):
    return roofline_share(run, OPS)
