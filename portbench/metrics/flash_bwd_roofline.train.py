"""The flash backward's calls in the traced step: their least time over
their device time, in percent."""
from portbench.readers import roofline_share

OPS = ("repro_torch::flash_attention_backward",)


def read(run):
    return roofline_share(run, OPS)
