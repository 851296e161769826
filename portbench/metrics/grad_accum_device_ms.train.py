"""Device time of the items launched inside the program's
``train.grad_accum`` spans (the per-layer gradient accumulator's adds) in
the program session's traced step, in ms."""
from portbench.spans import device_ms


def read(run):
    return device_ms(run, "train.grad_accum")
