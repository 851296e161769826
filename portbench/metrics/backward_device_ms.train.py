"""Device time of the items launched inside the program's
``model.backward`` spans in the program session's traced step, the
checkpoints' recompute included and the gradient accumulator's adds
(``train.grad_accum``) left out, in ms."""
from portbench.spans import device_ms


def read(run):
    return device_ms(run, "model.backward")
