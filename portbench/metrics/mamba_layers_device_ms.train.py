"""Device time of the items launched inside the program's ``model.layer``
spans of Mamba layers (forward, recompute and backward) in the program
session's traced step, in ms; the session's tracer is
``layer_spans.tracer()``, which names each such span by kind and phase."""
from portbench import layer_spans


def read(run):
    return layer_spans.device_ms(run, "mamba")
