"""Device time of the items launched inside the program's
``model.forward`` spans in the program session's traced step, in ms."""
from portbench.spans import device_ms


def read(run):
    return device_ms(run, "model.forward")
