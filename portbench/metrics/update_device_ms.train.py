"""Device time of the items launched inside the program's
``train.update`` span (the gradients' scaling, the global norm and clip,
AdamW) in the program session's traced step, in ms."""
from portbench.spans import device_ms


def read(run):
    return device_ms(run, "train.update")
