"""What the input pipeline's refills cost the window's steps, on the host
clock: the steps that overlap a ``data.refill`` run longer than the median
of those that overlap none by this much, summed over the window, a step,
in ms (``spans.input_interference_ms``)."""
from portbench.spans import input_interference_ms


def read(run):
    prog = (run.trace or {}).get("program")
    return input_interference_ms(prog["window_events"]) if prog else None
