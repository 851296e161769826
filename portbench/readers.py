"""What the metric readers share."""
from __future__ import annotations

from typing import Iterable, Optional

#: bytes of an element, by the profiler's name of its type
ELEMENT_BYTES = {"c10::BFloat16": 2, "c10::Half": 2, "float": 4,
                 "double": 8, "int": 4, "long int": 8, "bool": 1,
                 "unsigned char": 1, "signed char": 1, "short int": 2}


def numel(dims) -> int:
    n = 1
    for x in dims:
        n *= x
    return n


def nbytes(dims, type_name: str) -> int:
    return numel(dims) * ELEMENT_BYTES[type_name]


def roofline_share(run, ops: Iterable[str]) -> Optional[float]:
    """Sum of the calls' least times (the larger of their operations over
    the peak their count names and their bytes over HBM's rate) over the
    sum of their device times, in percent; None where the trace holds no
    such call with device time or the device has no peaks here."""
    peaks = run.peaks
    if run.trace is None or peaks is None:
        return None
    ops = set(ops)
    bound = device = 0.0
    for call in run.trace["calls"]:
        if call["op"] not in ops or call["device_s"] <= 0:
            continue
        w = run.registry.count(call["op"]).work(
            call["dims"], call["types"], call["scalars"])
        bound += max(w["flops"] / peaks[w["peak"]],
                     w["bytes"] / peaks["hbm_bytes"])
        device += call["device_s"]
    return 100.0 * bound / device if device > 0 else None
