"""The program's ``model.layer`` spans (``repro_torch.models.transformer``:
each layer's forward, its checkpoint's recompute and its backward) by the
layer's kind and the phase.  ``spans.attribute`` keys device time by a
span's name alone, so a program session whose tracer is ``tracer()``
records each such span as ``model.layer:<kind>:<phase>``; ``device_ms``
sums a kind's phases.
"""
from __future__ import annotations

from typing import Optional

from portbench import spans

KINDS = ("attn", "mamba")
PHASES = ("forward", "recompute", "backward")
SPAN = "model.layer"


def key(kind: str, phase: str) -> str:
    return f"{SPAN}:{kind}:{phase}"


def tracer(**kw):
    """A ``repro_torch.obs.trace.Tracer`` (``kw`` its arguments) that names
    each ``model.layer`` span by its kind and phase."""
    from repro_torch.obs.trace import Tracer

    class ByKind(Tracer):
        def emit(self, ph, cat, name, ts_us, dur_us=None, args=None):
            if name == SPAN and args:
                name = key(args["kind"], args["phase"])
            super().emit(ph, cat, name, ts_us, dur_us, args)
    return ByKind(**kw)


def device_ms(run, kind: str, phases=PHASES) -> Optional[float]:
    """Device ms a step of the items launched inside ``kind``'s layers in
    ``phases``; None where ``spans.device_ms`` gives none."""
    got = [spans.device_ms(run, key(kind, p)) for p in phases]
    return None if None in got else sum(got)
