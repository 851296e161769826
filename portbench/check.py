"""The numbers that decide ``correct``: the port's first steps against the
reference's, from what each side read (``program`` and ``reference`` as
``reference.follow`` returns them).

- ``rows_mismatch``: tokens of the first steps' batches that differ from
  the rows ``docs`` packs; ``repeated_rows``: rows that occur twice among
  them.  Exact: limit 0.
- ``loss_gap``: the largest over the steps of |loss - reference| /
  |reference|.
- ``grad_gap``: over the leaves (a layer of a stacked leaf is one), the
  largest |norm - reference norm| of the first step's clipped gradient,
  over the larger of the reference leaf's norm and the median leaf's.
- ``update_gap``: the same of each leaf's change after the last step,
  leaving out leaves whose reference gradient is under a thousandth of
  the median leaf's: those move under Adam by rounding alone.
"""
from __future__ import annotations

import math
import statistics
from typing import Dict

import numpy as np

EXACT = ("rows_mismatch", "repeated_rows")


def _gap(prog: Dict[str, float], ref: Dict[str, float], keep=None) -> float:
    names = [n for n in ref if keep is None or keep(n)]
    if not names or set(prog) != set(ref):
        return math.inf
    med = statistics.median(ref[n] for n in names)
    worst = 0.0
    for n in names:
        p, r = prog[n], ref[n]
        if not (math.isfinite(p) and math.isfinite(r)):
            return math.inf
        worst = max(worst, abs(p - r) / max(r, med, 1e-30))
    return worst


def numbers(program: dict, reference: dict) -> Dict[str, float]:
    lp, lr = program["losses"], reference["losses"]
    loss_gap = (max(abs(a - b) / abs(b) for a, b in zip(lp, lr))
                if len(lp) == len(lr) and all(map(math.isfinite, lp))
                else math.inf)
    gref = reference["grad_norms"]
    gmed = statistics.median(gref.values())
    return {
        "loss_gap": loss_gap,
        "grad_gap": _gap(program["grad_norms"], gref),
        "update_gap": _gap(program["delta_norms"], reference["delta_norms"],
                           keep=lambda n: gref[n] >= 1e-3 * gmed),
    }


def row_numbers(got: np.ndarray, want: np.ndarray) -> Dict[str, int]:
    """``got``, ``want``: the first steps' token rows stacked [R, S]."""
    if got.shape != want.shape:
        return {"rows_mismatch": int(max(got.size, want.size)),
                "repeated_rows": 0}
    uniq = np.unique(got, axis=0).shape[0]
    return {"rows_mismatch": int((got != want).sum()),
            "repeated_rows": int(got.shape[0] - uniq)}


def verdict(values: Dict[str, float], limits: Dict[str, float]) -> bool:
    """Every number present, finite and within its limit (0 for the exact
    ones)."""
    for name in EXACT:
        if values.get(name) != 0:
            return False
    for name, lim in limits.items():
        v = values.get(name)
        if v is None or not math.isfinite(v) or v > lim:
            return False
    return True
