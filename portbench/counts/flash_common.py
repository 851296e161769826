"""Frozen work counts of causal or windowed attention (the rules PERF.md
gives for its ``bound_ms``): the forward's two products are 4 * hd operations a
(query head, key) pair the mask allows; the backward's S, dP, dV, dK, dQ
are 10 * hd a pair and D 2 * hd a row.  Bytes: each input read once and
each output written once."""
from __future__ import annotations

import functools

from portbench.readers import nbytes

PEAK = {"c10::BFloat16": "bf16", "c10::Half": "bf16", "float": "fp32"}


@functools.lru_cache(maxsize=None)
def allowed_pairs(Sq: int, Skv: int, causal: bool, window: int) -> int:
    """(query i, key j) pairs with j <= i when causal, j > i - window with
    a window."""
    total = 0
    for i in range(Sq):
        hi = min(Skv - 1, i) if causal else Skv - 1
        lo = max(0, i - window + 1) if window > 0 else 0
        total += max(0, hi - lo + 1)
    return total


def flags(scalars, at: int):
    """(causal, window) from the op's scalar arguments starting at
    ``at``."""
    return scalars[at] == "True", int(float(scalars[at + 1] or 0))


def forward(dims, types, scalars, with_lse: bool) -> dict:
    (B, Sq, Kh, G, hd), (_, Skv, _, _) = dims[0], dims[1]
    causal, window = flags(scalars, 3)
    pairs = allowed_pairs(Sq, Skv, causal, window)
    byt = (2 * nbytes(dims[0], types[0]) + nbytes(dims[1], types[1])
           + nbytes(dims[2], types[2]))
    if with_lse:
        byt += 4 * B * Kh * G * Sq
    return {"flops": 4 * B * Kh * G * hd * pairs, "bytes": byt,
            "peak": PEAK[types[0]]}


def backward(dims, types, scalars) -> dict:
    (B, Sq, Kh, G, hd), (_, Skv, _, _) = dims[0], dims[1]
    causal, window = flags(scalars, 6)
    pairs = allowed_pairs(Sq, Skv, causal, window)
    rows = B * Kh * G
    q, k, v = (nbytes(dims[i], types[i]) for i in range(3))
    byt = 3 * q + 2 * k + 2 * v + nbytes(dims[3], types[3]) \
        + nbytes(dims[4], types[4])
    return {"flops": rows * hd * (10 * pairs + 2 * Sq), "bytes": byt,
            "peak": PEAK[types[0]]}
