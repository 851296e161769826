"""Frozen work counts of the selective scan (the rules PERF.md gives for
its ``bound_ms``): one exp2 a (batch, step, channel, state) on the special
function units; bytes: each input read once and each output written
once, at the types passed."""
from __future__ import annotations

from portbench.readers import nbytes, numel


def _exps(dims) -> int:
    Bt, T, d = dims[0]
    return Bt * T * d * dims[2][-1]


def forward(dims, types, scalars) -> dict:
    """Inputs delta, x, B, C, A, h0; outputs y [Bt, T, d] and hT
    [Bt, d, N] in float32."""
    byt = sum(nbytes(dims[i], types[i]) for i in range(6)) \
        + 4 * (numel(dims[0]) + numel(dims[5]))
    return {"flops": _exps(dims), "bytes": byt, "peak": "ex2"}


def backward(dims, types, scalars) -> dict:
    """Inputs delta, x, B, C, A, h0, the carries, dy, dhT; outputs the
    six inputs' gradients, each the size of its input."""
    read = sum(nbytes(dims[i], types[i]) for i in (0, 1, 2, 3, 4, 6, 7, 8))
    written = sum(nbytes(dims[i], types[i]) for i in range(6))
    return {"flops": _exps(dims), "bytes": read + written, "peak": "ex2"}
