"""Initial weights from the run's seed, made the same way for the port and
for the reference.

A reference module lists its leaves as ``(path, shape, init)``: the path
is where the leaf sits in the port's parameter tree (a path under
``blocks.`` holds every layer's leaf stacked along dim 0), ``init`` one
of ``("normal", std)``, ``("uniform", bound)`` (over ``[-bound, bound)``),
``("const", value)`` or ``("log_arange",)`` (``log(1..N)`` along the last dim, Mamba's
``A_log``).  The leaves are drawn in list order from one
``torch.Generator`` on the device, seeded with the run's seed, in float32,
one call a leaf, so a second pass gives the same values leaf by leaf.
"""
from __future__ import annotations

from typing import Iterator, List, Tuple

import torch

Spec = Tuple[str, tuple, tuple]


def make_leaves(specs: List[Spec], seed: int, device
                ) -> Iterator[Tuple[str, torch.Tensor]]:
    """Yield ``(path, float32 tensor)`` for every spec, in order."""
    device = torch.device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    for path, shape, init in specs:
        kind = init[0]
        if kind == "normal":
            x = torch.randn(shape, generator=gen, dtype=torch.float32,
                            device=device).mul_(init[1])
        elif kind == "uniform":
            x = torch.rand(shape, generator=gen, dtype=torch.float32,
                           device=device).mul_(2 * init[1]).sub_(init[1])
        elif kind == "const":
            x = torch.full(shape, float(init[1]), dtype=torch.float32,
                           device=device)
        elif kind == "log_arange":
            n = shape[-1]
            x = torch.log(torch.arange(1, n + 1, dtype=torch.float32,
                                       device=device)).expand(shape).clone()
        else:
            raise ValueError(f"unknown init {init!r} for {path}")
        yield path, x


def stacked(path: str) -> bool:
    """Whether the leaf at ``path`` stacks its layers along dim 0."""
    return path.startswith("blocks.")


def layer_slices(path: str, x: torch.Tensor
                 ) -> Iterator[Tuple[str, torch.Tensor]]:
    """A leaf as the comparison counts it: a stacked leaf one layer at a
    time (``path[i]``), any other whole."""
    if stacked(path):
        for i in range(x.shape[0]):
            yield f"{path}[{i}]", x[i]
    else:
        yield path, x
