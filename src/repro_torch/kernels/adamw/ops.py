"""The fused AdamW update and the gradients' sum of squares: the CUDA
kernels of ``csrc/adamw.cu``, on CUDA tensors only.

No TPU kernel corresponds: the reference's AdamW is ``jnp`` code
(``repro/train/optimizer.py``) that XLA fuses.  The plain version, and the
oracle the card tests and ``chip_smoke.py`` hold the kernels against, is
``train/optimizer.py``'s piecewise route, which the optimizer takes for
CPU tensors; for CUDA tensors it calls these wrappers, which launch or
raise.  Bound on the card: bytes, 28 a parameter for the update and 4 for
the norm at fp32 state.  The update runs one launch a leaf; the norm one a
leaf, then one that sums the leaves' partials in a fixed order.  Their
time, launches and bound on the H100 are in PERF.md."""
from __future__ import annotations

import functools
from typing import Sequence

import torch

from .. import _cuda

#: threads a block and elements a thread loads at once (csrc/adamw.cu:
#: kThreads, kVec)
THREADS = 256
VEC = 4
#: most blocks a launch gives each SM (2,048 threads, the SM's limit); a
#: larger leaf is walked by grid stride
BLOCKS_PER_SM = 8
_TYPES = (torch.float32, torch.bfloat16)


@functools.lru_cache(maxsize=None)
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _blocks(n: int, device: torch.device) -> int:
    """The grid of either kernel over ``n`` elements: a vector a thread,
    at most BLOCKS_PER_SM blocks an SM."""
    return max(1, min(-(-n // (THREADS * VEC)),
                      BLOCKS_PER_SM * _sms(device.index)))


def _check(name: str, t: torch.Tensor, device: torch.device) -> None:
    if not t.is_cuda:
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype not in _TYPES:
        raise TypeError(f"{name} must be float32 or bfloat16, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _check_scalar(name: str, t: torch.Tensor, device: torch.device) -> None:
    _check(name, t, device)
    if t.dtype != torch.float32 or t.numel() != 1:
        raise ValueError(f"{name} must be one float32 value, got "
                         f"{t.dtype} {tuple(t.shape)}")


def _bf16(t: torch.Tensor) -> int:
    return int(t.dtype == torch.bfloat16)


def square_sums_cuda(grads: Sequence[torch.Tensor], grad_div: int = 1,
                     clip: float = 0.0) -> torch.Tensor:
    """[3] float32 on the gradients' device: the sum over every leaf of
    (g / grad_div) squared, its square root (the global norm), and the
    clip scale ``min(clip / (norm + 1e-9), 1)`` (1 where ``clip`` is not
    above 0).  Each g is float32 or bfloat16, contiguous, on one device;
    ``grad_div`` divides as ``g.div_(grad_div)`` does on the card."""
    if not grads:
        raise ValueError("square_sums_cuda: no gradients")
    if grad_div < 1:
        raise ValueError(f"grad_div must be 1 or more, got {grad_div}")
    device = grads[0].device
    for i, g in enumerate(grads):
        _check(f"gradient {i}", g, device)
    sizes = [_blocks(g.numel(), device) if g.numel() else 0 for g in grads]
    part = torch.empty(sum(sizes), dtype=torch.float64, device=device)
    out = torch.empty(3, dtype=torch.float32, device=device)
    lib = _cuda.library()
    stream = _cuda.stream_ptr(out)
    with _cuda.device_guard(out):
        off = 0
        for g, nb in zip(grads, sizes):
            if not nb:
                continue
            _cuda.check(lib.repro_adamw_square_partials(
                g.data_ptr(), _bf16(g), g.numel(), grad_div, nb,
                part.data_ptr() + 8 * off, stream), "adamw_square_sum")
            _cuda.count_launch("adamw_square_sum")
            off += nb
        _cuda.check(lib.repro_adamw_square_finish(
            part.data_ptr(), off, clip, int(clip > 0), out.data_ptr(),
            stream), "adamw_square_sum")
        _cuda.count_launch("adamw_square_sum")
    return out


def adamw_cuda(p: torch.Tensor, g: torch.Tensor, m: torch.Tensor,
               v: torch.Tensor, *, lr: torch.Tensor, scale: torch.Tensor,
               bc1: torch.Tensor, bc2: torch.Tensor, b1: float, b2: float,
               eps: float, wd: float, grad_div: int = 1) -> int:
    """One AdamW step of one leaf, in place on ``p``, ``m`` and ``v``, as
    the plain route computes it (``train/optimizer.py``: ``g / grad_div``,
    then ``* scale``, the moments, the bias corrections ``bc1`` and
    ``bc2``, the step of ``lr`` with weight decay ``wd``).  p, g, m, v:
    one shape, each float32 or bfloat16, contiguous, on one device; lr,
    scale, bc1, bc2: one float32 value each on that device.  Returns the
    elements updated."""
    device = p.device
    for name, t in (("p", p), ("g", g), ("m", m), ("v", v)):
        _check(name, t, device)
        if t.shape != p.shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, p "
                             f"{tuple(p.shape)}")
    for name, t in (("lr", lr), ("scale", scale), ("bc1", bc1),
                    ("bc2", bc2)):
        _check_scalar(name, t, device)
    if grad_div < 1:
        raise ValueError(f"grad_div must be 1 or more, got {grad_div}")
    n = p.numel()
    if not n:
        return 0
    with _cuda.device_guard(p):
        _cuda.check(_cuda.library().repro_adamw_update(
            p.data_ptr(), _bf16(p), g.data_ptr(), _bf16(g), m.data_ptr(),
            _bf16(m), v.data_ptr(), _bf16(v), n, lr.data_ptr(),
            scale.data_ptr(), bc1.data_ptr(), bc2.data_ptr(), b1, 1 - b1, b2,
            1 - b2, eps, wd, grad_div, _blocks(n, device),
            _cuda.stream_ptr(p)), "adamw_update")
    _cuda.count_launch("adamw_update")
    return n
