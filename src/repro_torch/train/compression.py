"""Gradient compression for a cross-pod reduction (``repro/train/
compression.py``): bf16 compression (2x fewer bytes) and int8 with error
feedback (4x): per-tensor absmax scale, symmetric int8, and the
quantization residual carried into the next step's gradient.

``cross_pod_psum_int8`` all-reduces over the 'pod' axis of a
``DeviceMesh`` with an int8 payload.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

from .optimizer import tree_map


def bf16_compress(grads):
    """Every leaf rounded to bf16 and back (no state)."""
    return tree_map(lambda g: g.to(torch.bfloat16).to(g.dtype), grads)


def int8_quantize(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """-> (int8 values, fp32 scale): symmetric, absmax / 127."""
    scale = torch.max(torch.abs(x)).float() / 127.0 + 1e-12
    q = torch.clamp(torch.round(x.float() / scale), -127, 127).to(torch.int8)
    return q, scale


def int8_dequantize(q: torch.Tensor, scale: torch.Tensor,
                    dtype: torch.dtype) -> torch.Tensor:
    return (q.float() * scale).to(dtype)


def int8_roundtrip_with_feedback(g: torch.Tensor, err: torch.Tensor
                                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Quantize (g + err) -> (dequantized in g's dtype, new err)."""
    corrected = g.float() + err.float()
    q, scale = int8_quantize(corrected)
    deq = int8_dequantize(q, scale, torch.float32)
    return deq.to(g.dtype), (corrected - deq).to(err.dtype)


def make_error_feedback_state(grads):
    return tree_map(lambda g: torch.zeros(g.shape, dtype=torch.float32,
                                          device=g.device), grads)


def compress_tree_int8(grads, err_state):
    """The int8 round trip with error feedback on every leaf -> (grads,
    new error state)."""
    pairs = tree_map(int8_roundtrip_with_feedback, grads, err_state)
    return (tree_map(lambda pr: pr[0], pairs),
            tree_map(lambda pr: pr[1], pairs))


def cross_pod_psum_int8(mesh, grad_specs):
    """Returns fn(grads) that all-reduces every leaf over the 'pod' axis of
    ``mesh`` with an int8 payload (grads assumed pre-divided by the pod
    count), with the reference's semantics exactly: each rank quantizes its
    own block with its own absmax scale, the int8 values are summed in
    int32 over 'pod', the scales reduced by MAX (a shared conservative
    scale), and the int32 sum dequantized with that scale.  A DTensor leaf
    is first placed by its spec in ``grad_specs`` and its block is the
    rank's shard; a plain tensor is the rank's block as it is."""
    from .sharding import distribute
    group = mesh.get_group("pod")

    def psum_one(g, spec):
        blk = distribute(g, mesh, spec) if isinstance(g, DTensor) else g
        loc = blk.to_local() if isinstance(blk, DTensor) else blk
        q, scale = int8_quantize(loc)
        qsum = q.to(torch.int32)
        dist.all_reduce(qsum, op=dist.ReduceOp.SUM, group=group)
        dist.all_reduce(scale, op=dist.ReduceOp.MAX, group=group)
        out = int8_dequantize(qsum, scale, loc.dtype)
        if isinstance(blk, DTensor):
            from .sharding import from_local_shard
            return from_local_shard(out, mesh, blk.placements, blk.shape)
        return out

    def fn(grads):
        return tree_map(psum_one, grads, grad_specs)

    return fn
