"""Pipeline parallelism: the paper's Algorithm 2 on a device mesh
(``repro/train/pipeline_parallel.py``).

The layer stack is partitioned into n stages (the execution trees of the
device dataflow, coarse level); the batch is split into m microbatches
(the horizontal splits, medium level); each microbatch rides through the
stages like a shared cache through activity threads, a point-to-point
send playing the pipeline hand-off.  The GPipe makespan

    T_p(m) = (m + n - 1) * t_stage + overheads  ~=  c/m + (m-1) t_j + n t0

is the paper's §4.2 cost model with t_j = the staggering (slowest) stage,
so Theorem 1's m* = sqrt((c - lambda N)/t0) chooses the microbatch count.

``gpipe_spmd`` runs the schedule on the ranks of a ``stage`` mesh dim:
each holds one stage's parameters, steps t = 0..m+n-2 run in lock step,
and activations go stage i -> i+1 between steps (``batch_isend_irecv``).
"""
from __future__ import annotations

from typing import Any, Callable

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

from ..core.planner import theorem1_m_star
from .optimizer import tree_map


def plan_microbatches(total_net_time: float, n_stages: int, t0: float,
                      m_max: int = 64) -> int:
    """Theorem-1 microbatch count for a pipeline of ``n_stages`` whose total
    per-batch net compute is ``total_net_time`` and per-microbatch fixed
    overhead is ``t0``.  In the paper's terms the staggering activity is
    the slowest stage: with even stages lambda*N = total/n per
    microbatch."""
    c = total_net_time
    lam_N = total_net_time / max(n_stages, 1)
    m = theorem1_m_star(c, 1.0, lam_N, t0, m_max=m_max)
    return max(1, min(int(round(m)), m_max))


def stack_stage_params(param_list) -> Any:
    """[per-stage tree, ...] -> one tree with a leading n_stages dim."""
    return tree_map(lambda *xs: torch.stack(xs), *param_list)


def gpipe_spmd(stage_fn: Callable[[Any, torch.Tensor], torch.Tensor],
               mesh, n_stages: int, m: int, axis: str = "stage"):
    """Returns ``pipelined(stacked_params, xs)``: stacked_params a tree of
    [n_stages, ...] tensors (DTensors sharded over ``axis`` on dim 0, or
    whole tensors of which each rank takes its stage's row), xs [m, mb,
    ...] the same on every rank -> ys [m, mb, ...], the last stage's
    outputs, on every rank.  ``stage_fn`` keeps the activation's shape.

    As in the reference, every stage runs ``stage_fn`` at every step (a
    stage not yet reached works on zeros) and the last stage keeps
    microbatch t - n + 1 from step n - 1 on; at the end its output buffer
    goes to every rank (the reference's masked ``psum``, here a
    broadcast: the same values)."""
    group = mesh.get_group(axis)
    ranks = dist.get_process_group_ranks(group)
    if len(ranks) != n_stages:
        raise ValueError(f"gpipe_spmd: mesh axis {axis!r} has {len(ranks)} "
                         f"ranks for {n_stages} stages")
    sid = mesh.get_local_rank(axis)

    def own_stage(a):
        if isinstance(a, DTensor):
            loc = a.to_local()
            if loc.shape[0] != 1:
                raise ValueError("gpipe_spmd: stage params must be sharded "
                                 f"over {axis!r} on dim 0")
            return loc[0]
        return a[sid]

    @torch.no_grad()
    def pipelined(stacked_params, xs):
        params = tree_map(own_stage, stacked_params)
        if isinstance(xs, DTensor):
            xs = xs.full_tensor()
        h_recv = torch.zeros_like(xs[0])
        outs = torch.zeros_like(xs)
        for t in range(m + n_stages - 1):
            # stage 0 ingests microbatch t while t < m; the others take
            # what the previous stage handed on
            h_in = xs[min(t, m - 1)] if sid == 0 else h_recv
            h_out = stage_fn(params, h_in)
            if sid == n_stages - 1 and t >= n_stages - 1:
                outs[t - (n_stages - 1)] = h_out
            ops = []
            if sid < n_stages - 1:
                ops.append(dist.P2POp(dist.isend, h_out.contiguous(),
                                      ranks[sid + 1], group))
            if sid > 0:
                h_recv = torch.empty_like(h_out)
                ops.append(dist.P2POp(dist.irecv, h_recv, ranks[sid - 1],
                                      group))
            for req in dist.batch_isend_irecv(ops) if ops else ():
                req.wait()
        dist.broadcast(outs, src=ranks[-1], group=group)
        return outs

    return pipelined
