"""One device's work in a traced step, op by op (the counterpart of
``repro/launch/hlo_cost.py``).

The reference walks the compiled, partitioned HLO of a step and multiplies
loop bodies by their trip counts.  Here the step runs eagerly, every loop
included, and ``OpCounter`` (a ``TorchDispatchMode``) sees each op as it
runs, so no trip count is needed:

    flops       -- ``torch.utils.flop_counter``'s formulas (matmuls,
                   convolutions, attention) and the kernels' own
                   (``torch.ops.repro_torch.flash_attention``,
                   ``mamba_scan``, ``mamba_scan_backward``); elementwise
                   ops count none;
    hbm_bytes   -- operand + result bytes of every op that is not a view
                   or an allocation: each eager op reads its inputs from
                   HBM and writes its outputs there, as each fusion does in
                   the reference's walker; ``copy_``, ``fill_`` and
                   ``zero_`` do not read what they overwrite;
    collectives -- the ``_c10d_functional`` ops (and the eager ``c10d``
                   ones, and DTensor's ``_dtensor.shard_dim_alltoall``) by
                   kind, with their group size g and operand
                   bytes B, and ring-model wire bytes as the reference
                   prices them (``hlo_cost.py:_collective_cost``):
                   all-reduce 2(g-1)/g B, all-gather (g-1) B (B the local
                   part, (g-1)/g of the result), reduce-scatter (g-1)/g B
                   ((g-1) x the result), all-to-all (g-1)/g B, a send B;
    live bytes  -- every storage an op creates, from the op until the
                   storage is freed: ``peak_bytes`` is the most alive at
                   once.

Per device. On DTensors the counter sees rank 0's local work: every rank's
where the shards are even; where they are not, rank 0 holds the largest
shard, as ``torch.chunk`` splits. A dispatch mode sees an op before a
tensor subclass does: for an op on DTensors the counter returns
``NotImplemented``, so DTensor runs it (its redistributions' collectives,
then the op on the local shards), and those local ops come back to the
counter on plain tensors at their local shapes. DTensor's sharding
propagation runs ops of its own at global shapes, on fake tensors to learn
an output's shape and, for an op it has no rule for (torch 2.11:
``softplus``), on meta tensors through the op's decomposition: nothing
that runs inside its propagator (or under a ``FakeTensorMode``) is
counted. The work inside ``local_map`` (``models.layers.on_shards``: the
kernels) runs on plain local tensors and is counted once, as any other
local op.
"""
from __future__ import annotations

import weakref
from typing import Any, Dict, List, Tuple

import torch
from torch._subclasses.fake_tensor import FakeTensor
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry
from torch.utils.weak import WeakIdKeyDictionary

#: collective op (name without its namespace) -> kind: DTensor's
#: functional collectives and all-to-all, the eager all-reduce of the
#: global norm (``train/sharding.sum_of_squares``) and point-to-point sends
#: (``train/pipeline_parallel.py``); any other op of these namespaces fails
#: the trace
_KINDS = {
    "all_reduce": "all-reduce", "allreduce_": "all-reduce",
    "all_gather_into_tensor": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "all_to_all_single": "all-to-all", "shard_dim_alltoall": "all-to-all",
    "send": "collective-permute", "recv_": "collective-permute",
}
_COLLECTIVE_NS = ("_c10d_functional", "c10d", "_dtensor")
#: ops in those namespaces that move nothing
_NOT_COLLECTIVES = {"wait_tensor", "_wrap_tensor_autograd", "barrier"}
#: ops that move no bytes: allocations and no-ops (views go by their schema)
_NO_TRAFFIC = {"aten.empty", "aten.empty_strided", "aten.empty_like",
               "aten.new_empty", "aten.new_empty_strided", "aten.lift_fresh",
               "aten._local_scalar_dense", "_c10d_functional.wait_tensor",
               "_c10d_functional._wrap_tensor_autograd"}
#: ops that write their first operand without reading it
_WRITE_ONLY_FIRST = {"aten.copy_", "aten.fill_", "aten.zero_"}
#: argument names that hold a collective's operand
_OPERAND_ARGS = ("input", "tensors")
#: DTensor's sharding propagator's entry points (torch 2.11 and 2.13)
_PROPAGATOR_ENTRIES = ("propagate", "propagate_op_sharding",
                       "propagate_op_sharding_non_cached")
_UNSET = object()


def _tensors(tree) -> List[torch.Tensor]:
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def _nbytes(ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def wire_bytes(kind: str, operand_bytes: float, g: int) -> float:
    """Ring-model bytes one device sends for a collective of ``kind`` over
    ``g`` ranks whose operand on that device is ``operand_bytes``."""
    if g <= 1:
        return 0.0
    if kind == "all-reduce":
        return 2.0 * operand_bytes * (g - 1) / g
    if kind == "all-gather":
        return float(operand_bytes) * (g - 1)
    if kind in ("reduce-scatter", "all-to-all"):
        return float(operand_bytes) * (g - 1) / g
    if kind == "collective-permute":
        return float(operand_bytes)
    raise ValueError(f"no wire model for collective kind {kind!r}")


def _group_size(bound: Dict[str, Any]) -> int:
    if isinstance(bound.get("group_size"), int):
        return bound["group_size"]
    if isinstance(bound.get("group_name"), str):
        from torch.distributed.distributed_c10d import _resolve_process_group
        return _resolve_process_group(bound["group_name"]).size()
    pg = bound.get("process_group")
    if pg is not None:
        import torch.distributed as dist
        if not isinstance(pg, dist.ProcessGroup):
            pg = dist.ProcessGroup.unbox(pg)
        return pg.size()
    raise ValueError(f"op_cost: no group in the collective's arguments "
                     f"{sorted(bound)}")


class OpCounter(TorchDispatchMode):
    """Counts one device's FLOPs, HBM bytes, collectives and live bytes
    over the ops run inside ``with OpCounter() as c:``.

    ``table`` holds a row an (op, collective kind, group size): calls,
    flops, bytes, operand bytes, wire bytes; the totals are its sums
    (``totals``), so a stored table prices the trace again
    (``launch/dryrun.reanalyze_artifacts``)."""

    def __init__(self):
        super().__init__()
        self.table: Dict[Tuple[str, str, int], List[float]] = {}
        self.live_bytes = 0
        self.peak_bytes = 0
        self._storages = WeakIdKeyDictionary()
        self._propagating = 0
        self._patched: Dict[str, Any] = {}

    def __enter__(self):
        # DTensor's propagator, whose entry points the dispatcher looks up
        # on the instance at each call (the cached one is an instance
        # attribute made at its construction)
        prop = DTensor._op_dispatcher.sharding_propagator
        for name in _PROPAGATOR_ENTRIES:
            fn = getattr(prop, name, None)
            if fn is not None:
                self._patched[name] = prop.__dict__.get(name, _UNSET)
                setattr(prop, name, self._quiet(fn))
        return super().__enter__()

    def __exit__(self, *exc):
        prop = DTensor._op_dispatcher.sharding_propagator
        for name, before in self._patched.items():
            if before is _UNSET:
                delattr(prop, name)
            else:
                setattr(prop, name, before)
        self._patched.clear()
        return super().__exit__(*exc)

    def _quiet(self, fn):
        def run(*args, **kwargs):
            self._propagating += 1
            try:
                return fn(*args, **kwargs)
            finally:
                self._propagating -= 1
        return run

    # ---- dispatch
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        flat = tree_flatten((args, kwargs))[0]
        if any(isinstance(a, DTensor) for a in flat):
            return NotImplemented                 # DTensor's local ops
        out = func(*args, **kwargs)
        if (self._propagating
                or any(isinstance(a, FakeTensor) for a in flat)
                or torch._C._get_dispatch_mode(
                    torch._C._TorchDispatchModeKey.FAKE) is not None):
            return out                            # sharding propagation
        self._count(func, args, kwargs, out)
        return out

    def _count(self, func, args, kwargs, out) -> None:
        packet = func._overloadpacket
        name = str(packet)
        ins, outs = _tensors((args, kwargs)), _tensors(out)
        flops = 0
        if packet in flop_registry:
            flops = flop_registry[packet](*args, **kwargs, out_val=out)
        if func.is_view or name in _NO_TRAFFIC:
            moved = 0
        elif name in _WRITE_ONLY_FIRST:
            moved = _nbytes(_tensors((args[1:], kwargs))) + _nbytes(outs)
        else:
            moved = _nbytes(ins) + _nbytes(outs)
        kind, g, operand, wire = "", 1, 0, 0.0
        ns, _, short = name.partition(".")
        if ns in _COLLECTIVE_NS and short not in _NOT_COLLECTIVES:
            if short not in _KINDS:
                raise ValueError(f"op_cost: no wire model for {name}")
            kind = _KINDS[short]
            bound = dict(zip((a.name for a in func._schema.arguments), args))
            bound.update(kwargs)
            g = _group_size(bound)
            operand = _nbytes(_tensors([bound[a] for a in _OPERAND_ARGS
                                        if a in bound]))
            wire = wire_bytes(kind, operand, g)
        row = self.table.setdefault((name, kind, g), [0, 0, 0, 0, 0.0])
        row[0] += 1
        row[1] += flops
        row[2] += moved
        row[3] += operand
        row[4] += wire
        self._track(ins, outs)

    def _track(self, ins, outs) -> None:
        """Adds each output storage that no input holds and that is not
        tracked yet; a finalizer takes it off when it dies."""
        held = {id(t.untyped_storage()) for t in ins}
        for t in outs:
            st = t.untyped_storage()
            if id(st) in held or st in self._storages:
                continue
            n = st.nbytes()
            self._storages[st] = n
            weakref.finalize(st, self._free, n)
            self.live_bytes += n
            self.peak_bytes = max(self.peak_bytes, self.live_bytes)

    def _free(self, n: int) -> None:
        self.live_bytes -= n

    # ---- results
    def rows(self) -> List[Dict[str, Any]]:
        return [{"op": op, "kind": kind, "group": g, "calls": r[0],
                 "flops": r[1], "bytes": r[2], "operand_bytes": r[3],
                 "wire_bytes": r[4]}
                for (op, kind, g), r in sorted(self.table.items())]

    def totals(self) -> Dict[str, Any]:
        return totals(self.rows())


def totals(rows: List[Dict[str, Any]]) -> Dict[str, Any]:
    """flops, hbm_bytes and the collectives by kind (operand bytes, wire
    bytes, counts) over a table's rows."""
    out: Dict[str, Any] = {"flops": 0.0, "hbm_bytes": 0.0,
                           "operand_bytes": {}, "wire_bytes": {},
                           "counts": {}}
    for r in rows:
        out["flops"] += r["flops"]
        out["hbm_bytes"] += r["bytes"]
        k = r["kind"]
        if k:
            for key, v in (("operand_bytes", r["operand_bytes"]),
                           ("wire_bytes", r["wire_bytes"]),
                           ("counts", r["calls"])):
                out[key][k] = out[key].get(k, 0.0) + v
    return out
