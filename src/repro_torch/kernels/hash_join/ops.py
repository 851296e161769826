"""Public hash-probe op: the CUDA kernel ``csrc/hash_probe.cu`` on a CUDA
tensor, the plain torch version on a CPU tensor.

It replaces the TPU kernel ``repro/kernels/hash_join/kernel.py``:
``_hash_probe_kernel`` / ``hash_probe_pallas``.  Bound on the card: bytes
(key columns in, ``idx``/``found`` out; the table is L2-resident).  The
kernel probes a packed table (:func:`pack_table`: each slot's keys and row
side by side, so one probe step is one vector gather) from L2, and takes
four rows a thread with all their first gathers in flight.  A call is
short (about 0.01 ms on the device at the SSB shapes), so the wrapper keeps
its host work small: the table is validated once, when it is packed, and a
call checks only the probe columns.  Its time, launches and bound on the
H100 are in PERF.md."""
from __future__ import annotations

from typing import NamedTuple, Sequence, Tuple

import torch

from .. import _cuda
from .ref import hash_probe_packed_ref, pack_slots

MAX_KEY_COLS = 4


class PackedTable(NamedTuple):
    """A hash table packed for the probe (made by :func:`pack_table`,
    which validates it once)."""
    #: int32 [size, SLOT_WORDS[n_keys]]: keys, row index (< 0: empty), zeros
    slots: torch.Tensor
    n_keys: int
    #: slots, a power of two
    size: int


def pack_table(slot_keys: Sequence[torch.Tensor], slot_idx: torch.Tensor
               ) -> PackedTable:
    """Pack ``hash_build``'s slot arrays (int32, on one device) into the
    interleaved table, on their device: no host transfer."""
    slot_keys = tuple(slot_keys)
    k = len(slot_keys)
    if not 1 <= k <= MAX_KEY_COLS:
        raise ValueError(f"hash_probe takes 1..{MAX_KEY_COLS} key columns, "
                         f"got {k}")
    size = slot_idx.shape[0]
    if slot_idx.dim() != 1 or size < 1 or size & (size - 1):
        raise ValueError(f"table size {tuple(slot_idx.shape)} is not a "
                         f"power of two")
    for i, t in enumerate((slot_idx,) + slot_keys):
        if t.dtype != torch.int32 or tuple(t.shape) != (size,):
            raise ValueError(f"slot array {i}: {t.dtype} {tuple(t.shape)}, "
                             f"expected int32 ({size},)")
        if t.device != slot_idx.device:
            raise ValueError(f"slot array {i} is on {t.device}, expected "
                             f"{slot_idx.device}")
    return PackedTable(pack_slots(slot_keys, slot_idx), k, size)


def hash_probe(table: PackedTable, val_cols: Sequence[torch.Tensor],
               max_probes: int, impl: str = "auto"
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Probe a packed open-addressing hash table (:func:`pack_table`):
    returns ``(idx, found)`` where ``idx[i]`` is the build's first-
    occurrence row index of ``val_cols[i]`` (0 when not found) and
    ``found[i]`` marks presence.

    impl: 'auto' (the kernel for CUDA tensors, the plain version for CPU
    tensors), 'cuda' (the kernel; anything else raises) or 'reference' (the
    plain version on any device)."""
    val_cols = tuple(val_cols)
    if impl == "reference" or (impl == "auto" and not val_cols[0].is_cuda):
        return hash_probe_packed_ref(table.slots, table.n_keys, val_cols,
                                     max_probes)
    if impl not in ("auto", "cuda"):
        raise ValueError(f"unknown hash_probe impl {impl!r}")
    return hash_probe_cuda(table, val_cols, max_probes)


def hash_probe_cuda(table: PackedTable, val_cols: Sequence[torch.Tensor],
                    max_probes: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch ``csrc/hash_probe.cu`` on int32 CUDA key columns against a
    packed table."""
    k = table.n_keys
    if len(val_cols) != k:
        raise ValueError(f"hash_probe: {len(val_cols)} key columns against "
                         f"a table of {k}")
    slots = table.slots
    device = slots.device
    n = val_cols[0].shape[0]
    for i, v in enumerate(val_cols):
        if (not v.is_cuda or v.device != device or v.dtype != torch.int32
                or v.dim() != 1 or not v.is_contiguous()):
            _cuda.require(v, f"val_cols[{i}]", torch.int32, 1, device)
            raise ValueError(f"val_cols[{i}] is not a contiguous int32 "
                             f"column on {device}")
        if v.shape[0] != n:
            raise ValueError("hash_probe: ragged key columns")
    idx = torch.empty(n, dtype=torch.int32, device=device)
    found = torch.empty(n, dtype=torch.bool, device=device)
    if n == 0:
        return idx, found
    ptrs = [v.data_ptr() for v in val_cols] + [None] * (MAX_KEY_COLS - k)
    with _cuda.device_guard(idx):
        _cuda.count_launch("hash_probe")
        rc = _cuda.library().repro_hash_probe(
            slots.data_ptr(), k, table.size, int(max_probes), n, *ptrs,
            idx.data_ptr(), found.data_ptr(), _cuda.stream_ptr(idx))
    _cuda.check(rc, "hash_probe")
    return idx, found
