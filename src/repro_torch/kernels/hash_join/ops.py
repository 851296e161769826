"""Public hash-probe op: the CUDA kernel ``csrc/hash_probe.cu`` on a CUDA
tensor, the plain torch version on a CPU tensor.

It replaces the TPU kernel ``repro/kernels/hash_join/kernel.py``:
``_hash_probe_kernel`` / ``hash_probe_pallas``.  Bound on the card: bytes
(key columns in, ``idx``/``found`` out; the table is L2-resident), so the
kernel is one thread per probe row with coalesced loads and stores and an
early-exit probe loop.  Its time, launches and bound on the H100 are in
PERF.md."""
from __future__ import annotations

import ctypes
from typing import Sequence, Tuple

import torch

from .. import _cuda
from .ref import hash_probe_ref

MAX_KEY_COLS = 4


def hash_probe(slot_keys: Sequence[torch.Tensor], slot_idx: torch.Tensor,
               val_cols: Sequence[torch.Tensor], max_probes: int,
               impl: str = "auto") -> Tuple[torch.Tensor, torch.Tensor]:
    """Probe an open-addressing hash table: returns ``(idx, found)`` where
    ``idx[i]`` is the build's first-occurrence row index of ``val_cols[i]``
    (0 when not found) and ``found[i]`` marks presence.

    impl: 'auto' (the kernel for CUDA tensors, the plain version for CPU
    tensors), 'cuda' (the kernel; anything else raises) or 'reference' (the
    plain version on any device)."""
    slot_keys = tuple(slot_keys)
    val_cols = tuple(val_cols)
    on_cuda = val_cols[0].is_cuda
    if impl == "reference" or (impl == "auto" and not on_cuda):
        return hash_probe_ref(slot_keys, slot_idx, val_cols, max_probes)
    if impl not in ("auto", "cuda"):
        raise ValueError(f"unknown hash_probe impl {impl!r}")
    return hash_probe_cuda(slot_keys, slot_idx, val_cols, max_probes)


def hash_probe_cuda(slot_keys: Sequence[torch.Tensor], slot_idx: torch.Tensor,
                    val_cols: Sequence[torch.Tensor], max_probes: int
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch ``csrc/hash_probe.cu`` on int32 CUDA tensors."""
    k = len(val_cols)
    if not 1 <= k <= MAX_KEY_COLS or len(slot_keys) != k:
        raise ValueError(f"hash_probe takes 1..{MAX_KEY_COLS} key columns "
                         f"with one slot-key array each, got {k} and "
                         f"{len(slot_keys)}")
    device = val_cols[0].device
    n = val_cols[0].shape[0]
    table = slot_idx.shape[0]
    if table & (table - 1):
        raise ValueError(f"table size {table} is not a power of two")
    _cuda.require(slot_idx, "slot_idx", torch.int32, 1, device)
    for i, (sk, v) in enumerate(zip(slot_keys, val_cols)):
        _cuda.require(sk, f"slot_keys[{i}]", torch.int32, 1, device)
        _cuda.require(v, f"val_cols[{i}]", torch.int32, 1, device)
        if sk.shape[0] != table or v.shape[0] != n:
            raise ValueError("hash_probe: ragged key columns")
    idx = torch.empty(n, dtype=torch.int32, device=device)
    found = torch.empty(n, dtype=torch.bool, device=device)
    if n == 0:
        return idx, found
    lib = _cuda.library()
    vals_p = (ctypes.c_void_p * k)(*[v.data_ptr() for v in val_cols])
    keys_p = (ctypes.c_void_p * k)(*[s.data_ptr() for s in slot_keys])
    with _cuda.device_guard(idx):
        _cuda.count_launch("hash_probe")
        rc = lib.repro_hash_probe(vals_p, keys_p, slot_idx.data_ptr(), k,
                                  table, int(max_probes), n, idx.data_ptr(),
                                  found.data_ptr(), _cuda.stream_ptr(idx))
    _cuda.check(rc, "hash_probe")
    return idx, found
