"""Host-side open-addressing build and the plain torch probe for the hash
join.

The build runs ONCE per dimension table on the host (numpy) and the probe
runs per chunk on the device, so the two halves must agree bit-for-bit on
the hash function: a murmur3-style fmix32 finalizer over each key's low 32
bits (the device key columns are 32-bit anyway).

The plain torch hash computes fmix32 in int64 masked to 32 bits, because
torch on the CPU has no right shift for ``uint32``; it is bit-identical to
:func:`hash_keys_np` and to the CUDA kernel's native ``uint32`` arithmetic.

Duplicate keys keep the FIRST occurrence (lowest row index).  Built over a
``DimTable``'s sorted key column this makes the probe's gather index equal
to ``searchsorted``'s leftmost-duplicate index, so the hash route is
byte-compatible with the legacy sorted-probe route; over an arbitrary
(shuffled) key order it is simply first-occurrence-wins.
"""
from __future__ import annotations

from typing import Dict, Sequence, Tuple

import numpy as np
import torch

#: murmur3 fmix32 constants — shared by the host build and the device probe
_FMIX_C1 = 0x85EB_CA6B
_FMIX_C2 = 0xC2B2_AE35
#: per-key-column mixing multiplier (odd => bijective mod 2^32)
_COL_MIX = 0x9E37_79B9
_MASK32 = 0xFFFF_FFFF


def _fmix32_np(h: np.ndarray) -> np.ndarray:
    h = h.astype(np.uint32)
    h ^= h >> np.uint32(16)
    h *= np.uint32(_FMIX_C1)
    h ^= h >> np.uint32(13)
    h *= np.uint32(_FMIX_C2)
    h ^= h >> np.uint32(16)
    return h


def hash_keys_np(key_cols: Sequence[np.ndarray]) -> np.ndarray:
    """uint32 combined hash of one or more integer key columns (host)."""
    h = np.zeros(len(key_cols[0]), dtype=np.uint32)
    for k in key_cols:
        h = _fmix32_np(h ^ (np.asarray(k).astype(np.uint32)
                            * np.uint32(_COL_MIX)))
    return h


def hash_keys(key_cols: Sequence[torch.Tensor]) -> torch.Tensor:
    """Combined hash of integer key tensors as int64 values in [0, 2^32) —
    bit-identical to :func:`hash_keys_np`.  int64 products wrap modulo
    2^64, which keeps their low 32 bits exact."""
    h = torch.zeros(key_cols[0].shape[0], dtype=torch.int64,
                    device=key_cols[0].device)
    for k in key_cols:
        h = h ^ ((k.to(torch.int64) & _MASK32) * _COL_MIX & _MASK32)
        h = h ^ (h >> 16)
        h = (h * _FMIX_C1) & _MASK32
        h = h ^ (h >> 13)
        h = (h * _FMIX_C2) & _MASK32
        h = h ^ (h >> 16)
    return h


def _next_pow2(x: int) -> int:
    return 1 << max(4, (x - 1).bit_length())


def hash_build(key_cols: Sequence[np.ndarray]) -> Dict[str, object]:
    """Open-addressing (linear probing) build over ``d`` rows of one or more
    integer key columns, vectorized on the host.

    Returns ``{"slot_keys": tuple_of_[T]_arrays, "slot_idx": int32 [T],
    "table_size": T, "max_probes": int}`` — ``slot_idx[t] < 0`` marks an
    empty slot, ``max_probes`` is a static probe-length bound (longest
    occupied run + 1), so a probe loop with that trip count always
    terminates at a hit or an empty slot.

    Insertion processes rows in index order, one probe distance per round,
    so equal keys keep the FIRST row index and colliding distinct keys are
    placed deterministically (lowest index wins a free slot).  Table size is
    the next power of two >= 2*d (load factor <= 0.5)."""
    key_cols = [np.asarray(k) for k in key_cols]
    d = len(key_cols[0])
    if any(len(k) != d for k in key_cols):
        raise ValueError("hash_build: key columns must share a length")
    size = _next_pow2(max(2 * max(d, 1), 16))
    mask = np.uint32(size - 1)

    slot_idx = np.full(size, -1, dtype=np.int32)
    slot_keys = [np.zeros(size, dtype=k.dtype) for k in key_cols]
    if d:
        h0 = hash_keys_np(key_cols)
        live = np.arange(d, dtype=np.int64)     # unplaced rows, index order
        step = np.uint32(0)
        while live.size:
            cand = ((h0[live] + step) & mask).astype(np.int64)
            occ = slot_idx[cand]
            # drop duplicates of an already-placed identical key (keep-first)
            dup = occ >= 0
            for sk, k in zip(slot_keys, key_cols):
                dup &= sk[cand] == k[live]
            placeable = occ < 0
            if placeable.any():
                # lowest row index wins each contested free slot this round
                slots = cand[placeable]
                rows = live[placeable]
                _, first = np.unique(slots, return_index=True)
                slot_idx[slots[first]] = rows[first]
                won = np.zeros(len(rows), dtype=bool)
                won[first] = True
                for sk, k in zip(slot_keys, key_cols):
                    sk[slots[first]] = k[rows[first]]
                placed = np.zeros(len(live), dtype=bool)
                placed[np.flatnonzero(placeable)[won]] = True
            else:
                placed = np.zeros(len(live), dtype=bool)
            live = live[~(placed | dup)]
            step += np.uint32(1)

    # static probe bound: longest run of occupied slots (+1 for the empty
    # terminator), computed on the doubled table to cover wraparound
    occ2 = np.concatenate([slot_idx >= 0, slot_idx >= 0]).astype(np.int8)
    max_run = _longest_run(occ2)
    max_probes = int(min(max_run, size) + 1)
    return {"slot_keys": tuple(slot_keys), "slot_idx": slot_idx,
            "table_size": size, "max_probes": max_probes}


def _longest_run(flags: np.ndarray) -> int:
    """Length of the longest run of ones in a 0/1 array."""
    if not flags.any():
        return 0
    edges = np.flatnonzero(np.diff(np.concatenate([[0], flags, [0]])))
    return int((edges[1::2] - edges[0::2]).max())


def hash_probe_ref(slot_keys: Sequence[torch.Tensor], slot_idx: torch.Tensor,
                   val_cols: Sequence[torch.Tensor], max_probes: int
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain torch probe: returns ``(row_idx int32, found bool)`` per probe
    row.  ``row_idx`` is the build's first-occurrence index for found keys
    and 0 for misses (callers gate every gather on ``found``).  The loop
    runs ``max_probes`` vectorized steps; a done-mask freezes resolved
    rows."""
    size = slot_idx.shape[0]
    n = val_cols[0].shape[0]
    device = val_cols[0].device
    h = hash_keys(list(val_cols))
    idx = torch.zeros(n, dtype=torch.int32, device=device)
    found = torch.zeros(n, dtype=torch.bool, device=device)
    done = torch.zeros(n, dtype=torch.bool, device=device)
    for step in range(int(max_probes)):
        cand = (h + step) & (size - 1)
        occ = slot_idx[cand]
        eq = torch.ones(n, dtype=torch.bool, device=device)
        for sk, v in zip(slot_keys, val_cols):
            eq &= sk[cand] == v
        hit = ~done & (occ >= 0) & eq
        miss = ~done & (occ < 0)
        idx = torch.where(hit, occ.to(torch.int32), idx)
        found |= hit
        done |= hit | miss
    return idx, found


#: int32 words of a packed slot for 1-4 key columns: the keys, then the row
#: index, padded with zeros to 8, 16 or 32 bytes (``csrc/hash_probe.cu``)
SLOT_WORDS = {1: 2, 2: 4, 3: 4, 4: 8}


def pack_slots(slot_keys: Sequence[torch.Tensor], slot_idx: torch.Tensor
               ) -> torch.Tensor:
    """The interleaved table ``int32 [T, SLOT_WORDS[k]]`` of ``k`` slot-key
    arrays and the slot rows, on their device: row ``s`` holds
    ``slot_keys[0][s], ..., slot_keys[k-1][s], slot_idx[s]``, then zeros."""
    k = len(slot_keys)
    out = torch.zeros((slot_idx.shape[0], SLOT_WORDS[k]), dtype=torch.int32,
                      device=slot_idx.device)
    for c, sk in enumerate(slot_keys):
        out[:, c] = sk
    out[:, k] = slot_idx
    return out


def hash_probe_packed_ref(slots: torch.Tensor, n_keys: int,
                          val_cols: Sequence[torch.Tensor], max_probes: int
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain probe over a packed table (:func:`pack_slots`): reads each
    slot's keys and row from its words, as the kernel does, and returns
    what :func:`hash_probe_ref` returns over the unpacked arrays."""
    return hash_probe_ref(tuple(slots[:, c] for c in range(n_keys)),
                          slots[:, n_keys], val_cols, max_probes)
