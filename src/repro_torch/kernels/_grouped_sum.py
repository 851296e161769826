"""Launch plan shared by the radix-groupby and segment-sum kernels, which
run the same deterministic partitioned reduction (``csrc/grouped_sum.cuh``).
The plan fixes the row-block size and the slice count from the shapes
alone, so the order of every float addition depends on the input only."""
from __future__ import annotations

from typing import NamedTuple

import torch

PART_GROUPS = 256            # ids per partition (kPartGroups in the .cuh)
MAX_COLS = 32                # value columns; the accumulator fits 48 KB
#: blocks to aim for in the accumulate pass: two waves of the H100's 132 SMs
TARGET_BLOCKS = 264
MAX_SLICES = 64
#: bound on the [row blocks, partitions] histogram (int32 entries), met by
#: growing the row blocks until one block holds every row
MAX_HIST = 1 << 20


class Plan(NamedTuple):
    n_parts: int
    g_pad: int
    rows_per_block: int
    n_blocks: int
    n_slices: int
    int_words: int
    float_words: int


def plan(n: int, n_groups: int, n_cols: int) -> Plan:
    """Workspace sizes and launch shape for ``n`` rows, ``n_groups`` ids and
    ``n_cols`` accumulated columns (values plus the counts column)."""
    if n >= 1 << 31:
        raise ValueError(f"grouped sum over {n} rows: row indices are int32")
    n_parts = max(1, -(-n_groups // PART_GROUPS))
    if n_cols > MAX_COLS + 1:
        raise ValueError(f"grouped sum over {n_cols} columns exceeds the "
                         f"kernel's {MAX_COLS + 1}")
    rows_per_block = 1024
    while (-(-n // rows_per_block) * n_parts > MAX_HIST
           and rows_per_block < n):
        rows_per_block *= 2
    n_blocks = max(1, -(-n // rows_per_block))
    n_slices = max(1, min(MAX_SLICES, -(-TARGET_BLOCKS // n_parts)))
    g_pad = n_parts * PART_GROUPS
    return Plan(n_parts, g_pad, rows_per_block, n_blocks, n_slices,
                int_words=n_blocks * n_parts + n_parts + 1 + 2 * n,
                float_words=n_slices * g_pad * n_cols)


def workspace(p: Plan, device) -> tuple:
    """The int32 and float32 scratch buffers the kernel passes use."""
    return (torch.empty(p.int_words, dtype=torch.int32, device=device),
            torch.empty(max(1, p.float_words), dtype=torch.float32,
                        device=device))
