"""Launch plan shared by the radix-groupby and segment-sum kernels, which run
the same deterministic grouped sum (``csrc/grouped_sum.cuh``).

Three routes, chosen from the shapes alone:

- **direct**, when a warp's partial (``n_groups x cols`` floats, ``cols``
  the value columns plus the counts column) fits ``WIDE_FLOATS``: one
  cooperative launch.  Each block takes a fixed row range; its warps add
  32 rows at a time into per-warp shared partials (rows of one id in row
  order); the block sums its warps in warp order; after a grid-wide
  barrier the block partials are summed in a fixed order.
  - narrow, partials within ``DIRECT_FLOATS`` (48 KB a block): the grid
    never exceeds ``TARGET_BLOCKS``, so every block is resident at once.
  - **wide** (``is_wide``), partials within ``WIDE_FLOATS`` (224 KB a
    block, Hopper's opt-in shared memory): one block an SM, within the
    blocks the card holds at once at that shared memory, which the
    kernel library reports (``wide_blocks``: the occupancy API times the
    SMs).  The supplier shard (2,000 ids with counts) and its combiner
    take it.
- **partitioned**, for larger id spaces (the part key's 200,000 ids, the
  customer key's 30,000, 2^20 dense cells, the sort route's segments): two
  cooperative launches.  The first is a stable counting sort by partition
  (``part_width`` ids: about ``PART_TARGET`` partitions, within 4,096 ids
  at one column down to 128 at 33) that moves each row's record (local
  id, values) into its partition's range; the second sums each
  partition's records in row order, warp partials in shared memory summed
  in warp order, with ``n_slices`` slices a partition summed in slice
  order where partitions are few and long.  A partition block sorts
  ``part_tile`` rows at a time in shared memory and writes each
  partition's run of them whole; where its counters leave no room for a
  tile, warps' counters sit in global memory (``GLOBAL_HIST`` entries)
  and records go out one by one.

The plan fixes the row ranges and slice counts from ``n``, ``n_groups``,
the column count and, on the wide route, the card's co-resident blocks,
so the order of every float addition depends on the input and the card
only (the partitioned route's on the input and the shapes alone: its
grids, which the kernel library takes from the card, do not change it).
It is cached: the same shapes give the same plan object.
Bound: bytes, about 0.2 us at the SSB shapes, below one launch's cost, so
at those shapes the call's host work and its one launch are the time."""
from __future__ import annotations

import ctypes
import functools
from typing import Dict, NamedTuple, Optional, Tuple

import torch

from . import _cuda

MAX_COLS = 32                # value columns (C); the counts column is extra
DIRECT_WARPS = 8             # warps a direct-route block (kDirectWarps)
#: floats of shared memory a narrow direct-route warp may hold: 48 KB over
#: its block's 8 warps (kDirectFloats)
DIRECT_FLOATS = 12288 // DIRECT_WARPS
#: floats a wide-route warp may hold: 8 warps in 224 KB of the 227 KB of
#: shared memory a block may opt into (kWideFloats)
WIDE_FLOATS = 7168
#: blocks to aim for: two per SM of the H100's 132.  The direct route's
#: grid never exceeds it (kDirectMaxBlocks), so it is co-resident
TARGET_BLOCKS = 264
#: warps a block of the partitioned route's two kernels (kPartWarps)
PART_WARPS = 8
#: log2 of a partition's ids, at most and at least (kPartLogMax/Min)
PART_LOG_MAX, PART_LOG_MIN = 12, 5
#: partitions the width aims for at most (kPartTarget)
PART_TARGET = 256
#: a partition block's dynamic shared memory at most (kPartSmemBytes), and
#: the most that leaves room for a second block on an SM (kPartSmemTwo),
#: which a tile of TILE_TWO rows or more takes (kTileTwo)
PART_SMEM_BYTES, PART_SMEM_TWO, TILE_TWO = 221_184, 110_592, 2048
#: rows a partition block sorts in shared memory at a time, at most and at
#: least (kTileMax, kTileMin)
TILE_MAX, TILE_MIN = 4096, 1024
#: the histogram's rows with counters in shared memory: the partition
#: pass's most blocks (its grid is also within what the card holds)
PART_MAX_BLOCKS = 264
#: the histogram's most entries with counters in global memory, one row of
#: n_parts a warp of rows
GLOBAL_HIST = 1 << 22
#: (partition, slice) items the accumulate pass aims for, and the rows a
#: slice holds at least: slices only where partitions are few and long
#: (fewer than 2 x SLICE_TARGET items of WIDE_FLOATS floats of partials)
SLICE_TARGET = TARGET_BLOCKS
SLICE_ROWS = 4096


class Plan(NamedTuple):
    #: one cooperative launch (narrow or wide); else partitioned (two)
    direct: bool
    #: direct route: a block's rows
    rows_per_block: int
    #: direct route: the grid; partitioned: the histogram's rows (the
    #: partition pass's most blocks, or its global counters' warps)
    n_blocks: int
    #: partitioned route: partitions, padded id space, slices a partition
    n_parts: int
    g_pad: int
    n_slices: int
    int_words: int
    float_words: int
    #: the direct route's partials past 48 KB of shared memory
    wide: bool = False

    @property
    def launches(self) -> int:
        """Device kernels a call launches."""
        return 1 if self.direct else 2

    @property
    def route(self) -> str:
        """``narrow``, ``wide`` or ``partitioned``."""
        if not self.direct:
            return "partitioned"
        return "wide" if self.wide else "narrow"


def part_width(n_groups: int, cols: int) -> int:
    """Ids a partition holds (``part_log_width``): the fewest, a power of
    two of 32 or more, that cut ``n_groups`` ids into ``PART_TARGET``
    partitions at most, within the most whose warp partial of ids x
    ``cols`` floats fits ``WIDE_FLOATS``."""
    top = PART_LOG_MAX
    while top > PART_LOG_MIN and (1 << top) * cols > WIDE_FLOATS:
        top -= 1
    log_w = PART_LOG_MIN
    while log_w < top and -(-n_groups // (1 << log_w)) > PART_TARGET:
        log_w += 1
    return 1 << log_w


def part_tile(n_parts: int, n_values: int) -> int:
    """Rows a partition block sorts at a time in shared memory
    (``part_tile``): the most, a multiple of 256 up to ``TILE_MAX``, whose
    records (1 + C words) and slots fit beside the block's 18 n_parts + 1
    counters and masks in ``PART_SMEM_TWO`` (two blocks an SM) where that
    leaves ``TILE_TWO`` rows, else in ``PART_SMEM_BYTES``; 0 (counters in
    global memory) below ``TILE_MIN``."""
    def fit(budget: int) -> int:
        free = max(0, budget - (18 * n_parts + 1) * 4)
        return min(TILE_MAX, free // ((2 + n_values) * 4) // 256 * 256)
    if fit(PART_SMEM_TWO) >= TILE_TWO:
        return fit(PART_SMEM_TWO)
    return fit(PART_SMEM_BYTES) if fit(PART_SMEM_BYTES) >= TILE_MIN else 0


def is_direct(n_groups: int, n_values: int, with_counts: bool) -> bool:
    """One cooperative launch, narrow or wide: the route test of
    ``direct_route`` in ``csrc/grouped_sum.cuh``."""
    return n_groups * (n_values + int(with_counts)) <= WIDE_FLOATS


def is_wide(n_groups: int, n_values: int, with_counts: bool) -> bool:
    """The direct route past 48 KB of partials: ``wide_route`` in
    ``csrc/grouped_sum.cuh``."""
    return (is_direct(n_groups, n_values, with_counts)
            and n_groups * (n_values + int(with_counts)) > DIRECT_FLOATS)


@functools.lru_cache(maxsize=256)
def plan(n: int, n_groups: int, n_values: int, with_counts: bool,
         wide_blocks: int = 0) -> Plan:
    """Launch shape and workspace for ``n`` rows, ``n_groups`` ids and
    ``n_values`` value columns, plus a counts column when ``with_counts``.
    ``wide_blocks``: on the wide route, the blocks the card holds at once
    (:func:`wide_blocks`), which caps its grid; the other routes ignore
    it."""
    if n >= 1 << 31:
        raise ValueError(f"grouped sum over {n} rows: row indices are int32")
    if not 0 <= n_values <= MAX_COLS:
        raise ValueError(f"grouped sum over {n_values} value columns: the "
                         f"kernel takes 0 to {MAX_COLS}")
    cols = n_values + int(with_counts)
    if is_direct(n_groups, n_values, with_counts):
        wide = is_wide(n_groups, n_values, with_counts)
        if wide and wide_blocks < 1:
            raise ValueError(f"grouped sum of {n_groups * cols} cells takes "
                             f"the wide route, whose grid needs the card's "
                             f"co-resident blocks (wide_blocks)")
        cap = wide_blocks if wide else TARGET_BLOCKS
        # a warp's rows: whole batches of 32, as few as keep the grid within
        # the cap
        per_warp = -(-n // (cap * DIRECT_WARPS))
        per_warp = max(32, -(-per_warp // 32) * 32)
        rows_per_block = DIRECT_WARPS * per_warp
        n_blocks = max(1, -(-n // rows_per_block))
        partials = n_blocks * n_groups * cols if n_blocks > 1 else 0
        return Plan(True, rows_per_block, n_blocks, 0, 0, 0, int_words=0,
                    float_words=partials, wide=wide)
    width = part_width(n_groups, cols)
    n_parts = max(1, -(-n_groups // width))
    g_pad = n_parts * width
    hist_rows = (PART_MAX_BLOCKS if part_tile(n_parts, n_values)
                 else max(1, min(PART_MAX_BLOCKS * PART_WARPS,
                                 GLOBAL_HIST // n_parts)))
    # slices fill the card where partitions are few, each of SLICE_ROWS
    # rows at least
    n_slices = max(1, min(-(-SLICE_TARGET // n_parts),
                          n // (n_parts * SLICE_ROWS)))
    partials = n_slices * g_pad * cols if n_slices > 1 else 0
    return Plan(False, 0, hist_rows, n_parts, g_pad, n_slices,
                int_words=hist_rows * n_parts + 2 * n_parts + 1,
                float_words=n * (1 + n_values) + partials)


#: the direct route's scratch, one buffer per (device, stream) holding the
#: most block partials a plan has asked for: the narrow route's most
#: (1.6 MB) at first, grown to the wide route's cells x blocks (at most
#: about 3.9 MB at 132 SMs) by the first wide plan that needs more.
#: Launches on one stream run in order, so each reuses its stream's buffer,
#: as the caching allocator reuses a block freed on that stream (also the
#: one a growth replaces); it saves a host-bound call an allocation
_direct_scratch: Dict[Tuple[int, int], torch.Tensor] = {}


def workspace(p: Plan, device: torch.device, stream: int) -> tuple:
    """Scratch for one launch on ``stream``: the direct route's block
    partials from the stream's buffer, or one allocation of the partitioned
    route's int32 words, then its float32 words.  Returns the tensor (to
    keep it alive through the launch) and the two addresses the entry
    points take (None where the plan needs none)."""
    if p.direct:
        if p.float_words == 0:
            return None, None, None
        key = (device.index, stream)
        buf = _direct_scratch.get(key)
        if buf is None or buf.numel() < p.float_words:
            buf = _direct_scratch[key] = torch.empty(
                max(p.float_words, TARGET_BLOCKS * DIRECT_FLOATS),
                dtype=torch.float32, device=device)
        return buf, None, buf.data_ptr()
    buf = torch.empty(p.int_words + p.float_words, dtype=torch.int32,
                      device=device)
    base = buf.data_ptr()
    return buf, base, base + 4 * p.int_words


@functools.lru_cache(maxsize=256)
def wide_blocks(name: str, device: int, n_values: int, with_counts: bool,
                n_groups: int) -> int:
    """The wide route's grid for ``csrc/<name>.cu`` on CUDA device
    ``device``, these columns and ids: one block an SM, within the blocks
    the card holds at once (the occupancy API at the launch's threads and
    shared memory, times the SMs; one query a shape and device).  More
    blocks an SM, where smaller partials allow them, only add block
    partials and final sums: at the supplier shard three an SM took 0.049
    ms against one's 0.041 (PERF.md)."""
    out = ctypes.c_int(0)
    with torch.cuda.device(device):
        rc = getattr(_cuda.library(), f"repro_{name}_wide_blocks")(
            n_values, int(with_counts), n_groups, ctypes.byref(out))
        sms = torch.cuda.get_device_properties(device).multi_processor_count
    _cuda.check(rc, f"{name} wide route")
    if out.value < 1:
        raise RuntimeError(f"{name}: no wide-route block of {n_groups} ids "
                           f"and {n_values} columns fits an SM")
    return min(out.value, sms)


def in_column_batches(batch_sum, ids: torch.Tensor, values: torch.Tensor,
                      n_groups: int, with_counts: bool
                      ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Grouped sums of any number of value columns through ``batch_sum``,
    which takes at most ``MAX_COLS``: ``batch_sum(ids, values [N, c],
    n_groups, with_counts, out [n_groups, c]) -> (out, counts or None)``
    writes a batch's sums into ``out``.

    Each batch of at most MAX_COLS columns is one call, which reads its
    column slice of ``values`` and writes its column slice of one output in
    place (slices, not copies); only the first asks for the counts.  Every
    column is summed on its own (in the kernel and in the plain version
    alike), in an order that depends on the ids alone, so a column's sums
    do not depend on which batch it lands in: the result is bit-identical
    to one call over all the columns, and two runs are bit-identical.  No
    float atomics."""
    c = values.shape[1]
    sums = values.new_empty((n_groups, c))
    counts = None
    for c0 in range(0, c, MAX_COLS):
        c1 = min(c0 + MAX_COLS, c)
        _, got = batch_sum(ids, values[:, c0:c1], n_groups,
                           with_counts and c0 == 0, sums[:, c0:c1])
        if c0 == 0:
            counts = got
    return sums, counts


def launch(name: str, ids: torch.Tensor, values: torch.Tensor, n_groups: int,
           with_counts: bool) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Launch ``csrc/<name>.cu`` (``radix_groupby`` with counts,
    ``segment_sum`` without): ids int32 [N], values float32 [N, C], both
    contiguous CUDA tensors on one device.  Returns ``sums [n_groups, C]``
    and ``counts [n_groups]`` (None without counts).  More than MAX_COLS
    columns take one launch a batch of MAX_COLS (:func:`in_column_batches`).
    A call at the SSB shapes is host-bound, so it does no Python work the
    launch does not need."""
    _cuda.require(ids, "ids", torch.int32, 1)
    _cuda.require(values, "values", torch.float32, 2, ids.device)
    n, c = values.shape
    if ids.shape[0] != n:
        raise ValueError(f"{name}: ids has {ids.shape[0]} rows, values {n}")
    n_groups = int(n_groups)
    if c > MAX_COLS:
        return in_column_batches(functools.partial(_launch_batch, name),
                                 ids, values, n_groups, with_counts)
    return _launch_batch(name, ids, values, n_groups, with_counts)


def _launch_batch(name: str, ids: torch.Tensor, values: torch.Tensor,
                  n_groups: int, with_counts: bool,
                  sums: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """One launch over at most MAX_COLS value columns (checked by
    :func:`launch`).  ``values`` and ``sums`` (allocated when None) may be
    column slices of wider matrices: the kernel takes their row strides.
    The radix-groupby entry point skips the counts when it is given no
    counts buffer."""
    n, c = values.shape
    if sums is None:
        sums = ids.new_empty((n_groups, c), dtype=torch.float32)
    counts = (ids.new_empty(n_groups, dtype=torch.float32) if with_counts
              else None)
    if n_groups == 0 or c + with_counts == 0:
        return sums.zero_(), counts
    p = plan(n, n_groups, c, with_counts,
             wide_blocks(name, ids.get_device(), c, with_counts, n_groups)
             if is_wide(n_groups, c, with_counts) else 0)
    stream = _cuda.stream_ptr(ids)
    ws, iws, fws = workspace(p, ids.device, stream)  # ws: alive to launch
    out = ((sums.data_ptr(), sums.stride(0),
            counts.data_ptr() if with_counts else None)
           if name == "radix_groupby" else (sums.data_ptr(), sums.stride(0)))
    entry = getattr(_cuda.library(), f"repro_{name}")
    with _cuda.device_guard(ids):
        _cuda.count_launch(name)
        _cuda.count_route(f"{name}/{p.route}")
        rc = entry(ids.data_ptr(), values.data_ptr(), values.stride(0), n, c,
                   n_groups, p.rows_per_block, p.n_blocks, p.n_slices, iws,
                   fws, *out, stream)
    _cuda.check(rc, name)
    return sums, counts
