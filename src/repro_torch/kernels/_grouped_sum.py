"""Launch plan shared by the radix-groupby and segment-sum kernels, which run
the same deterministic grouped sum (``csrc/grouped_sum.cuh``).

Two routes, chosen from the shapes alone:

- **direct**, when a warp's partial (``n_groups x cols`` floats, ``cols``
  the value columns plus the counts column) fits ``DIRECT_FLOATS``: one
  cooperative launch.  Each block takes a fixed row range; its warps add
  32 rows at a time into per-warp shared partials (rows of one id in row
  order); the block sums its warps in warp order; after a grid-wide
  barrier the block partials are summed in a fixed order.  The grid never
  exceeds ``TARGET_BLOCKS``, so every block is resident at once.
- **partitioned**, for larger id spaces: a stable counting sort into
  256-id partitions, then per-partition sums in row order (six launches).

The plan fixes the row ranges and slice counts from ``n``, ``n_groups`` and
the column count alone, so the order of every float addition depends on the
input only.  It is cached: the same shapes give the same plan object.
Bound: bytes, about 0.2 us at the SSB shapes, below one launch's cost, so
at those shapes the call's host work and its one launch are the time."""
from __future__ import annotations

import functools
from typing import Dict, NamedTuple, Optional, Tuple

import torch

from . import _cuda

PART_GROUPS = 256            # ids per partition (kPartGroups in the .cuh)
MAX_COLS = 32                # value columns (C); the counts column is extra
DIRECT_WARPS = 8             # warps a direct-route block (kDirectWarps)
#: floats of shared memory a direct-route warp may hold: 48 KB over its
#: block's 8 warps (kDirectFloats)
DIRECT_FLOATS = 12288 // DIRECT_WARPS
#: blocks to aim for: two per SM of the H100's 132.  The direct route's
#: grid never exceeds it (kDirectMaxBlocks), so it is co-resident
TARGET_BLOCKS = 264
#: rows the partitioned route's accumulate pass stages at a time (kTile)
TILE_ROWS = 1024
#: bound on the partitioned route's [row blocks, partitions] histogram
#: (int32 entries), met by growing the row blocks until one holds every row
MAX_HIST = 1 << 20


class Plan(NamedTuple):
    direct: bool
    rows_per_block: int
    n_blocks: int
    #: partitioned route: partitions, padded id space, slices a partition
    n_parts: int
    g_pad: int
    n_slices: int
    int_words: int
    float_words: int


def is_direct(n_groups: int, n_values: int, with_counts: bool) -> bool:
    """The route test of ``direct_route`` in ``csrc/grouped_sum.cuh``."""
    return n_groups * (n_values + int(with_counts)) <= DIRECT_FLOATS


@functools.lru_cache(maxsize=256)
def plan(n: int, n_groups: int, n_values: int, with_counts: bool) -> Plan:
    """Launch shape and workspace for ``n`` rows, ``n_groups`` ids and
    ``n_values`` value columns, plus a counts column when ``with_counts``."""
    if n >= 1 << 31:
        raise ValueError(f"grouped sum over {n} rows: row indices are int32")
    if not 0 <= n_values <= MAX_COLS:
        raise ValueError(f"grouped sum over {n_values} value columns: the "
                         f"kernel takes 0 to {MAX_COLS}")
    cols = n_values + int(with_counts)
    if is_direct(n_groups, n_values, with_counts):
        # a warp's rows: whole batches of 32, as few as keep the grid within
        # TARGET_BLOCKS
        per_warp = -(-n // (TARGET_BLOCKS * DIRECT_WARPS))
        per_warp = max(32, -(-per_warp // 32) * 32)
        rows_per_block = DIRECT_WARPS * per_warp
        n_blocks = max(1, -(-n // rows_per_block))
        partials = n_blocks * n_groups * cols if n_blocks > 1 else 0
        return Plan(True, rows_per_block, n_blocks, 0, 0, 0, int_words=0,
                    float_words=partials)
    n_parts = max(1, -(-n_groups // PART_GROUPS))
    rows_per_block = 1024
    while (-(-n // rows_per_block) * n_parts > MAX_HIST
           and rows_per_block < n):
        rows_per_block *= 2
    n_blocks = max(1, -(-n // rows_per_block))
    # enough slices to fill the card, but no more than a partition's mean
    # rows fill (TILE_ROWS each): an empty slice still writes its partials
    n_slices = max(1, min(-(-TARGET_BLOCKS // n_parts),
                          -(-n // (n_parts * TILE_ROWS))))
    g_pad = n_parts * PART_GROUPS
    return Plan(False, rows_per_block, n_blocks, n_parts, g_pad, n_slices,
                int_words=n_blocks * n_parts + n_parts + 1 + 2 * n,
                float_words=n_slices * g_pad * cols)


#: the direct route's scratch, one buffer per (device, stream) holding the
#: most block partials a plan asks for (1.6 MB).  Launches on one stream
#: run in order, so each reuses its stream's buffer, as the caching
#: allocator reuses a block freed on that stream; it saves a host-bound call
#: an allocation
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
        if buf is None:
            buf = _direct_scratch[key] = torch.empty(
                TARGET_BLOCKS * DIRECT_FLOATS, dtype=torch.float32,
                device=device)
        return buf, None, buf.data_ptr()
    buf = torch.empty(p.int_words + p.float_words, dtype=torch.int32,
                      device=device)
    base = buf.data_ptr()
    return buf, base, base + 4 * p.int_words


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
    p = plan(n, n_groups, c, with_counts)
    stream = _cuda.stream_ptr(ids)
    ws, iws, fws = workspace(p, ids.device, stream)  # ws: alive to launch
    out = ((sums.data_ptr(), sums.stride(0),
            counts.data_ptr() if with_counts else None)
           if name == "radix_groupby" else (sums.data_ptr(), sums.stride(0)))
    entry = getattr(_cuda.library(), f"repro_{name}")
    with _cuda.device_guard(ids):
        _cuda.count_launch(name)
        rc = entry(ids.data_ptr(), values.data_ptr(), values.stride(0), n, c,
                   n_groups, p.rows_per_block, p.n_slices, iws, fws, *out,
                   stream)
    _cuda.check(rc, name)
    return sums, counts
