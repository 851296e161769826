"""The port's kernel packages (``repro_torch.kernels``) against the JAX
reference (``repro.kernels``) on the same numpy inputs.

On the CPU every wrapper runs its plain torch version; the reference runs
its Pallas kernel body in interpret mode.  Tolerances: hash tables, probe
results and counts are byte-identical; integer-valued sums are exact (both
sides add integers below 2^24 in float32); random float sums agree within
rtol 1e-5 (float32 sums taken in different orders).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import hash_join as ref_hj
from repro.kernels.radix_groupby import radix_groupby as ref_radix
from repro.kernels.segment_sum import segment_sum as ref_segsum
from repro_torch.kernels import launch_counts, reset_launches
from repro_torch.kernels import hash_join as hj
from repro_torch.kernels.radix_groupby import radix_groupby
from repro_torch.kernels.segment_sum import segment_sum

RNG = np.random.default_rng(11)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# ------------------------------------------------------------------- hashing
@pytest.mark.parametrize("dtype", [np.int64, np.int32, np.int16])
def test_hash_keys_bit_identical_to_reference(dtype):
    """The port's int64-masked fmix32 equals the reference's uint32 host
    hash bit for bit, on negative keys and keys past 2^31 too."""
    info = np.iinfo(dtype)
    k1 = RNG.integers(info.min, info.max, 600, dtype=np.int64).astype(dtype)
    k1[:4] = [info.min, -1, 0, info.max]
    k2 = RNG.integers(-50, 100, 600).astype(dtype)
    want = ref_hj.hash_keys_np((k1, k2))
    np.testing.assert_array_equal(hj.hash_keys_np((k1, k2)), want)
    got = hj.hash_keys((_t(k1), _t(k2))).numpy()
    np.testing.assert_array_equal(got.astype(np.uint32), want)
    assert got.min() >= 0 and got.max() < 2 ** 32


@pytest.mark.parametrize("case", ["sorted", "shuffled", "duplicates",
                                  "multi_column", "empty", "wide_keys"])
def test_hash_build_identical_to_reference(case):
    if case == "sorted":
        cols = (np.sort(RNG.choice(50_000, 3_000, replace=False)),)
    elif case == "shuffled":
        cols = (RNG.choice(50_000, 3_000, replace=False),)
    elif case == "duplicates":
        base = RNG.choice(500, 200, replace=False)
        cols = (np.concatenate([base, base[:50], base[:25]]),)
    elif case == "multi_column":
        rows = np.unique(RNG.integers(0, 40, size=(600, 3)), axis=0)
        cols = tuple(rows[:, j] for j in range(3))
    elif case == "empty":
        cols = (np.zeros(0, np.int64),)
    else:
        cols = (RNG.integers(-2 ** 40, 2 ** 40, 1_000),)
    cols = tuple(np.asarray(c, dtype=np.int64) for c in cols)
    got, want = hj.hash_build(cols), ref_hj.hash_build(cols)
    assert got["table_size"] == want["table_size"]
    assert got["max_probes"] == want["max_probes"]
    np.testing.assert_array_equal(got["slot_idx"], want["slot_idx"])
    assert got["slot_idx"].dtype == want["slot_idx"].dtype
    for a, b in zip(got["slot_keys"], want["slot_keys"]):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def _probe_both(cols, probes):
    """Probe results of the port's plain version and of the reference's
    interpret-mode Pallas kernel, as numpy arrays."""
    built = hj.hash_build(cols)
    t_idx, t_found = hj.hash_probe(
        hj.pack_table(tuple(_t(k.astype(np.int32))
                            for k in built["slot_keys"]),
                      _t(built["slot_idx"])),
        tuple(_t(p.astype(np.int32)) for p in probes),
        built["max_probes"])
    r_idx, r_found = ref_hj.hash_probe(
        tuple(jnp.asarray(k) for k in built["slot_keys"]),
        jnp.asarray(built["slot_idx"]),
        tuple(jnp.asarray(p) for p in probes),
        built["max_probes"], impl="interpret")
    return (t_idx.numpy(), t_found.numpy(), np.asarray(r_idx),
            np.asarray(r_found))


@pytest.mark.parametrize("case", ["sorted", "shuffled", "duplicates",
                                  "multi_column", "all_miss", "empty_probe",
                                  "tiny_table"])
def test_hash_probe_matches_reference_interpret(case):
    if case == "multi_column":
        rows = np.unique(RNG.integers(0, 40, size=(600, 3)), axis=0)
        cols = tuple(rows[:, j].astype(np.int64) for j in range(3))
        p = RNG.integers(0, 45, size=(2_000, 3)).astype(np.int64)
        probes = tuple(p[:, j] for j in range(3))
    else:
        if case == "sorted":
            keys = np.sort(RNG.choice(3_000, 500, replace=False))
        elif case == "shuffled":
            keys = RNG.choice(10_000, 800, replace=False)
        elif case == "duplicates":
            base = np.sort(RNG.choice(500, 200, replace=False))
            keys = np.sort(np.concatenate([base, base[:50], base[:25]]))
        elif case == "tiny_table":
            keys = np.array([7])
        else:
            keys = np.arange(100) * 7
        cols = (keys.astype(np.int64),)
        if case == "all_miss":
            probes = (np.arange(50, dtype=np.int64) * 7 + 3,)
        elif case == "empty_probe":
            probes = (np.zeros(0, np.int64),)
        else:
            probes = (RNG.integers(-5, int(keys.max()) + 20, 2_500)
                      .astype(np.int64),)
    t_idx, t_found, r_idx, r_found = _probe_both(cols, probes)
    assert t_idx.dtype == r_idx.dtype == np.int32
    assert t_found.dtype == r_found.dtype == np.bool_
    np.testing.assert_array_equal(t_found, r_found)
    np.testing.assert_array_equal(t_idx, r_idx)
    if case == "all_miss":
        assert not t_found.any()


def test_hash_probe_first_occurrence_is_searchsorted():
    """Over sorted keys with duplicates the probe lands on searchsorted's
    leftmost index — the contract that makes the hash and searchsorted
    Lookup routes byte-identical."""
    base = np.sort(RNG.choice(500, 200, replace=False))
    keys = np.sort(np.concatenate([base, base[:50]])).astype(np.int64)
    probes = np.arange(-5, 520).astype(np.int64)
    built = hj.hash_build((keys,))
    idx, found = hj.hash_probe(
        hj.pack_table((_t(built["slot_keys"][0].astype(np.int32)),),
                      _t(built["slot_idx"])),
        (_t(probes.astype(np.int32)),), built["max_probes"])
    ss = np.clip(np.searchsorted(keys, probes), 0, len(keys) - 1)
    hit = keys[ss] == probes
    np.testing.assert_array_equal(found.numpy(), hit)
    np.testing.assert_array_equal(idx.numpy()[hit], ss[hit])


# ------------------------------------------------------- grouped reductions
@pytest.mark.parametrize("n,c,g,integer", [
    (100, 1, 8, True),
    (4_000, 3, 300, True),        # several 256-id partitions
    (2_048, 2, 1_000, False),     # sparse occupancy
    (513, 0, 16, True),           # counts only (C=0)
    (7, 2, 700, False),           # more groups than rows
    (3_000, 1, 147, False),       # the Q4.1 cell count
])
def test_radix_groupby_matches_reference_interpret(n, c, g, integer):
    ids = RNG.integers(-1, g, n).astype(np.int32)     # -1 = padding rows
    vals = (RNG.integers(0, 100, (n, c)) if integer
            else RNG.random((n, c))).astype(np.float32)
    sums, counts = radix_groupby(_t(ids), _t(vals), g)
    r_sums, r_counts = ref_radix(jnp.asarray(ids), jnp.asarray(vals), g,
                                 impl="interpret")
    assert sums.dtype == counts.dtype == torch.float32
    assert tuple(sums.shape) == (g, c) and tuple(counts.shape) == (g,)
    np.testing.assert_array_equal(counts.numpy(), np.asarray(r_counts))
    if integer:
        np.testing.assert_array_equal(sums.numpy(), np.asarray(r_sums))
    else:
        np.testing.assert_allclose(sums.numpy(), np.asarray(r_sums),
                                   rtol=1e-5, atol=0)


def test_radix_groupby_all_padding():
    ids = np.full(300, -1, np.int32)
    vals = RNG.random((300, 2)).astype(np.float32)
    sums, counts = radix_groupby(_t(ids), _t(vals), 32)
    assert not sums.any() and not counts.any()


@pytest.mark.parametrize("n,c,g,integer", [
    (1_000, 1, 1, True),          # the Q1.1 global sum
    (1_000, 1, 1, False),
    (2_500, 2, 64, True),
    (4_096, 3, 500, False),
    (300, 1, 8, True),
])
def test_segment_sum_matches_reference_interpret(n, c, g, integer):
    ids = RNG.integers(-1, g, n).astype(np.int32)
    vals = (RNG.integers(0, 1_000, (n, c)) if integer
            else RNG.random((n, c))).astype(np.float32)
    got = segment_sum(_t(ids), _t(vals), g)
    want = np.asarray(ref_segsum(jnp.asarray(ids), jnp.asarray(vals), g,
                                 impl="interpret"))
    assert got.dtype == torch.float32 and tuple(got.shape) == (g, c)
    if integer:
        np.testing.assert_array_equal(got.numpy(), want)
    else:
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=0)


# ----------------------------------------------------------------- wrappers
def test_wrappers_run_plain_versions_on_cpu_without_counting():
    """A CPU tensor takes the plain version, which launches nothing; asking
    for the kernel on a CPU tensor raises instead of falling back."""
    reset_launches()
    ids = _t(np.array([0, 1, 1, -1], np.int32))
    vals = _t(np.ones((4, 1), np.float32))
    radix_groupby(ids, vals, 2)
    segment_sum(ids, vals, 2)
    built = hj.hash_build((np.arange(10, dtype=np.int64),))
    args = (hj.pack_table((_t(built["slot_keys"][0].astype(np.int32)),),
                          _t(built["slot_idx"])),
            (_t(np.arange(4, dtype=np.int32)),), built["max_probes"])
    hj.hash_probe(*args)
    assert launch_counts() == {"hash_probe": 0, "radix_groupby": 0,
                               "segment_sum": 0, "flash_attention": 0,
                               "flash_attention_backward": 0,
                               "mamba_scan": 0, "mamba_scan_backward": 0,
                               "adamw_update": 0, "adamw_square_sum": 0}
    with pytest.raises(ValueError, match="CUDA tensor"):
        hj.hash_probe(*args, impl="cuda")
    with pytest.raises(ValueError, match="CUDA tensor"):
        radix_groupby(ids, vals, 2, impl="cuda")
    with pytest.raises(ValueError, match="CUDA tensor"):
        segment_sum(ids, vals, 2, impl="cuda")
    assert launch_counts()["hash_probe"] == 0


def test_grouped_sum_plan_sizes():
    """The launch plan the CUDA kernels follow.  Narrow direct route (small
    id space, one launch): the row range a block takes is fixed by n alone,
    and the grid never exceeds two blocks per SM of 132, so it is
    co-resident.  Partitioned route (large id space, two launches): an int32
    region of histogram + partition totals and starts and a float region of
    row records + slice partials, for any int32 group count.  Shapes alone
    fix every count (determinism)."""
    from repro_torch.kernels import _grouped_sum as gs
    q41 = gs.plan(96_000, 147, 1, True)            # SSB Q4.1
    q11 = gs.plan(112_000, 1, 1, False)            # SSB Q1.1
    for p, n, cells in ((q41, 96_000, 147 * 2), (q11, 112_000, 1)):
        assert p.direct
        assert p.n_blocks == -(-n // p.rows_per_block)
        assert 132 <= p.n_blocks <= gs.TARGET_BLOCKS
        assert p.rows_per_block % (32 * gs.DIRECT_WARPS) == 0
        assert (p.int_words, p.float_words) == (0, p.n_blocks * cells)
        # the row ranges depend on n, not on the groups or columns
        assert gs.plan(n, 700, 0, True).rows_per_block == p.rows_per_block
    assert (q41.rows_per_block, q41.n_blocks) == (512, 188)
    assert gs.plan(96_000, 147, 1, True) is q41      # cached by shape
    # fewer rows than one block's range: one block, no scratch
    tiny = gs.plan(100, 5, 1, True)
    assert tiny.direct and tiny.n_blocks == 1
    assert tiny.int_words + tiny.float_words == 0
    # many rows: longer warp ranges, never more blocks than TARGET_BLOCKS,
    # so the block partials fit the scratch of TARGET_BLOCKS x DIRECT_FLOATS
    for n in (540_672, 540_673, 10_000_000, (1 << 31) - 1):
        p = gs.plan(n, 1_536, 0, True)
        assert p.n_blocks <= gs.TARGET_BLOCKS
        assert p.n_blocks * p.rows_per_block >= n
        assert p.float_words <= gs.TARGET_BLOCKS * gs.DIRECT_FLOATS
    # the narrow route's boundary, on both sides: a warp's partial of
    # groups x cols in 1536 floats; above it the wide route (still one
    # launch, direct) takes the card's co-resident grid
    for g, c, counts, direct in ((768, 1, True, True), (769, 1, True, True),
                                 (1_536, 1, False, True),
                                 (1_537, 1, False, True),
                                 (1_536, 0, True, True),
                                 (1_537, 0, True, True),
                                 (46, 32, True, True), (47, 32, True, True),
                                 (48, 32, False, True),
                                 (49, 32, False, True)):
        p = gs.plan(5_000, g, c, counts, 132)
        assert gs.is_direct(g, c, counts) == p.direct == direct
        assert p.wide == (g * (c + counts) > gs.DIRECT_FLOATS)
    # partitioned: two launches; many partitions, 2^20 cells.  A partition
    # holds the fewest ids, a power of two of 32 or more, that make
    # PART_TARGET partitions at most, within the most whose warp partial
    # fits WIDE_FLOATS (4,096 ids at one column, 2,048 at two or three, 128
    # at 33).  The int32 region is the histogram (a row a partition block,
    # at most PART_MAX_BLOCKS) + the totals + the starts; the float region
    # the records (local id + values a row) and, with slices, their
    # partials
    assert [gs.part_width(1 << 30, c) for c in (1, 2, 3, 4, 7, 33)] == \
        [4096, 2048, 2048, 1024, 1024, 128]
    assert [gs.part_width(g, 2) for g in (7_169, 8_192, 8_193, 30_000,
                                          200_000)] == [32, 32, 64, 128, 1024]
    big = gs.plan(4 << 20, 1 << 20, 1, True)
    assert not big.direct and big.launches == 2 and q41.launches == 1
    assert (big.n_parts, big.g_pad, big.n_slices) == (512, 1 << 20, 1)
    assert big.n_blocks == gs.PART_MAX_BLOCKS
    assert big.int_words == gs.PART_MAX_BLOCKS * 512 + 2 * 512 + 1
    assert big.float_words == 2 * (4 << 20)                  # no partials
    c2 = gs.plan(4 << 20, 1 << 20, 2, True)
    assert (c2.int_words, c2.float_words) == (big.int_words, 3 * (4 << 20))
    sort = gs.plan(4_000_000, 4_000_000, 1, False)          # 977 partitions
    assert sort.n_parts == 977 and sort.n_blocks == gs.PART_MAX_BLOCKS
    # a partition block sorts TILE_MAX rows at a time in shared memory, fewer
    # where its counters and masks take more room (within PART_SMEM_TWO,
    # two blocks an SM, while that leaves TILE_TWO rows); past TILE_MIN's
    # limit (2,901 partitions at 1 column, 1,137 at 32) the counters move to
    # global memory, a row a warp of rows within GLOBAL_HIST entries; the
    # id space is bounded by int32 alone
    assert gs.part_tile(512, 1) == gs.part_tile(512, 2) == gs.TILE_MAX
    assert gs.part_tile(977, 1) == 3_328                    # two an SM
    assert gs.part_tile(1_194, 1) == 2_048
    assert gs.part_tile(1_195, 1) == gs.TILE_MAX            # one an SM
    assert gs.part_tile(2_600, 1) == 2_816
    assert gs.part_tile(2_901, 1) == gs.TILE_MIN
    assert gs.part_tile(2_902, 1) == 0
    assert gs.part_tile(1_137, 32) == gs.TILE_MIN
    assert gs.part_tile(1_138, 32) == 0
    edge = gs.plan(100, 2_901 * 4096, 1, False)
    assert edge.n_parts == 2_901 and edge.n_blocks == gs.PART_MAX_BLOCKS
    assert gs.plan(100, 2_902 * 4096, 1, False).n_blocks == \
        gs.GLOBAL_HIST // 2_902
    many = gs.plan(1_000_000, 1_600_000, 32, True)          # 128-id parts
    assert many.n_parts == 12_500 and many.g_pad == 12_500 * 128
    assert many.n_blocks == gs.GLOBAL_HIST // 12_500 == 335
    assert many.int_words == 335 * 12_500 + 2 * 12_500 + 1
    huge = gs.plan(1_000, (1 << 31) - 1, 1, False)
    assert huge.n_parts == 1 << 19 and huge.n_blocks == 8
    assert huge.n_slices == 1 and huge.float_words == 2_000
    # slices where partitions are few and long: about SLICE_TARGET items,
    # SLICE_ROWS rows a slice at least
    cust = gs.plan(6_000_000, 30_000, 1, True)               # lo_custkey
    assert (cust.n_parts, cust.n_slices) == (235, 2)
    assert cust.float_words == 2 * 6_000_000 + 2 * 235 * 128 * 2
    part = gs.plan(6_000_000, 200_000, 1, True)              # lo_partkey
    assert (part.n_parts, part.n_slices) == (196, 2)
    assert gs.plan(200_000, 200_000, 1, False).n_slices == 1  # its combiner
    assert gs.plan(1 << 20, 8192, 1, False).n_slices == 1
    assert gs.plan(2_000_000, 218, 32, True).n_slices == 38
    assert gs.plan(4_000_000, 300, 32, True).n_slices == 27
    assert gs.plan(1 << 30, 218, 32, True).n_slices == \
        -(-gs.SLICE_TARGET // 7)
    assert gs.plan(10, 5_000, 2, True).n_slices == 1
    assert gs.plan(10, 4, gs.MAX_COLS, True).direct
    with pytest.raises(ValueError, match="value columns"):
        gs.plan(10, 4, gs.MAX_COLS + 1, False)


def test_route_counts_reset_with_the_launch_counts():
    """``route_counts`` tallies the grouped sums' launches by kernel and
    route (the wrappers count one where they count the launch) and
    ``reset_launches`` sets them to 0 with the launch counts."""
    from repro_torch.kernels import (_cuda, launch_counts, reset_launches,
                                     route_counts)
    reset_launches()
    _cuda.count_route("radix_groupby/wide")
    _cuda.count_route("radix_groupby/wide")
    _cuda.count_route("segment_sum/narrow")
    assert route_counts() == {"radix_groupby/wide": 2,
                              "segment_sum/narrow": 1}
    reset_launches()
    assert route_counts() == {}
    assert set(launch_counts().values()) == {0}


# Both sides of each route boundary: the narrow direct route (a warp's
# partial of groups x cols within 1,536 floats), the wide one (within 7,168,
# Hopper's opt-in shared memory) and the partitioned one, for counts and
# without, one column, 32 columns and none.
@pytest.mark.parametrize("g,c,counts,route", [
    (768, 1, True, "narrow"), (769, 1, True, "wide"),
    (1_536, 1, False, "narrow"), (1_537, 1, False, "wide"),
    (3_584, 1, True, "wide"), (3_585, 1, True, "partitioned"),
    (7_168, 1, False, "wide"), (7_169, 1, False, "partitioned"),
    (46, 32, True, "narrow"), (47, 32, True, "wide"),
    (217, 32, True, "wide"), (218, 32, True, "partitioned"),
    (7_168, 0, True, "wide"), (7_169, 0, True, "partitioned"),
])
@pytest.mark.parametrize("n", [100, 1_500_000])
def test_grouped_sum_three_routes(g, c, counts, route, n):
    """The route follows the cells alone, identically in ``is_direct`` /
    ``is_wide`` and the plan; a wide plan needs the card's co-resident
    blocks and keeps its grid within them (the narrow one within
    TARGET_BLOCKS, the partitioned one ignores the cap)."""
    from repro_torch.kernels import _grouped_sum as gs
    assert gs.is_direct(g, c, counts) == (route != "partitioned")
    assert gs.is_wide(g, c, counts) == (route == "wide")
    cap = 132
    p = gs.plan(n, g, c, counts, cap)
    assert (p.direct, p.wide) == (route != "partitioned", route == "wide")
    assert p.route == route
    if route == "partitioned":
        assert p == gs.plan(n, g, c, counts)         # no cap needed
        assert p.n_parts == -(-g // gs.part_width(g, c + counts))
        return
    assert p.n_blocks <= (cap if p.wide else gs.TARGET_BLOCKS)
    assert p.n_blocks * p.rows_per_block >= n
    assert p.rows_per_block % (32 * gs.DIRECT_WARPS) == 0
    cells = g * (c + counts)
    assert p.float_words == (p.n_blocks * cells if p.n_blocks > 1 else 0)
    if p.wide:
        with pytest.raises(ValueError, match="co-resident"):
            gs.plan(n, g, c, counts)


@pytest.mark.parametrize("label,n,g,counts,cap", [
    # 4,000 cells of 8 warps: 128 KB, one block an SM of 132
    ("supplier shard", 1_500_000, 2_000, True, 132),
    # 2,000 cells: 64 KB (the card holds three an SM; the grid takes one)
    ("supplier combiner", 2_000, 2_000, False, 132),
    # a grid capped below the SMs (a card holding fewer blocks at once)
    ("capped", 1_500_000, 2_000, True, 40),
    # the largest wide partial, one block an SM
    ("widest", 4_000_000, 7_168, False, 132),
])
def test_grouped_sum_wide_plans_and_scratch(label, n, g, counts, cap):
    """The hash-mode supplier flow's grouped sums take the wide route: one
    launch on a grid within the co-resident cap, 8 warps a block, whole
    32-row batches a warp; the stream's block-partials scratch grows to the
    wide plan's cells x blocks and is reused by every smaller plan."""
    from repro_torch.kernels import _grouped_sum as gs
    p = gs.plan(n, g, 1, counts, cap)
    assert p.direct and p.wide and p.int_words == 0
    assert 1 <= p.n_blocks <= cap
    per_warp = p.rows_per_block // gs.DIRECT_WARPS
    assert per_warp % 32 == 0
    assert per_warp == max(32, -(-(-(-n // (cap * gs.DIRECT_WARPS))) // 32)
                           * 32)
    cells = g * (1 + counts)
    assert p.float_words == (p.n_blocks * cells if p.n_blocks > 1 else 0)
    gs._direct_scratch.clear()
    cpu = torch.device("cpu")
    narrow = gs.plan(96_000, 147, 1, True)           # SSB Q4.1
    buf, iws, _ = gs.workspace(narrow, cpu, 0)
    assert iws is None
    assert buf.numel() == gs.TARGET_BLOCKS * gs.DIRECT_FLOATS
    if p.float_words:
        grown, _, fws = gs.workspace(p, cpu, 0)
        assert grown.numel() == max(p.float_words, buf.numel())
        assert fws == grown.data_ptr()
        assert gs.workspace(narrow, cpu, 0)[0] is grown   # reused
        assert gs.workspace(p, cpu, 1)[0] is not grown    # per stream
    else:
        assert gs.workspace(p, cpu, 0) == (None, None, None)
    gs._direct_scratch.clear()


# ------------------------------------------------- the column-batching loop
def _plain_batch(ids, vals, g, with_counts):
    """The plain versions: radix groupby with the counts, segment sum
    without."""
    if with_counts:
        return radix_groupby(ids, vals, g, impl="reference")
    return segment_sum(ids, vals, g, impl="reference"), None


@pytest.mark.parametrize("c", [40, 65])
@pytest.mark.parametrize("with_counts", [True, False])
def test_column_batches_equal_one_plain_call(c, with_counts):
    """More than MAX_COLS value columns go through the wrapper's loop in
    batches of MAX_COLS, counts with the first batch only, each batch
    reading its column slice of the values and writing its column slice of
    the one output in place: sums and counts bit-identical to one plain
    call over every column."""
    from repro_torch.kernels import _grouped_sum as gs
    n, g = 3_000, 147
    ids = _t(RNG.integers(-1, g + 2, n).astype(np.int32))   # with padding
    vals = _t(RNG.normal(size=(n, c)).astype(np.float32) * 1e3)
    calls, outs = [], []

    def batch(i, v, groups, counts, out):
        c0 = len(calls) * gs.MAX_COLS
        assert v.data_ptr() == vals[:, c0:].data_ptr()       # a slice
        calls.append((v.shape[1], counts))
        outs.append((c0, out))
        part, got = _plain_batch(i, v, groups, counts)
        out.copy_(part)
        return out, got
    sums, counts = gs.in_column_batches(batch, ids, vals, g, with_counts)
    want, want_counts = _plain_batch(ids, vals, g, with_counts)
    widths = [min(gs.MAX_COLS, c - c0) for c0 in range(0, c, gs.MAX_COLS)]
    assert calls == [(w, with_counts and i == 0)
                     for i, w in enumerate(widths)]
    for c0, out in outs:                      # slices of the one output
        assert out.data_ptr() == sums[:, c0:].data_ptr()
    assert sums.dtype == want.dtype and sums.shape == want.shape
    assert torch.equal(sums, want)
    if with_counts:
        assert counts.dtype == want_counts.dtype
        assert torch.equal(counts, want_counts)
    else:
        assert counts is None


# ------------------------------------------------------ the packed table
def _built(n_keys, d=400, dup=False):
    rows = np.unique(RNG.integers(-60, 60, size=(d, n_keys)), axis=0)
    RNG.shuffle(rows)
    if dup:
        rows = np.concatenate([rows, rows[: len(rows) // 3]])
    cols = tuple(rows[:, j].astype(np.int64) for j in range(n_keys))
    built = hj.hash_build(cols)
    sk = tuple(_t(k.astype(np.int32)) for k in built["slot_keys"])
    return rows, built, sk, _t(built["slot_idx"])


@pytest.mark.parametrize("n_keys", [1, 2, 3, 4])
def test_pack_table_layout(n_keys):
    """Slot s of the packed table: its key columns, then its row index
    (< 0: empty), then zeros, in 2, 4, 4 or 8 int32 words (8, 16, 16 or 32
    bytes)."""
    _, built, sk, si = _built(n_keys)
    packed = hj.pack_table(sk, si)
    size = built["table_size"]
    width = hj.SLOT_WORDS[n_keys]
    assert width * 4 in (8, 16, 32) and width > n_keys
    assert packed.n_keys == n_keys and packed.size == size
    assert packed.slots.dtype == torch.int32 and packed.slots.is_contiguous()
    assert tuple(packed.slots.shape) == (size, width)
    s = packed.slots.numpy()
    for c in range(n_keys):
        np.testing.assert_array_equal(s[:, c], built["slot_keys"][c])
    np.testing.assert_array_equal(s[:, n_keys], built["slot_idx"])
    assert not s[:, n_keys + 1:].any()
    with pytest.raises(ValueError, match="int32"):
        hj.pack_table(tuple(k.long() for k in sk), si)


@pytest.mark.parametrize("case", ["not_pow2", "five_keys", "no_keys",
                                  "int64_keys", "ragged", "two_dims"])
def test_pack_table_refuses_bad_tables(case):
    """pack_table validates a table once, for every later probe: a power-of-
    two int32 slot array a key column (1-4) and the rows, all one length."""
    si = torch.full((64,), -1, dtype=torch.int32)
    keys, rows, match = (si,), si, "power of two"
    if case == "not_pow2":
        keys, rows = (si[:48],), si[:48]
    elif case == "five_keys":
        keys, match = (si,) * 5, "1..4 key columns"
    elif case == "no_keys":
        keys, match = (), "1..4 key columns"
    elif case == "int64_keys":
        keys, match = (si.long(),), "int32"
    elif case == "ragged":
        keys, match = (si[:32],), "int32"
    else:
        rows = si.reshape(8, 8)
    with pytest.raises(ValueError, match=match):
        hj.pack_table(keys, rows)
    assert hj.pack_table((si,), si).size == 64          # the good table


@pytest.mark.parametrize("case", ["one_key", "two_keys", "three_keys",
                                  "four_keys", "duplicates", "all_miss",
                                  "empty_probe", "short_probe_limit"])
def test_packed_probe_matches_reference_interpret(case):
    """The plain probe over the packed table gives the plain probe's and
    the reference's interpret-mode (idx, found), byte for byte."""
    n_keys = {"two_keys": 2, "three_keys": 3, "four_keys": 4}.get(case, 1)
    rows, built, sk, si = _built(n_keys, dup=case == "duplicates")
    n = 0 if case == "empty_probe" else 1_003
    probes = RNG.integers(-65, 65, size=(n, n_keys))
    if case == "all_miss":
        probes = probes + 1_000
    else:
        hit = RNG.random(n) < 0.6
        probes[hit] = rows[RNG.integers(0, len(rows), int(hit.sum()))]
    mp = 2 if case == "short_probe_limit" else built["max_probes"]
    vals = tuple(_t(probes[:, j].astype(np.int32)) for j in range(n_keys))
    packed = hj.pack_table(sk, si)
    got = hj.hash_probe(packed, vals, mp)
    direct = hj.hash_probe_packed_ref(packed.slots, n_keys, vals, mp)
    plain = hj.hash_probe_ref(sk, si, vals, mp)
    r_idx, r_found = ref_hj.hash_probe(
        tuple(jnp.asarray(k) for k in built["slot_keys"]),
        jnp.asarray(built["slot_idx"]),
        tuple(jnp.asarray(probes[:, j].astype(np.int64))
              for j in range(n_keys)), mp, impl="interpret")
    for idx, found in (got, direct, plain):
        assert idx.dtype == torch.int32 and found.dtype == torch.bool
        np.testing.assert_array_equal(idx.numpy(), np.asarray(r_idx))
        np.testing.assert_array_equal(found.numpy(), np.asarray(r_found))
    if case == "all_miss":
        assert not got[1].any()
    elif n:
        assert got[1].any()
