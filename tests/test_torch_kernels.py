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
        tuple(_t(k.astype(np.int32)) for k in built["slot_keys"]),
        _t(built["slot_idx"]),
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
        (_t(built["slot_keys"][0].astype(np.int32)),), _t(built["slot_idx"]),
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
    args = ((_t(built["slot_keys"][0].astype(np.int32)),),
            _t(built["slot_idx"]), (_t(np.arange(4, dtype=np.int32)),),
            built["max_probes"])
    hj.hash_probe(*args)
    assert launch_counts() == {"hash_probe": 0, "radix_groupby": 0,
                               "segment_sum": 0, "flash_attention": 0,
                               "mamba_scan": 0}
    with pytest.raises(ValueError, match="CUDA tensor"):
        hj.hash_probe(*args, impl="cuda")
    with pytest.raises(ValueError, match="CUDA tensor"):
        radix_groupby(ids, vals, 2, impl="cuda")
    with pytest.raises(ValueError, match="CUDA tensor"):
        segment_sum(ids, vals, 2, impl="cuda")
    assert launch_counts()["hash_probe"] == 0


def test_grouped_sum_plan_sizes():
    """The workspace plan the CUDA kernels index into: one int32 region of
    histogram + partition starts + two row arrays, one float region of
    slice partials; shapes alone fix the slice count (determinism)."""
    from repro_torch.kernels import _grouped_sum as gs
    p = gs.plan(96_000, 147, 2)
    assert (p.n_parts, p.g_pad, p.n_slices) == (1, 256, 64)
    assert p.int_words == p.n_blocks * 1 + 2 + 2 * 96_000
    assert p.float_words == 64 * 256 * 2
    big = gs.plan(4 << 20, 1 << 20, 2)
    assert big.n_parts == 4096 and big.n_slices == 1
    assert big.n_blocks * big.n_parts <= gs.MAX_HIST
    # past 12288 partitions the block counters move to global memory; the
    # id space is bounded by int32 alone
    wide = gs.plan(4_000_000, 4_000_000, 1)
    assert wide.n_parts == 15_625 and wide.g_pad == 15_625 * 256
    assert wide.n_blocks * wide.n_parts <= gs.MAX_HIST
    huge = gs.plan(1_000, (1 << 31) - 1, 1)
    assert huge.n_blocks == 1 and huge.rows_per_block >= 1_000
    with pytest.raises(ValueError):
        gs.plan(10, 4, gs.MAX_COLS + 2)
