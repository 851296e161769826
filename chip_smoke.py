"""Drive the PyTorch/CUDA port (``repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py                 # all phases
    python3 chip_smoke.py --profile       # all phases + profiled Q4.1 run,
                                          # served Q4.1 tick, LM prefill
                                          # and decode step

Phases (any failure raises and the script exits non-zero):

1. Setup: torch/CUDA versions, the card's name and power limit, and the
   build of every ``src/repro_torch/csrc/*.cu`` kernel (timed), with each
   flash, selective-scan and hash-probe entry point's registers and spills
   as ``ptxas`` reports them.
2. Kernels: each hand-written kernel against its plain torch version on the
   card, at the shapes its main path gives it (SSB scale factor 1 for the
   ETL kernels; stablelm-3b and falcon-mamba-7b prefill for flash attention
   and the selective scan; flash on both of its routes, bf16 on the tensor
   cores and fp32 in FMAs; the scan on bf16 and fp32 delta/x, with its
   lane splits timed) plus small cases for the options those paths do
   not use, twice (bit-identical), with its median time (CUDA events), its
   bound, the plain version's time and a PyTorch library call as a
   yardstick the port never calls.  For each grouped-sum case, the device
   kernels one call launches and their device time (``torch.profiler``);
   at the main paths' shapes a call may launch at most two.  The hash
   probe runs against all four Q4.1 dimensions on its packed table, with
   its device time taken after every other event time (a profiler session
   slows later launches on the host).  fp32 flash attention runs
   at every head dim.  The grouped sums also run at the sharded runs'
   shapes: a shard's Q4.1, Q1.1 and supplier partials and the mesh
   combiner's sums.
3. ETL main path: SSB scale factor 1 (seed 42) through
   ``repro_torch.Session.run`` on backend ``torch`` with segment fusion:
   Q4.1 on the optimized and streaming engines, Q4.1s (Q4.1 cut into two
   streamed trees by a StageBoundary) on the streaming one, Q1.1 on the
   optimized one.
   Each run is checked against the query's float64 oracle and repeated (the
   second run must be byte-identical).  The launch counters are set to 0
   just before the path's first run and read after its last.  Then SF1
   Q4.1 once on each copy-everywhere baseline (``ordinary``, ``kettle``)
   against the oracle, and the four engines' walls and rows/s.
   Then sharded runs (streaming, fused, 8 splits): SF1 Q4.1 over 4 shards
   on ``shard_impl="auto"`` (which must resolve to the mesh route) twice,
   bit-identical, and on ``inline``; Q1.1 over 4 shards on the mesh route;
   a supplier-keyed Aggregate of lineorder (hash partitioning, 2,000
   groups); Q4.1 over 2 shards on the process route, twice (the first
   spawns the workers).  Each must match the serial run (keys, order,
   counts, dtypes; sums within FLOAT_RTOL) and the oracle, with no
   degradation and every row on one shard; each prints its wall, rows/s,
   shard rows, transfers, shuffle bytes and kernel launches, counted from
   0 just before it (the process route's include its workers').
   Then served Q4.1: the declarative Q4.1 flow through ``Session.serve``,
   SF1's lineorder in 12 ticks and an empty one; the replayed deltas must
   equal a batch run of the flow, each tick must go through the probe (4 x
   chunks launches) and, with rows, the radix groupby; warm ticks must
   compile and upload nothing, and no tick may be retried or dead-lettered.
   Its launches are counted from 0 on their own and added to the kernels
   line's.  Then a keyed Aggregate with 40 sum outputs, more than one
   grouped-sum launch takes, on ``torch`` against ``torch_cpu``.
4. LM serving path, once for stablelm-3b and once for falcon-mamba-7b at
   their full published widths (``configs/<arch>.CONFIG``, random weights
   from a seed): ``BatchedServer`` serves 8 requests (waves of 4, prompts of
   2048 tokens from numpy seed 0, 32 new tokens, greedy) twice, with the
   counters set to 0 just before and read just after.  Each prefill must
   launch its kernel once per layer and the second run must give the same
   tokens.  Against the fp32 plain route's prefill logits, the fp32 kernel
   route must agree within F32_LOGITS_ATOL and the bf16 kernel route must
   be no further off than the bf16 plain route allows (BF16_MARGIN); in
   fp32, prefill + 4 decode steps must agree with a longer prefill.
5. The ``kernels`` JSON line, the card line and, last,
   ``{"ok": true, "device": {...}}``.

Needs a CUDA card; exits non-zero without one, and without the repository's
``src/`` beside it.
"""
from __future__ import annotations

import argparse
import functools
import json
import os
import re
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))

# H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s and float32 outside the
# tensor cores, which bounds the integer/float work these kernels do
PEAK_BYTES_S = 3.35e12
PEAK_OPS_S = 67e12
#: dense bf16 tensor-core peak: the least time for attention's products
PEAK_BF16_S = 989e12
#: exp2 on the special-function units: 16 results a clock an SM (CUDA C++
#: Programming Guide, arithmetic throughput, compute capability 9.0) on 132
#: SMs at the 1.98 GHz boost clock; the selective scan takes one a state
PEAK_EX2_S = 132 * 16 * 1.98e9

SF1 = dict(lineorder_rows=6_000_000, customers=30_000, suppliers=2_000,
           parts=200_000, seed=42)
#: float32 unit roundoff.  A float32 sum of n values, in any order, lies
#: within (n - 1) * U * sum|x| of the exact sum, so the kernel's and the
#: plain version's sums (two orders) may differ by twice that per group.
#: That worst case grows with n (1.3% of the sum at Q1.1's 112k rows), and
#: the plain version's own order (float atomics) changes from run to run,
#: so the kernel's float sums must also lie within FLOAT_RTOL * sum|x| of
#: the float64 sum of the same values (the CPU tests' rtol); integer-valued
#: inputs whose sums stay below 2^24 are compared exactly
U = 2.0 ** -24
FLOAT_RTOL = 1e-5


def log(msg: str = "") -> None:
    print(msg, flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip()


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Median device time of ``fn`` over ``iters`` calls (CUDA events)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bound_ms(nbytes: float, ops: float, peak_ops: float = PEAK_OPS_S):
    t_bytes = nbytes / PEAK_BYTES_S * 1e3
    t_ops = ops / peak_ops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def ptxas_entries(build_log: str) -> dict:
    """Registers a thread and spill bytes (stores + loads) of each entry
    point, by mangled name, from what ``nvcc -Xptxas -v`` printed."""
    out = {}
    for block in build_log.split("Compiling entry function '")[1:]:
        name = block.split("'", 1)[0]
        regs = re.search(r"Used (\d+) registers", block)
        spills = sum(int(m) for m in re.findall(r"(\d+) bytes spill", block))
        out[name] = (int(regs.group(1)) if regs else -1, spills)
    return out


def ptxas_summary(build_log: str) -> str:
    """Entry points, most registers a thread and total spill bytes."""
    entries = ptxas_entries(build_log).values()
    if not entries:
        return "no report (the library was already built)"
    return (f"{len(entries)} entry points, at most "
            f"{max(r for r, _ in entries)} registers a thread, "
            f"{sum(s for _, s in entries)} bytes of spills")


def flash_ptxas(build_log: str) -> None:
    """Print each flash entry point's registers and spills; neither kernel
    may spill at the head dims of the served models (80: stablelm-3b;
    128)."""
    rows = []
    for name, (regs, spills) in ptxas_entries(build_log).items():
        m = re.search(r"flash_(wgmma_)?kernelI(?:f)?Li(\d+)E", name)
        if m:
            route = "bf16 wgmma" if m.group(1) else "fp32 FMA"
            rows.append((route, int(m.group(2)), regs, spills))
    if not rows:
        log("  flash ptxas: no report (the library was already built)")
        return
    for route, hd, regs, spills in sorted(rows):
        log(f"  flash ptxas: {route} hd {hd}: {regs} registers a thread, "
            f"{spills} bytes of spills")
        if hd in (80, 128) and spills:
            raise AssertionError(f"flash {route} hd {hd} spills {spills} "
                                 f"bytes")


def probe_ptxas(build_log: str) -> None:
    """Print each hash-probe instance's registers and spills (one per
    number of key columns); none may spill."""
    rows = []
    for name, (regs, spills) in ptxas_entries(build_log).items():
        m = re.search(r"hash_probe_kernelILi(\d)E", name)
        if m:
            rows.append((int(m.group(1)), regs, spills))
    if not rows:
        log("  probe ptxas: no report (the library was already built)")
        return
    for keys, regs, spills in sorted(rows):
        log(f"  probe ptxas: {keys} key column(s): {regs} registers a "
            f"thread, {spills} bytes of spills")
        if spills:
            raise AssertionError(f"hash_probe {keys} keys spills {spills} "
                                 f"bytes")


def scan_ptxas(build_log: str) -> None:
    """Print each selective-scan instance's registers and spills (delta/x
    dtype, state bucket, lanes a channel); none may spill (the wrapper
    picks the lanes from the shape, so every instance is on some path)."""
    rows = []
    for name, (regs, spills) in ptxas_entries(build_log).items():
        m = re.search(r"mamba_scan_kernelI([ft])Li(\d+)ELi(\d+)E", name)
        if m:
            rows.append(("bf16" if m.group(1) == "t" else "fp32",
                         int(m.group(2)), int(m.group(3)), regs, spills))
    if not rows:
        log("  scan ptxas: no report (the library was already built)")
        return
    for dtype, ns, lanes, regs, spills in sorted(rows):
        log(f"  scan ptxas: {dtype} N<={ns} lanes {lanes}: {regs} registers "
            f"a thread, {spills} bytes of spills")
        if spills:
            raise AssertionError(f"mamba_scan {dtype} N<={ns} lanes {lanes} "
                                 f"spills {spills} bytes")


def same(a: torch.Tensor, b: torch.Tensor) -> bool:
    return (a.dtype == b.dtype and a.shape == b.shape
            and bool(torch.equal(a, b)))


# ---------------------------------------------------------------------------
#  Phase 2: kernels
# ---------------------------------------------------------------------------
def probe_steps(slot_keys, slot_idx, max_probes: int,
                vals: torch.Tensor) -> int:
    """Table slots this probe batch visits in total (the data-dependent part
    of the hash probe's work)."""
    from repro_torch.kernels.hash_join import hash_keys
    size = slot_idx.shape[0]
    h = hash_keys([vals])
    done = torch.zeros(vals.shape[0], dtype=torch.bool, device=vals.device)
    steps = 0
    for step in range(max_probes):
        cand = (h + step) & (size - 1)
        steps += int((~done).sum())
        occ = slot_idx[cand]
        hit = (occ >= 0) & (slot_keys[0][cand] == vals)
        done |= hit | (occ < 0)
    return steps


def phase_hash_probe(bk, data):
    """The probe against each Q4.1 dimension at SF1, 1,048,576 rows of one
    chunk's keys: the packed table the backend caches (read from L2),
    byte-identical to the plain version over the build's slot arrays and
    over the packed table, twice, with its event time (CUDA events, host
    work included).  Returns the kernels line's row (``lookup_part``, with
    the other tables in a field) and a function that adds each table's
    device time from ``torch.profiler``: the caller runs it after the
    grouped sums' event times, because a profiler session leaves the host
    slower at launching for the rest of the process (about 0.004 ms a
    launch, PERF.md)."""
    from repro_torch.etl.queries import build_q4
    from repro_torch.kernels.hash_join import (hash_build, hash_probe,
                                               hash_probe_cuda,
                                               hash_probe_packed_ref,
                                               hash_probe_ref)
    lookups = {c.name: c for c in build_q4(data).flow.vertices.values()
               if type(c).__name__ == "Lookup"}
    chunk = 750_080                     # SF1 / 8 splits, 512-aligned
    bucket = bk.bucket_rows(chunk)      # 1,048,576 probe rows
    out, device_runs = {}, []
    for name, col in (("lookup_part", "lo_partkey"),
                      ("lookup_customer", "lo_custkey"),
                      ("lookup_supplier", "lo_suppkey"),
                      ("lookup_date", "lo_orderdate")):
        lk = lookups[name]
        ht = bk._dim_hash(lk.dim)
        packed = ht["packed"]
        # the plain version reads the build's own slot arrays
        built = hash_build((np.asarray(lk.dim.keys),))
        sk = tuple(torch.from_numpy(np.asarray(k, dtype=np.int32)).cuda()
                   for k in built["slot_keys"])
        si = torch.from_numpy(built["slot_idx"]).cuda()
        host = np.zeros(bucket, dtype=np.int32)
        host[:chunk] = data.lineorder[col][:chunk]
        vals = torch.from_numpy(host).cuda()
        mp = ht["max_probes"]
        if mp != built["max_probes"]:
            raise AssertionError(f"hash_probe[{name}]: the cached table's "
                                 f"max_probes differs from the build's")
        ridx, rfound = hash_probe_ref(sk, si, (vals,), mp)
        pidx, pfound = hash_probe_packed_ref(packed.slots, packed.n_keys,
                                             (vals,), mp)
        if not (same(ridx, pidx) and same(rfound, pfound)):
            raise AssertionError(f"hash_probe[{name}]: the plain version "
                                 f"over the packed table differs")
        a = hash_probe_cuda(packed, (vals,), mp)
        b = hash_probe_cuda(packed, (vals,), mp)
        torch.cuda.synchronize()
        if not (same(a[0], ridx) and same(a[1], rfound)):
            raise AssertionError(f"hash_probe[{name}] disagrees with plain")
        if not (same(a[0], b[0]) and same(a[1], b[1])):
            raise AssertionError(f"hash_probe[{name}] not bit-stable")
        # the op as the backend calls it
        ms = time_ms(lambda: hash_probe(packed, (vals,), mp, impl="cuda"),
                     iters=100)
        plain_ms = time_ms(lambda: hash_probe_ref(sk, si, (vals,), mp),
                           iters=5)
        keys = bk._dim_device(lk.dim)["keys"]

        def library():
            i = torch.searchsorted(keys, vals).clamp_(0, keys.shape[0] - 1)
            return keys[i] == vals
        library_ms = time_ms(library, iters=100)
        steps = probe_steps(sk, si, mp, vals)
        table_bytes = packed.slots.numel() * 4
        nbytes = bucket * 4 + table_bytes + bucket * (4 + 1)
        ops = bucket * 11 + steps * 4   # fmix32 + 3 per visited slot + cmp
        b, by = bound_ms(nbytes, ops)
        log(f"  hash_probe[{name}]: rows={bucket} T={packed.size} "
            f"table_bytes={table_bytes} max_probes={mp} "
            f"found={int(rfound.sum())} slots_visited={steps} ms={ms:.4f} "
            f"plain_ms={plain_ms:.4f} library_ms={library_ms:.4f} "
            f"bound_ms={b:.4f} ({by}) identical=True")
        out[name] = dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                         bound_ms=b, bound_by=by, max_abs_err=0.0)
        device_runs.append((name, functools.partial(
            hash_probe_cuda, packed, (vals,), mp)))

    def device_pass() -> None:
        for name, fn in device_runs:
            d = out[name]["device_ms"] = call_kernels(fn)[1]
            log(f"  hash_probe[{name}] device time (torch.profiler): "
                f"device_ms={'not measured' if d is None else f'{d:.4f}'}")
    main = out["lookup_part"]
    main["other_tables"] = {k: v for k, v in out.items()
                            if k != "lookup_part"}
    return main, device_pass


def _grouped_case(label, ids, vals, n_groups, kernel, plain, library,
                  with_counts: bool, exact: bool) -> dict:
    a = kernel(ids, vals, n_groups)
    b = kernel(ids, vals, n_groups)
    r = plain(ids, vals, n_groups)
    torch.cuda.synchronize()
    a = a if with_counts else (a,)
    b = b if with_counts else (b,)
    r = r if with_counts else (r,)
    for x, y in zip(a, b):
        if not same(x, y):
            raise AssertionError(f"{label}: two launches differ")
    err = rel = 0.0
    valid = (ids >= 0) & (ids < n_groups)
    vid = ids[valid].long()
    cnt = torch.zeros(n_groups, dtype=torch.float64, device=ids.device
                      ).index_add_(0, vid, torch.ones_like(vid,
                                                           dtype=torch.float64))
    acc64 = torch.zeros((n_groups, vals.shape[1]), dtype=torch.float64,
                        device=ids.device)
    absum = acc64.clone().index_add_(0, vid, vals[valid].abs().double())
    exact_sum = acc64.index_add_(0, vid, vals[valid].double())
    tol = 2.0 * (cnt[:, None] - 1.0).clamp(min=0.0) * U * absum
    err64 = float((a[0].double() - exact_sum).abs().div(
        absum.clamp(min=1e-30)).max()) if a[0].numel() else 0.0
    for i, (x, y) in enumerate(zip(a, r)):
        is_counts = with_counts and i == 1
        if x.shape != y.shape:
            raise AssertionError(f"{label}: shape {x.shape} vs {y.shape}")
        if x.numel():
            diff = (x - y).abs()
            err = max(err, float(diff.max()))
            rel = max(rel, float((diff / y.abs().clamp(min=1e-30)).max()))
        if exact or is_counts:
            if not same(x, y):
                raise AssertionError(f"{label}: not exact vs plain")
        elif not bool(((x - y).double().abs() <= tol).all()):
            raise AssertionError(f"{label}: beyond the float32 order bound "
                                 f"of plain")
    if not exact and err64 > FLOAT_RTOL:
        raise AssertionError(f"{label}: {err64:.3g} of sum|x| from the "
                             f"float64 sum, beyond rtol {FLOAT_RTOL}")
    n, c = vals.shape
    ms = time_ms(lambda: kernel(ids, vals, n_groups))
    plain_ms = time_ms(lambda: plain(ids, vals, n_groups), iters=10)
    library_ms = time_ms(library, iters=10)
    n_kernels, device_ms = call_kernels(lambda: kernel(ids, vals, n_groups))
    out_cols = c + (1 if with_counts else 0)
    nbytes = n * 4 + n * c * 4 + n_groups * out_cols * 4
    b, by = bound_ms(nbytes, n * out_cols)
    from repro_torch.kernels._grouped_sum import is_direct
    direct = is_direct(n_groups, c, with_counts)
    log(f"  {label}: rows={n} C={c} groups={n_groups} "
        f"route={'direct' if direct else 'partitioned'} "
        f"{'exact' if exact else 'order-bound'} max_abs_err={err:.6g} "
        f"max_rel_err={rel:.3g} err_vs_f64={err64:.3g} ms={ms:.4f} "
        f"plain_ms={plain_ms:.4f} slower_than_plain={ms > plain_ms} "
        f"library_ms={library_ms:.4f} bound_ms={b:.4f} ({by}) "
        f"bit_stable=True kernels_a_call="
        f"{n_kernels if n_kernels is not None else 'not measured'} "
        f"device_ms_a_call="
        f"{f'{device_ms:.4f}' if device_ms is not None else 'not measured'}")
    return dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms, bound_ms=b,
                bound_by=by, max_abs_err=err, kernels_a_call=n_kernels,
                direct=direct)


def call_kernels(fn, attempts: int = 3):
    """Device kernels one call of ``fn`` launches and their summed device
    time in ms, from ``torch.profiler`` (copies and memsets not counted).
    Beside the call's event time, this says how much of it is the host's.
    A session that records no kernel (the profiler drops one now and then)
    is run again; after ``attempts`` such sessions, (None, None): not
    measured."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for _ in range(attempts):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        spans = [e.time_range for e in prof.events()
                 if e.device_type == DeviceType.CUDA
                 and not e.name.startswith(("Memcpy", "Memset"))]
        if spans:
            return len(spans), sum(t.end - t.start for t in spans) / 1e3
    return None, None


def check_main_launches(label: str, m: dict) -> None:
    """A grouped sum on the direct route runs at most two kernels a call.
    The partitioned route (an id space too large for a warp's shared
    partial, as the supplier shard's 2,000 cells) also runs its counting
    sort's passes: it is exempt, and its count is printed."""
    if not m["direct"]:
        log(f"  {label}: partitioned route, kernels_a_call="
            f"{m['kernels_a_call']} (exempt from the two-kernel check)")
        return
    if m["kernels_a_call"] is not None and m["kernels_a_call"] > 2:
        raise AssertionError(f"{label}: one call launched "
                             f"{m['kernels_a_call']} device kernels, more "
                             f"than 2")


def _index_add_yardstick(ids, vals, n_groups, with_counts):
    """One ``index_add_`` over the valid rows (timed, never used by the
    port)."""
    valid = (ids >= 0) & (ids < n_groups)
    idx = ids[valid].long()
    src = vals[valid]
    if with_counts:
        src = torch.cat([src, torch.ones_like(src[:, :1])], dim=1)
    acc = torch.zeros((n_groups, src.shape[1]), dtype=torch.float32,
                      device=ids.device)
    return lambda: acc.index_add_(0, idx, src)


def phase_radix_groupby(rng) -> dict:
    from repro_torch.kernels.radix_groupby import (radix_groupby,
                                                   radix_groupby_ref)
    kernel = functools.partial(radix_groupby, impl="cuda")
    dev = torch.device("cuda")
    # the Q4.1 shape: ~96k surviving rows over 7 years x 21 nation ids
    # (147 cells; the 35 AMERICA cells occupied), profit values
    n, cells = 96_000, 147
    years = rng.integers(0, 7, n)
    nations = rng.choice([0, 5, 10, 15, 20], n)
    ids = torch.from_numpy((years * 21 + nations).astype(np.int32)).to(dev)
    profit = rng.integers(30_000, 1_060_000, (n, 1)).astype(np.float32)
    small = rng.integers(0, 8, (n, 1)).astype(np.float32)
    results = {}
    for label, vals, exact in (("q41_profit", profit, False),
                               ("q41_int", small, True)):
        v = torch.from_numpy(vals).to(dev)
        results[label] = _grouped_case(
            f"radix_groupby[{label}]", ids, v, cells, kernel,
            radix_groupby_ref, _index_add_yardstick(ids, v, cells, True),
            with_counts=True, exact=exact)
        check_main_launches(f"radix_groupby[{label}]", results[label])
    # the sharded runs' shapes: one of 4 shards' Q4.1 partial (a quarter of
    # the surviving rows), and one of 4 shards of the supplier Aggregate
    # (1.5M rows; hash partitioning leaves about 500 of the 2,000 supplier
    # keys on a shard, spread over the whole key range, so 2,000 cells)
    n = 24_000
    ids = torch.from_numpy((rng.integers(0, 7, n) * 21
                            + rng.choice([0, 5, 10, 15, 20], n)
                            ).astype(np.int32)).to(dev)
    v = torch.from_numpy(rng.integers(30_000, 1_060_000, (n, 1))
                         .astype(np.float32)).to(dev)
    check_main_launches("radix_groupby[q41_shard]", _grouped_case(
        "radix_groupby[q41_shard]", ids, v, 147, kernel, radix_groupby_ref,
        _index_add_yardstick(ids, v, 147, True), with_counts=True,
        exact=False))
    n, cells = 1_500_000, 2_000
    keys = rng.choice(cells, 500, replace=False)
    ids = torch.from_numpy(rng.choice(keys, n).astype(np.int32)).to(dev)
    v = torch.from_numpy(rng.integers(90_000, 10_000_000, (n, 1))
                         .astype(np.float32)).to(dev)
    check_main_launches("radix_groupby[supplier_shard]", _grouped_case(
        "radix_groupby[supplier_shard]", ids, v, cells, kernel,
        radix_groupby_ref, _index_add_yardstick(ids, v, cells, True),
        with_counts=True, exact=False))
    # many partitions: 2^20 cells, 4M rows, ~2% padding rows
    n, cells = 4 << 20, 1 << 20
    big = rng.integers(0, cells, n).astype(np.int32)
    big[rng.random(n) < 0.02] = -1
    ids = torch.from_numpy(big).to(dev)
    for label, vals, exact in (
            ("2^20cells_int", rng.integers(0, 8, (n, 1)), True),
            ("2^20cells_float", rng.random((n, 2)), False)):
        v = torch.from_numpy(vals.astype(np.float32)).to(dev)
        _grouped_case(f"radix_groupby[{label}]", ids, v, cells,
                      kernel, radix_groupby_ref,
                      _index_add_yardstick(ids, v, cells, True),
                      with_counts=True, exact=exact)
    return results["q41_profit"]


def phase_segment_sum(rng) -> dict:
    from repro_torch.kernels.segment_sum import segment_sum, segment_sum_ref
    kernel = functools.partial(segment_sum, impl="cuda")
    dev = torch.device("cuda")
    # the Q1.1 shape: ~112k surviving rows, one global group, revenue
    n = 112_000
    ids = torch.zeros(n, dtype=torch.int32, device=dev)
    rev = (rng.integers(90_000, 1_100_000, n)
           * rng.integers(1, 4, n)).astype(np.float32)[:, None]
    small = rng.integers(0, 100, (n, 1)).astype(np.float32)
    results = {}
    for label, vals, exact in (("q11_revenue", rev, False),
                               ("q11_int", small, True)):
        v = torch.from_numpy(vals).to(dev)
        results[label] = _grouped_case(
            f"segment_sum[{label}]", ids, v, 1, kernel,
            segment_sum_ref, _index_add_yardstick(ids, v, 1, False),
            with_counts=False, exact=exact)
        check_main_launches(f"segment_sum[{label}]", results[label])
    # the sharded runs' shapes: one of 4 shards' Q1.1 partial, and the mesh
    # combiner's float sums over the shards' partial rows in shard order:
    # Q4.1's 35 groups from each of 4 shards, the supplier Aggregate's
    # 2,000 groups each from one shard
    n = 28_000
    v = torch.from_numpy(rev[:n].copy()).to(dev)
    check_main_launches("segment_sum[q11_shard]", _grouped_case(
        "segment_sum[q11_shard]", ids[:n], v, 1, kernel, segment_sum_ref,
        _index_add_yardstick(ids[:n], v, 1, False), with_counts=False,
        exact=False))
    for label, comb in (("q41_combiner", np.tile(np.arange(35), 4)),
                        ("supplier_combiner", rng.permutation(2_000))):
        g = int(comb.max()) + 1
        cids = torch.from_numpy(comb.astype(np.int32)).to(dev)
        v = torch.from_numpy(rng.integers(30_000, 1 << 30, (len(comb), 1))
                             .astype(np.float32)).to(dev)
        check_main_launches(f"segment_sum[{label}]", _grouped_case(
            f"segment_sum[{label}]", cids, v, g, kernel, segment_sum_ref,
            _index_add_yardstick(cids, v, g, False), with_counts=False,
            exact=False))
    n, groups = 1 << 20, 4096
    ids = torch.from_numpy(rng.integers(0, groups, n).astype(np.int32)).to(dev)
    v = torch.from_numpy(rng.integers(0, 16, (n, 1)).astype(np.float32)).to(dev)
    _grouped_case("segment_sum[G=4096_int]", ids, v, groups, kernel,
                  segment_sum_ref, _index_add_yardstick(ids, v, groups, False),
                  with_counts=False, exact=True)
    return results["q11_revenue"]


# ---------------------------------------------------------------------------
#  Phase 2, LM kernels
# ---------------------------------------------------------------------------
#: bf16 flash attention against the plain version: both round the output to
#: bf16 (relative step 2^-8) and the probabilities to bf16 before the value
#: product, at other points of the softmax (the CPU tests' bf16 tolerance)
FLASH_TOL_BF16 = (2e-2, 2e-2)
#: fp32 flash attention: fp32 sums in other orders (the CPU tests' tolerance)
FLASH_TOL_F32 = (2e-4, 2e-5)
#: the scan (fp32 arithmetic on either input dtype): fused multiply-adds,
#: exp as ex2.approx of a prescaled A, the N-state sum in another order;
#: the state is a contraction, so the gaps do not grow with T
SCAN_TOL = (1e-4, 1e-4)


def allowed_pairs(Sq: int, Skv: int, causal: bool, window: int) -> int:
    """(q, k) pairs the mask allows: the data-dependent part of the work."""
    q = np.arange(Sq, dtype=np.int64)
    hi = np.minimum(Skv - 1, q) if causal else np.full(Sq, Skv - 1)
    lo = np.maximum(0, q - window + 1) if window > 0 else np.zeros(Sq,
                                                                  np.int64)
    return int(np.maximum(0, hi - lo + 1).sum())


def _check_close(label, got, want, tol) -> float:
    rtol, atol = tol
    err = float((got.float() - want.float()).abs().max()) if got.numel() \
        else 0.0
    if not torch.allclose(got.float(), want.float(), rtol=rtol, atol=atol):
        raise AssertionError(f"{label}: max_abs_err {err:.3g} beyond rtol "
                             f"{rtol} atol {atol} of the plain version")
    return err


def _flash_case(label, gen, B, Sq, Skv, Kh, G, hd, causal, window, softcap,
                dtype, library: bool) -> dict:
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_ref)

    def rand(*shape):
        return torch.randn(shape, generator=gen, device=gen.device).to(dtype)
    q, k, v = rand(B, Sq, Kh, G, hd), rand(B, Skv, Kh, hd), rand(B, Skv, Kh,
                                                                 hd)
    kw = dict(causal=causal, window=window, softcap=softcap)
    a = flash_attention(q, k, v, impl="cuda", **kw)
    b = flash_attention(q, k, v, impl="cuda", **kw)
    r = flash_attention_ref(q, k, v, **kw)
    torch.cuda.synchronize()
    if not same(a, b):
        raise AssertionError(f"flash_attention[{label}]: two launches differ")
    tol = FLASH_TOL_BF16 if dtype == torch.bfloat16 else FLASH_TOL_F32
    err = _check_close(f"flash_attention[{label}]", a, r, tol)
    ms = time_ms(lambda: flash_attention(q, k, v, impl="cuda", **kw))
    plain_ms = time_ms(lambda: flash_attention_ref(q, k, v, **kw), iters=5)
    library_ms = None
    if library:
        import torch.nn.functional as F
        qt = q.reshape(B, Sq, Kh * G, hd).transpose(1, 2).contiguous()
        kt, vt = (t.transpose(1, 2).contiguous() for t in (k, v))
        library_ms = time_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=causal, enable_gqa=G > 1))
    pairs = allowed_pairs(Sq, Skv, causal, window)
    flops = 4 * B * Kh * G * hd * pairs
    nbytes = (2 * q.numel() + k.numel() + v.numel()) * q.element_size()
    # bf16 products: the tensor cores; fp32: FMAs outside them
    bnd, by = bound_ms(nbytes, flops, PEAK_BF16_S if dtype == torch.bfloat16
                       else PEAK_OPS_S)
    lib = f"{library_ms:.4f}" if library_ms is not None else "none"
    log(f"  flash_attention[{label}]: B={B} Sq={Sq} Skv={Skv} Kh={Kh} G={G} "
        f"hd={hd} causal={causal} window={window} softcap={softcap} "
        f"{str(dtype).split('.')[-1]} pairs={pairs} max_abs_err={err:.3g} "
        f"tol={tol} ms={ms:.4f} plain_ms={plain_ms:.4f} library_ms={lib} "
        f"bound_ms={bnd:.4f} ({by}) tflops={flops / ms / 1e9:.2f} "
        f"share_of_bound={bnd / ms:.4f} bit_stable=True")
    return dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                bound_ms=bnd, bound_by=by, max_abs_err=err)


def phase_flash_attention(gen) -> dict:
    """Both flash kernels at the stablelm-3b prefill shape (4 prompts of
    2048 tokens, 32 heads (MHA), hd 80, causal), each beside
    scaled_dot_product_attention in its dtype; the kernels line's flash row
    is the bf16 tensor-core kernel the served model runs, with the fp32 FMA
    kernel's numbers in fields of their own."""
    bf16, f32 = torch.bfloat16, torch.float32
    shape = (4, 2048, 2048, 32, 1, 80, True, 0, 0.0)
    main = _flash_case("stablelm-3b prefill, bf16 tensor cores", gen, *shape,
                       bf16, library=True)
    fp32 = _flash_case("stablelm-3b prefill, fp32 FMA", gen, *shape, f32,
                       library=True)
    main.update({f"fp32_{k}": fp32[k] for k in ("ms", "plain_ms",
                                                "library_ms", "bound_ms",
                                                "max_abs_err")})
    # the options that path does not use: GQA, window, softcap, ragged
    # lengths, Sq != Skv, rows with no allowed key, other head dims
    for args in (("gqa+window+softcap", 2, 300, 300, 2, 4, 128, True, 100,
                  30.0, bf16),
                 ("cross ragged hd256", 1, 77, 213, 1, 2, 256, False, 0, 0.0,
                  bf16),
                 ("masked rows bf16 hd8", 1, 100, 20, 1, 2, 8, False, 10, 0.0,
                  bf16),
                 ("causal Sq>Skv bf16", 1, 200, 70, 2, 2, 96, True, 0, 0.0,
                  bf16),
                 ("masked rows fp32", 1, 100, 20, 1, 2, 16, False, 10, 0.0,
                  f32),
                 ("smoke hd16 fp32", 2, 40, 40, 4, 1, 16, True, 0, 0.0,
                  f32),
                 # the fp32 kernel's tile shapes follow hd: every head dim,
                 # each with options that cross its tile edges
                 ("masked rows fp32 hd8", 1, 100, 20, 1, 2, 8, False, 10,
                  0.0, f32),
                 ("gqa+window fp32 hd32", 2, 300, 300, 2, 4, 32, True, 100,
                  0.0, f32),
                 ("softcap ragged fp32 hd64", 1, 257, 257, 2, 1, 64, True, 0,
                  30.0, f32),
                 ("causal Sq>Skv fp32 hd80", 1, 200, 70, 2, 2, 80, True, 0,
                  0.0, f32),
                 ("cross ragged fp32 hd96", 1, 77, 213, 1, 2, 96, False, 0,
                  0.0, f32),
                 ("gqa+window+softcap fp32 hd128", 2, 300, 300, 2, 4, 128,
                  True, 100, 30.0, f32),
                 ("causal Sq<Skv fp32 hd256", 1, 70, 200, 1, 2, 256, True, 0,
                  0.0, f32)):
        _flash_case(*args[:1], gen, *args[1:], library=False)
    return main


def _scan_inputs(gen, Bt, T, d, N, zero_h0, dtype=torch.float32):
    """delta and x in ``dtype`` (as the model passes them), the rest fp32."""
    dev = gen.device

    def rand(*shape):
        return torch.randn(shape, generator=gen, device=dev)
    delta = torch.rand((Bt, T, d), generator=gen, device=dev) * 0.99 + 0.01
    A = -rand(d, N).abs() - 0.05
    h0 = (torch.zeros((Bt, d, N), device=dev) if zero_h0
          else rand(Bt, d, N))
    return (delta.to(dtype), rand(Bt, T, d).to(dtype), rand(Bt, T, N),
            rand(Bt, T, N), A, h0)


def _scan_case(label, gen, Bt, T, d, N, zero_h0=False,
               dtype=torch.float32) -> dict:
    from repro_torch.kernels.mamba_scan import mamba_scan, mamba_scan_ref
    args = _scan_inputs(gen, Bt, T, d, N, zero_h0, dtype)
    y, hT = mamba_scan(*args, impl="cuda")
    y2, hT2 = mamba_scan(*args, impl="cuda")
    y_r, hT_r = mamba_scan_ref(*args)
    torch.cuda.synchronize()
    if not (same(y, y2) and same(hT, hT2)):
        raise AssertionError(f"mamba_scan[{label}]: two launches differ")
    err = max(_check_close(f"mamba_scan[{label}] y", y, y_r, SCAN_TOL),
              _check_close(f"mamba_scan[{label}] hT", hT, hT_r, SCAN_TOL))
    if dtype == torch.bfloat16:
        y_w, hT_w = mamba_scan(args[0].float(), args[1].float(), *args[2:],
                               impl="cuda")
        if not (same(y, y_w) and same(hT, hT_w)):
            raise AssertionError(f"mamba_scan[{label}]: bf16 inputs differ "
                                 f"from the widened ones")
    del y2, hT2, y_r, hT_r
    ms = time_ms(lambda: mamba_scan(*args, impl="cuda"))
    plain_ms = time_ms(lambda: mamba_scan_ref(*args), iters=3, warmup=1)
    # bytes at the dtypes passed (inputs read once, y and hT written once)
    # against one exp2 a (b, t, c, n)
    nbytes = sum(t.numel() * t.element_size() for t in args) + 4 * (
        y.numel() + hT.numel())
    bnd, by = bound_ms(nbytes, Bt * T * d * N, PEAK_EX2_S)
    log(f"  mamba_scan[{label}]: Bt={Bt} T={T} d={d} N={N} "
        f"{str(dtype).split('.')[-1]} max_abs_err={err:.3g} tol={SCAN_TOL} "
        f"ms={ms:.4f} plain_ms={plain_ms:.4f} library_ms=none "
        f"bound_ms={bnd:.4f} ({by}) GB/s={nbytes / ms / 1e6:.1f} "
        f"share_of_bound={bnd / ms:.4f} bit_stable=True"
        + (" same_as_widened=True" if dtype == torch.bfloat16 else ""))
    return dict(ms=ms, plain_ms=plain_ms, library_ms=None, bound_ms=bnd,
                bound_by=by, max_abs_err=err)


def scan_lanes(gen, Bt, T, d, N, dtype) -> dict:
    """The kernel with a channel's states split over 1, 2 and 4 lanes at
    one shape: the final states bit-identical, y within SCAN_TOL of the
    plain version; the median time of each."""
    from repro_torch.kernels.mamba_scan import mamba_scan_ref
    from repro_torch.kernels.mamba_scan.ops import (default_lanes,
                                                    mamba_scan_cuda)
    args = _scan_inputs(gen, Bt, T, d, N, True, dtype)
    y_r, _ = mamba_scan_ref(*args)
    out, first = {}, None
    for lanes in (1, 2, 4):
        y, hT = mamba_scan_cuda(*args, lanes=lanes)
        if first is None:
            first = hT
        elif not same(hT, first):
            raise AssertionError(f"mamba_scan lanes {lanes}: final states "
                                 f"differ from lanes 1")
        _check_close(f"mamba_scan lanes {lanes}", y, y_r, SCAN_TOL)
        del y, hT
        out[lanes] = time_ms(lambda: mamba_scan_cuda(*args, lanes=lanes))
    log(f"  mamba_scan lanes a channel ({str(dtype).split('.')[-1]}, Bt={Bt} "
        f"T={T} d={d} N={N}): "
        + ", ".join(f"{k}: {v:.4f} ms" for k, v in out.items())
        + f"; the wrapper takes {default_lanes(Bt, d)}")
    return out


def phase_mamba_scan(gen) -> dict:
    """The scan at the falcon-mamba-7b prefill shape (4 prompts of 2048
    tokens, d_inner 8192, N 16) with bf16 delta/x, as the model passes
    them (the kernels line's row), and with fp32 ones (fields of their
    own), each lane split timed there and at 1 prompt; then ragged and
    small cases and the bit-identical continuation in both dtypes."""
    from repro_torch.kernels.mamba_scan import mamba_scan
    bf16, f32 = torch.bfloat16, torch.float32
    shape = (4, 2048, 8192, 16)
    main = _scan_case("falcon-mamba-7b prefill, bf16 delta/x", gen, *shape,
                      zero_h0=True, dtype=bf16)
    fp32 = _scan_case("falcon-mamba-7b prefill, fp32 delta/x", gen, *shape,
                      zero_h0=True, dtype=f32)
    main.update({f"fp32_{k}": fp32[k] for k in ("ms", "plain_ms", "bound_ms",
                                                "bound_by", "max_abs_err")})
    # the lane split: the wrapper's choice (ops.default_lanes) at falcon's
    # width with 4 prompts and with 1
    main["lanes_ms"] = scan_lanes(gen, *shape, bf16)
    main["fp32_lanes_ms"] = scan_lanes(gen, *shape, f32)
    main["one_prompt_lanes_ms"] = scan_lanes(gen, 1, *shape[1:], bf16)
    for dtype in (bf16, f32):
        name = str(dtype).split(".")[-1]
        _scan_case(f"ragged T/d {name}", gen, 3, 333, 1000, 16, dtype=dtype)
        _scan_case(f"smoke N=8 {name}", gen, 2, 100, 130, 8, dtype=dtype)
        _scan_case(f"odd d N=5 {name}", gen, 2, 70, 131, 5, dtype=dtype)
        # continuation: [0, T1) then [T1, T) from its hT is the full scan
        dl, x, Bm, Cm, A, h0 = _scan_inputs(gen, 2, 512, 1024, 16, True,
                                            dtype)
        y, hT = mamba_scan(dl, x, Bm, Cm, A, h0, impl="cuda")
        halves = (slice(0, 200), slice(200, 512))
        y1, h1 = mamba_scan(*(t[:, halves[0]].contiguous() for t in
                              (dl, x, Bm, Cm)), A, h0, impl="cuda")
        y2, h2 = mamba_scan(*(t[:, halves[1]].contiguous() for t in
                              (dl, x, Bm, Cm)), A, h1, impl="cuda")
        if not (same(torch.cat([y1, y2], 1), y) and same(h2, hT)):
            raise AssertionError(f"mamba_scan {name}: the two halves differ "
                                 f"from the full scan")
        log(f"  mamba_scan[continuation {name}]: Bt=2 T=200+312 d=1024 N=16 "
            f"bit-identical to the full scan")
    return main


# ---------------------------------------------------------------------------
#  Phase 3: ETL main path
# ---------------------------------------------------------------------------
def check_oracle(got: dict, expect: dict, rtol: float, label: str) -> None:
    for k, want in expect.items():
        have = np.asarray(got[k])
        if have.shape != want.shape:
            raise AssertionError(f"{label}: {k} shape {have.shape} vs "
                                 f"oracle {want.shape}")
        if want.dtype.kind in "iu":
            if not np.array_equal(have.astype(np.int64), want):
                raise AssertionError(f"{label}: {k} differs from the oracle")
        elif not np.allclose(have.astype(np.float64), want, rtol=rtol,
                             atol=0.0):
            raise AssertionError(f"{label}: {k} beyond rtol {rtol} of the "
                                 f"oracle")


def run_main(data, expect: dict):
    """Every run of the main path, through ``Session.run``, with the launch
    counters set to 0 once before the first and read after the last;
    returns the total launches per kernel, the Q4.1 walls by engine and
    each (query, engine)'s table."""
    import repro_torch
    from repro_torch.core import resolve_backend
    from repro_torch.etl.queries import build_q1, build_q4, build_q4_staged
    from repro_torch.kernels import launch_counts, reset_launches
    rtol = resolve_backend("torch").oracle_rtol
    session = repro_torch.Session(backend="torch")
    rows = len(data.lineorder["lo_orderkey"])
    walls: dict = {}
    tables: dict = {}
    torch.cuda.synchronize()
    reset_launches()
    # Q4.1s: Q4.1 with a StageBoundary after its lookups, two trees that
    # stream into each other; its oracle is Q4.1's
    for qname, build, engine in (("Q4.1", build_q4, "optimized"),
                                 ("Q4.1", build_q4, "streaming"),
                                 ("Q4.1s", build_q4_staged, "streaming"),
                                 ("Q1.1", build_q1, "optimized")):
        results = []
        for attempt in (1, 2):
            q = build(data)
            n_lookups = sum(type(c).__name__ == "Lookup"
                            for c in q.flow.vertices.values())
            before = launch_counts()
            res = session.run(q, engine=engine, fuse=True, num_splits=8)
            run = res.run
            torch.cuda.synchronize()
            after = launch_counts()
            counts = {k: after[k] - before[k] for k in after}
            got = res.table
            label = f"{qname}/{run.engine}#{attempt}"
            check_oracle(got, expect[qname[:4]], rtol, label)
            if run.degradations != 0:
                raise AssertionError(f"{label}: {run.degradations} "
                                     f"degradations")
            chunks = -(-rows // run.runtime_plan.chunk_rows)
            if counts["hash_probe"] != n_lookups * chunks:
                raise AssertionError(
                    f"{label}: hash_probe launched {counts['hash_probe']} "
                    f"times, expected {n_lookups} lookups x {chunks} chunks")
            need = ("radix_groupby" if qname.startswith("Q4.1")
                    else "segment_sum")
            if counts[need] < 1:
                raise AssertionError(f"{label}: {need} never launched")
            log(f"  {label}: wall={run.wall_time:.4f}s "
                f"rows/s={rows / run.wall_time:.6g} h2d={run.h2d_transfers} "
                f"h2d_bytes={run.h2d_bytes} d2h={run.d2h_transfers} "
                f"d2h_bytes={run.d2h_bytes} dispatch={run.dispatch_calls} "
                f"degradations={run.degradations} groups="
                f"{len(next(iter(got.values())))} launches={counts} "
                f"oracle_rtol={rtol} ok")
            if qname == "Q4.1":
                walls.setdefault(engine, []).append(run.wall_time)
            results.append(got)
        first, second = results
        for k in first:
            if (first[k].dtype != second[k].dtype
                    or first[k].tobytes() != second[k].tobytes()):
                raise AssertionError(f"{qname}/{engine}: second run "
                                     f"differs in {k}")
        log(f"  {qname}/{engine}: second run byte-identical")
        tables[qname, engine] = first
    torch.cuda.synchronize()
    return launch_counts(), walls, tables


def run_baselines(data, expect: dict, walls: dict) -> None:
    """SF1 Q4.1 once on each copy-everywhere baseline (``ordinary``, and
    ``kettle``: a thread a component, a copy a hop) through
    ``Session.run`` on the card, against the oracle; then all four engines'
    Q4.1 walls and rows/s side by side (the paper's Kettle comparison)."""
    import repro_torch
    from repro_torch.core import resolve_backend
    from repro_torch.etl.queries import build_q4
    from repro_torch.kernels import launch_counts
    rtol = resolve_backend("torch").oracle_rtol
    rows = len(data.lineorder["lo_orderkey"])
    session = repro_torch.Session(backend="torch")
    for engine in ("ordinary", "kettle"):
        before = launch_counts()
        res = session.run(build_q4(data), engine=engine)
        torch.cuda.synchronize()
        after = launch_counts()
        run = res.run
        label = f"Q4.1/{engine}"
        check_oracle(res.table, expect["Q4.1"], rtol, label)
        if run.degradations != 0:
            raise AssertionError(f"{label}: {run.degradations} degradations")
        for k in ("hash_probe", "radix_groupby"):
            if after[k] - before[k] < 1:
                raise AssertionError(f"{label}: {k} never launched")
        log(f"  {label}: wall={run.wall_time:.4f}s "
            f"rows/s={rows / run.wall_time:.6g} copies={run.copies} "
            f"h2d={run.h2d_transfers} d2h={run.d2h_transfers} "
            f"dispatch={run.dispatch_calls} launches="
            f"{ {k: after[k] - before[k] for k in after} } "
            f"oracle_rtol={rtol} ok")
        walls[engine] = [run.wall_time]
    log("  Q4.1 on four engines (SF1, torch; ordinary and kettle: one run; "
        "optimized and streaming: fused, 8 splits, the better of two runs):")
    for engine in ("ordinary", "kettle", "optimized", "streaming"):
        w = min(walls[engine])
        log(f"    {engine:10s} wall={w:.4f}s rows/s={rows / w:.6g}")


# ---------------------------------------------------------------------------
#  Phase 3a: sharded runs
# ---------------------------------------------------------------------------
SHARDS = 4
PROCESS_SHARDS = 2
#: the three ETL kernels, whose launches every sharded run prints
ETL_KERNELS = ("hash_probe", "radix_groupby", "segment_sum")


def suppkey_flow(data):
    """lineorder -> Aggregate(lo_suppkey: revenue sum, row count) -> sink.
    Keyed on a source column, so the shard planner partitions by hash (each
    supplier's rows on one shard); 2,000 groups at SF1."""
    from repro_torch.core.graph import Dataflow
    from repro_torch.etl.components import Aggregate, ArraySource, CollectSink
    flow = Dataflow("suppkey-revenue")
    sink = CollectSink("sink")
    flow.chain(ArraySource("lineorder", data.lineorder),
               Aggregate("by_supplier", ["lo_suppkey"],
                         {"revenue": ("lo_revenue", "sum"),
                          "orders": ("lo_revenue", "count")}),
               sink)
    return flow, sink


def suppkey_oracle(data) -> dict:
    key = data.lineorder["lo_suppkey"]
    uniq, inv = np.unique(key, return_inverse=True)
    return {"lo_suppkey": uniq,
            "revenue": np.bincount(inv, weights=data.lineorder["lo_revenue"]
                                   .astype(np.float64)),
            "orders": np.bincount(inv).astype(np.int64)}


def same_as_serial(got: dict, want: dict, label: str) -> float:
    """Keys, group order, counts and dtypes identical to the serial run;
    float sums within FLOAT_RTOL of it.  Returns the largest relative gap
    of a float column."""
    if list(got) != list(want):
        raise AssertionError(f"{label}: columns {list(got)} vs serial "
                             f"{list(want)}")
    gap = 0.0
    for k, w in want.items():
        g = got[k]
        if g.dtype != w.dtype or g.shape != w.shape:
            raise AssertionError(f"{label}: {k} is {g.dtype}{g.shape}, "
                                 f"serial {w.dtype}{w.shape}")
        if w.dtype.kind == "f":
            if not np.allclose(g, w, rtol=FLOAT_RTOL, atol=0.0):
                raise AssertionError(f"{label}: {k} beyond rtol "
                                     f"{FLOAT_RTOL} of the serial run")
            nz = w != 0
            if nz.any():
                gap = max(gap, float(np.max(np.abs(g[nz] - w[nz])
                                            / np.abs(w[nz]))))
        elif g.tobytes() != w.tobytes():
            raise AssertionError(f"{label}: {k} differs from the serial run")
    return gap


def sharded_run(session, label: str, q, expect: dict, serial: dict,
                rows: int, need: tuple, **opts):
    """One sharded ``Session.run`` (streaming, fused, 8 splits) with the
    launch counters set to 0 just before it and read just after: checked
    against the serial run and the oracle, with no degradation, every
    source row on one shard and each kernel of ``need`` launched.  Prints
    the run's line; returns its table, run and launches (a process-route
    run's include its workers')."""
    from repro_torch.core import resolve_backend
    from repro_torch.kernels import launch_counts, reset_launches
    rtol = resolve_backend("torch").oracle_rtol
    torch.cuda.synchronize()
    reset_launches()
    res = session.run(q, engine="streaming", fuse=True, num_splits=8, **opts)
    torch.cuda.synchronize()
    counts = launch_counts()
    run, got = res.run, res.table
    if run.degradations != 0:
        raise AssertionError(f"{label}: degradations "
                             f"{run.degradation_events}")
    if run.shards != opts["shards"] or run.shard is None:
        raise AssertionError(f"{label}: ran {run.shards} shards, asked for "
                             f"{opts['shards']}")
    if sum(run.shard_rows) != rows:
        raise AssertionError(f"{label}: shard rows {run.shard_rows} do not "
                             f"sum to {rows}")
    gap = same_as_serial(got, serial, label)
    check_oracle(got, expect, rtol, label)
    for k, n in run.shard.worker_launches.items():
        counts[k] += n
    for k in need:
        if counts[k] < 1:
            raise AssertionError(f"{label}: {k} never launched")
    sr = run.shard
    log(f"  {label}: impl={sr.impl} mode={sr.mode} wall={run.wall_time:.4f}s "
        f"rows/s={rows / run.wall_time:.6g} shard_rows={run.shard_rows} "
        f"h2d={run.h2d_transfers} d2h={run.d2h_transfers} "
        f"dispatch={run.dispatch_calls} shuffle_bytes={sr.shuffle_bytes} "
        f"scatter_s={sr.scatter_seconds:.4f} "
        f"combiner={sr.combiner_copies or None} launches="
        f"{ {k: counts[k] for k in ETL_KERNELS} } "
        f"max_rel_gap_vs_serial={gap:.3g} oracle_rtol={rtol} ok")
    return got, run, counts


def phase_sharded(data, expect: dict, serial: dict) -> dict:
    """SF1 over shards through ``Session.run`` on ``torch``: Q4.1 on the
    mesh route (``auto``) twice, bit-identical; Q4.1 inline; Q1.1 on the
    mesh route; the hash-mode supplier flow; Q4.1 on the process route at
    2 shards, twice (the first spawns the workers).  Returns the launches
    of all these runs, each counted from 0 just before it."""
    import repro_torch
    from repro_torch.core.shard import proc
    from repro_torch.etl.queries import build_q1, build_q4
    session = repro_torch.Session(backend="torch", metadata=None)
    rows = len(data.lineorder["lo_orderkey"])
    total = {k: 0 for k in ETL_KERNELS}

    def add(counts):
        for k in total:
            total[k] += counts[k]

    q41 = serial["Q4.1", "streaming"]
    tables = []
    for attempt in (1, 2):
        got, run, counts = sharded_run(
            session, f"Q4.1 shards={SHARDS} auto#{attempt}", build_q4(data),
            expect["Q4.1"], q41, rows, ETL_KERNELS, shards=SHARDS,
            shard_impl="auto")
        if run.shard.impl != "mesh" or run.shard.mode != "range":
            raise AssertionError(f"Q4.1: auto took {run.shard.impl}/"
                                 f"{run.shard.mode}, expected mesh/range")
        chunks = sum(-(-n // run.runtime_plan.chunk_rows)
                     for n in run.shard_rows)
        if counts["hash_probe"] != 4 * chunks:
            raise AssertionError(f"Q4.1 sharded: hash_probe launched "
                                 f"{counts['hash_probe']} times, expected 4 "
                                 f"lookups x {chunks} chunks")
        if counts["radix_groupby"] != SHARDS:
            raise AssertionError(f"Q4.1 sharded: radix_groupby launched "
                                 f"{counts['radix_groupby']} times, expected "
                                 f"one a shard")
        add(counts)
        tables.append(got)
    for k in tables[0]:
        if tables[0][k].tobytes() != tables[1][k].tobytes():
            raise AssertionError(f"Q4.1 mesh: second run differs in {k}")
    log(f"  Q4.1 shards={SHARDS} mesh: second run bit-identical")
    _, run, counts = sharded_run(
        session, f"Q4.1 shards={SHARDS} inline", build_q4(data),
        expect["Q4.1"], q41, rows, ("hash_probe", "radix_groupby"),
        shards=SHARDS, shard_impl="inline")
    add(counts)
    _, run, counts = sharded_run(
        session, f"Q1.1 shards={SHARDS} mesh", build_q1(data),
        expect["Q1.1"], serial["Q1.1", "optimized"], rows,
        ("hash_probe", "segment_sum"), shards=SHARDS, shard_impl="mesh")
    add(counts)
    supp = session.run(suppkey_flow(data), engine="streaming", fuse=True,
                       num_splits=8)
    supp_serial = supp.table
    log(f"  lo_suppkey serial: wall={supp.run.wall_time:.4f}s "
        f"rows/s={rows / supp.run.wall_time:.6g}")
    _, run, counts = sharded_run(
        session, f"lo_suppkey shards={SHARDS} mesh", suppkey_flow(data),
        suppkey_oracle(data), supp_serial, rows,
        ("radix_groupby", "segment_sum"), shards=SHARDS, shard_impl="auto")
    if run.shard.mode != "hash" or run.shard.impl != "mesh":
        raise AssertionError(f"lo_suppkey: {run.shard.impl}/"
                             f"{run.shard.mode}, expected mesh/hash")
    add(counts)
    walls = []
    try:
        for attempt in (1, 2):
            _, run, counts = sharded_run(
                session, f"Q4.1 shards={PROCESS_SHARDS} process#{attempt}",
                build_q4(data), expect["Q4.1"], q41, rows,
                ("hash_probe", "radix_groupby"), shards=PROCESS_SHARDS,
                shard_impl="process")
            if run.shard.impl != "process":
                raise AssertionError(f"Q4.1 process: ran {run.shard.impl}")
            add(counts)
            walls.append(run.wall_time)
            secs = [{k: round(v, 4) for k, v in w.items()}
                    for w in run.shard.worker_seconds]
            log(f"    process route: payloads {run.shard.payload_bytes} "
                f"bytes pickled in {run.shard.payload_seconds:.4f}s; "
                f"fan-out {run.shard.fanout_seconds:.4f}s; workers' "
                f"seconds {secs}; worker launches "
                f"{run.shard.worker_launches}")
    finally:
        proc.close_pool()
    log(f"  Q4.1 process route: first run (spawns {PROCESS_SHARDS} workers) "
        f"{walls[0]:.4f}s, second {walls[1]:.4f}s: spawn and worker start "
        f"about {walls[0] - walls[1]:.4f}s")
    return total


# ---------------------------------------------------------------------------
#  Phase 3b: served Q4.1
# ---------------------------------------------------------------------------
#: micro-batches the served phase splits SF1's lineorder into; an empty tick
#: goes in after the EMPTY_AFTER-th
SERVE_TICKS = 12
EMPTY_AFTER = 6


def served_q41_flow(data, sort: bool = False):
    """SSB Q4.1 through ``repro_torch.flow``, as the declarative example
    (``examples/declarative_q41.py``) builds it.  Without its sort, the flow
    ends in its Aggregate, as a serving flow must, and its source holds only
    the schema; with it, the source holds all of lineorder for a batch run."""
    import repro_torch
    from repro_torch.etl import DimTable
    from repro_torch.etl.ssb import mfgr_id, region_id
    col = repro_torch.col
    AMERICA = region_id("AMERICA")
    M1, M2 = mfgr_id("MFGR#1"), mfgr_id("MFGR#2")
    cust = DimTable(data.customer["c_custkey"],
                    {"c_nation": data.customer["c_nation"]},
                    row_filter=data.customer["c_region"] == AMERICA)
    supp = DimTable(data.supplier["s_suppkey"],
                    {"s_nation": data.supplier["s_nation"]},
                    row_filter=data.supplier["s_region"] == AMERICA)
    part = DimTable(data.part["p_partkey"], {"p_mfgr": data.part["p_mfgr"]},
                    row_filter=((data.part["p_mfgr"] == M1)
                                | (data.part["p_mfgr"] == M2)))
    date = DimTable(data.date["d_datekey"], {"d_year": data.date["d_year"]})
    source = (data.lineorder if sort else
              {c: a[:0] for c, a in data.lineorder.items()})
    b = (repro_torch.flow("q4.1-declarative")
         .source(source, name="lineorder")
         .lookup(cust, "lo_custkey", {"c_nation": "c_nation"})
         .lookup(supp, "lo_suppkey", {"s_nation": "s_nation"})
         .lookup(part, "lo_partkey", {"p_mfgr": "p_mfgr"})
         .lookup(date, "lo_orderdate", {"d_year": "d_year"})
         .filter((col("c_nation") >= 0) & (col("s_nation") >= 0)
                 & (col("p_mfgr") >= 0) & (col("d_year") >= 0))
         .project("d_year", "c_nation", "lo_revenue", "lo_supplycost")
         .derive("profit", col("lo_revenue") - col("lo_supplycost"))
         .aggregate(["d_year", "c_nation"], {"profit": ("profit", "sum")}))
    return (b.sort(["d_year", "c_nation"]) if sort else b).sink()


def phase_served_q41(data, expect: dict, profile: bool) -> dict:
    """SF1's lineorder served through ``Session.serve`` in SERVE_TICKS
    micro-batches plus one empty tick, fused, 8 splits, on ``torch``.  The
    replayed deltas must equal a batch ``Session.run`` of the same flow with
    its sort (keys, order, dtypes; profit within oracle_rtol of it and of
    the oracle); each tick must probe 4 x chunks times and reduce with the
    radix groupby when it has rows; warm ticks compile and upload nothing;
    the empty tick emits nothing; no tick is retried or dead-lettered.
    Returns the phase's launches, counted from 0 just before its first tick
    and read after its last."""
    import repro_torch
    from repro_torch.core import resolve_backend
    from repro_torch.kernels import launch_counts, reset_launches
    rtol = resolve_backend("torch").oracle_rtol
    session = repro_torch.Session(backend="torch", metadata=None)
    batch = session.run(served_q41_flow(data, sort=True), engine="streaming",
                        fuse=True, num_splits=8)
    check_oracle(batch.table, expect["Q4.1"], rtol, "served Q4.1/batch")
    n = len(data.lineorder["lo_orderkey"])
    ticks = [{c: a[idx] for c, a in data.lineorder.items()}
             for idx in np.array_split(np.arange(n), SERVE_TICKS)]
    ticks.insert(EMPTY_AFTER, {c: a[:0] for c, a in data.lineorder.items()})
    results, per_tick = [], []
    torch.cuda.synchronize()
    reset_launches()
    t_session = time.perf_counter()
    with session.serve(served_q41_flow(data), fuse=True,
                       num_splits=8) as srv:
        for i, cols in enumerate(ticks):
            before = launch_counts()
            if profile and i == SERVE_TICKS // 2 + 2:
                profile_device(f"served Q4.1 tick {i} (warm)",
                               lambda: results.append(srv.tick(cols)))
            else:
                results.append(srv.tick(cols))
            torch.cuda.synchronize()
            after = launch_counts()
            per_tick.append({k: after[k] - before[k] for k in after})
        chunk_rows = srv.engine.runtime_plan.chunk_rows
    session_s = time.perf_counter() - t_session
    launches = launch_counts()
    for t, counts in zip(results, per_tick):
        label = f"served Q4.1 tick {t.tick}"
        if t.retries or t.dead_lettered:
            raise AssertionError(f"{label}: retries={t.retries} "
                                 f"dead_lettered={t.dead_lettered}")
        chunks = -(-t.rows_in // chunk_rows)
        if counts["hash_probe"] != 4 * chunks:
            raise AssertionError(f"{label}: hash_probe launched "
                                 f"{counts['hash_probe']} times, expected "
                                 f"4 lookups x {chunks} chunks")
        if t.rows_in and counts["radix_groupby"] < 1:
            raise AssertionError(f"{label}: radix_groupby never launched")
        cs = t.cache_stats
        if t.tick > 0 and (cs["segment_compiles"] or cs["dim_h2d_transfers"]):
            raise AssertionError(f"{label}: warm tick compiled "
                                 f"{cs['segment_compiles']} segments and "
                                 f"uploaded {cs['dim_h2d_transfers']} "
                                 f"dimension arrays")
        if t.rows_in == 0 and t.rows_out != 0:
            raise AssertionError(f"{label}: the empty tick emitted "
                                 f"{t.rows_out} rows")
        log(f"  {label}: rows_in={t.rows_in} rows_out={t.rows_out} "
            f"wall={t.wall_s:.4f}s h2d={cs['h2d_transfers']} "
            f"d2h={cs['d2h_transfers']} segment_compiles="
            f"{cs['segment_compiles']} dim_h2d={cs['dim_h2d_transfers']} "
            f"launches={counts}")
    served = repro_torch.replay_deltas(results, group_by=["d_year",
                                                           "c_nation"])
    for k in ("d_year", "c_nation"):
        if (served[k].dtype != batch.table[k].dtype
                or served[k].tobytes() != batch.table[k].tobytes()):
            raise AssertionError(f"served Q4.1: replayed {k} differs from "
                                 f"the batch run")
    if not np.allclose(served["profit"], batch.table["profit"], rtol=rtol,
                       atol=0.0):
        raise AssertionError(f"served Q4.1: profit beyond rtol {rtol} of the "
                             f"batch run")
    check_oracle(served, expect["Q4.1"], rtol, "served Q4.1/replay")
    walls = [t.wall_s for t in results]
    warm = [t.wall_s for t in results[1:] if t.rows_in]
    log(f"  served Q4.1: {len(results)} ticks ({SERVE_TICKS} of "
        f"{n // SERVE_TICKS}-{-(-n // SERVE_TICKS)} rows + 1 empty), "
        f"chunk_rows={chunk_rows}; cold tick wall={walls[0]:.4f}s; warm "
        f"non-empty ticks p50={statistics.median(warm):.4f}s "
        f"max={max(warm):.4f}s; tick p50={statistics.median(walls):.4f}s "
        f"max={max(walls):.4f}s; session {session_s:.3f}s, "
        f"rows/s={n / session_s:.6g}; ticks' wall sum={sum(walls):.3f}s; "
        f"replay equals the batch run, within oracle_rtol {rtol} of the "
        f"oracle; launches={launches} ok")
    return launches


#: value columns of the wide Aggregate: more than the grouped sum's 32 a
#: launch, so the radix groupby sums them in two batches
WIDE_OUTPUTS = 40


def wide_aggregate(backend: str, cols: dict):
    """One keyed Aggregate with WIDE_OUTPUTS sums on ``backend``: the sink's
    table, the radix-groupby launches and the run."""
    from repro_torch.core import OptimizedEngine, OptimizeOptions
    from repro_torch.core.graph import Dataflow
    from repro_torch.etl.components import Aggregate, ArraySource, CollectSink
    from repro_torch.kernels import launch_counts, reset_launches
    flow = Dataflow("wide-aggregate")
    src = ArraySource("rows", cols)
    agg = Aggregate("sums", ["k1", "k2"],
                    {f"s{i}": (f"v{i}", "sum") for i in range(WIDE_OUTPUTS)})
    sink = CollectSink("sink")
    flow.chain(src, agg, sink)
    reset_launches()
    run = OptimizedEngine(flow, OptimizeOptions(backend=backend,
                                                num_splits=4)).run()
    if backend == "torch":
        torch.cuda.synchronize()
    return sink.result(), launch_counts()["radix_groupby"], run


def phase_wide_aggregate(rng) -> None:
    """A keyed Aggregate with 40 sum outputs (Q4.1's 147 group cells,
    600,000 rows) on backend torch, held against torch_cpu: keys
    byte-identical, integer-valued sums exact, float sums within the
    backend's oracle_rtol; on the card the radix groupby launches twice
    (32 + 8 columns), once on the CPU route never."""
    from repro_torch.core import resolve_backend
    n = 600_000
    cols = {"k1": rng.integers(1992, 1999, n), "k2": rng.integers(0, 21, n)}
    for i in range(WIDE_OUTPUTS):
        cols[f"v{i}"] = (rng.integers(0, 1000, n) if i % 2 else
                         rng.random(n) * 1e3)
    rtol = resolve_backend("torch").oracle_rtol
    got, launches, run = wide_aggregate("torch", cols)
    want, cpu_launches, _ = wide_aggregate("torch_cpu", cols)
    if launches != 2 or cpu_launches != 0:
        raise AssertionError(f"wide Aggregate: radix_groupby launched "
                             f"{launches} times on torch, {cpu_launches} on "
                             f"torch_cpu; expected 2 and 0")
    if set(got) != set(want):
        raise AssertionError("wide Aggregate: other output columns")
    err = 0.0
    for k, w in want.items():
        g = np.asarray(got[k])
        if g.shape != w.shape:
            raise AssertionError(f"wide Aggregate: {k} shape {g.shape} vs "
                                 f"{w.shape}")
        if k in ("k1", "k2") or int(k[1:]) % 2:
            if g.tobytes() != w.tobytes():
                raise AssertionError(f"wide Aggregate: {k} differs from "
                                     f"torch_cpu")
        else:
            err = max(err, float(np.max(np.abs(g - w) / np.abs(w))))
            if not np.allclose(g, w, rtol=rtol, atol=0.0):
                raise AssertionError(f"wide Aggregate: {k} beyond rtol {rtol}"
                                     f" of torch_cpu")
    log(f"  wide Aggregate: {n} rows, {WIDE_OUTPUTS} sums over "
        f"{len(want['k1'])} groups on torch in {run.wall_time:.3f}s, "
        f"radix_groupby launches={launches}; keys and integer sums "
        f"identical to torch_cpu, float sums max_rel_err={err:.3g} "
        f"(oracle_rtol {rtol}) ok")


def profile_device(label: str, fn) -> None:
    """Run ``fn`` once under ``torch.profiler``: the device's busy time by
    kernel and its idle share of the wall time (the profiler's own overhead
    inflates the wall)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    spans = sorted((e.time_range.start, e.time_range.end, e.name)
                   for e in prof.events() if e.device_type == DeviceType.CUDA)
    if not spans:
        log(f"  profile {label}: no device events recorded (device time not "
            f"measured)")
        return
    busy_us, reach = 0.0, float("-inf")      # union of the device intervals
    by_name: dict = {}
    for start, end, name in spans:
        busy_us += max(0.0, end - max(start, reach))
        reach = max(reach, end)
        tot, cnt = by_name.get(name, (0.0, 0))
        by_name[name] = (tot + end - start, cnt + 1)
    busy = busy_us / 1e6
    log(f"  profile {label}: wall={wall:.4f}s device_busy={busy:.4f}s "
        f"idle_share={1.0 - busy / wall:.4f} device_events={len(spans)}")
    for name, (us, cnt) in sorted(by_name.items(), key=lambda kv: -kv[1][0]
                                  )[:12]:
        log(f"    {us / 1e3:10.3f} ms  x{cnt:<5d} {name[:100]}")


def profile_q41(data) -> None:
    """One more fused Q4.1 run on the optimized engine under the
    profiler."""
    import repro_torch
    from repro_torch.etl.queries import build_q4
    q = build_q4(data)
    session = repro_torch.Session(backend="torch", metadata=None)
    profile_device("Q4.1/optimized",
                   lambda: session.run(q, engine="optimized", fuse=True,
                                       num_splits=8))


# ---------------------------------------------------------------------------
#  Phase 4: LM serving path
# ---------------------------------------------------------------------------
#: fp32 logits of the kernel and plain routes: fp32 sums taken in other
#: orders, grown through up to 64 layers of a random network
F32_LOGITS_ATOL = 1e-2
#: the reference's own teacher-forcing tolerance (tests/test_models.py)
TF_TOL = (0.05, 0.05)
#: bf16 logits: the kernel route may stand no further from the fp32 plain
#: route than twice the bf16 plain route does, plus this margin.  Each
#: route rounds to bf16 at other points, and a random 32-layer network
#: grows those differences, so a fixed bf16 tolerance would measure the
#: network, not the kernel
BF16_MARGIN = 1e-2
SERVE = dict(requests=8, batch=4, prompt_len=2048, max_new=32)


def _gap(got: torch.Tensor, want: torch.Tensor):
    """Largest absolute difference and the share of rows with the same
    argmax; raises on non-finite logits."""
    g, w = got.float(), want.float()
    if not bool(torch.isfinite(g).all()):
        raise AssertionError("logits not finite")
    return (float((g - w).abs().max()),
            float((g.argmax(-1) == w.argmax(-1)).float().mean()))


def _top_layers(params, n: int):
    """The same parameter tree cut to its first ``n`` layers (views)."""
    def cut(t):
        return {k: cut(v) for k, v in t.items()} if isinstance(t, dict) \
            else t[:n]
    return dict(params, blocks=cut(params["blocks"]))


@torch.no_grad()
def serve_model(arch: str, kernel: str, ref_depth: int,
                dev: torch.device, profile: bool = False) -> int:
    """Serve ``SERVE`` through ``BatchedServer`` twice at the full width of
    ``arch``; returns the launches of ``kernel`` in those two runs."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import launch_counts, reset_launches
    from repro_torch.launch.serve import BatchedServer, make_requests
    from repro_torch.models import transformer as tf
    cfg = get_config(arch)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = tf.init_params(cfg, seed=0, device=dev)
    torch.cuda.synchronize()
    log(f"{arch}: {tf.param_count(cfg) / 1e9:.3f}B {cfg.param_dtype} params "
        f"({cfg.n_layers} layers, d_model {cfg.d_model}, compute "
        f"{cfg.compute_dtype}) made on the card in "
        f"{time.perf_counter() - t0:.1f}s; card: {card_line()}")
    server = BatchedServer(cfg, params=params, batch=SERVE["batch"],
                           device=str(dev))
    waves = -(-SERVE["requests"] // SERVE["batch"])
    outputs = []
    torch.cuda.synchronize()
    reset_launches()
    for attempt in (1, 2):
        before = launch_counts()[kernel]
        stats0 = dict(server.stats)
        reqs = make_requests(cfg, SERVE["requests"], SERVE["prompt_len"],
                             SERVE["max_new"], seed=0)
        t = time.perf_counter()
        done = server.run(reqs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        launched = launch_counts()[kernel] - before
        if launched != cfg.n_layers * waves:
            raise AssertionError(f"{arch}#{attempt}: {kernel} launched "
                                 f"{launched} times, expected {cfg.n_layers} "
                                 f"layers x {waves} waves")
        toks = [r.out_tokens for r in done]
        if any(len(tk) != SERVE["max_new"] or min(tk) < 0
               or max(tk) >= cfg.vocab_size for tk in toks):
            raise AssertionError(f"{arch}#{attempt}: bad output tokens")
        st = {k: server.stats[k] - stats0[k] for k in stats0}
        n_tok = sum(len(tk) for tk in toks)
        log(f"  {arch}#{attempt}: {len(done)} requests in {waves} waves, "
            f"{n_tok} tokens in {wall:.3f}s ({n_tok / wall:.1f} tok/s); "
            f"prefill {st['prefill_s'] / st['prefills'] * 1e3:.1f} ms a wave "
            f"of {SERVE['batch']}x{SERVE['prompt_len']}; decode "
            f"{st['decode_s'] / st['decode_steps'] * 1e3:.2f} ms a step "
            f"({st['decode_steps']:.0f} steps); {kernel} launches={launched}")
        outputs.append(toks)
    torch.cuda.synchronize()
    launches = launch_counts()[kernel]
    if outputs[0] != outputs[1]:
        raise AssertionError(f"{arch}: the second run gave other tokens")
    log(f"  {arch}: second run token-identical; peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.1f} GiB")

    # the kernel route against the plain route, last-position prefill
    # logits, with the fp32 plain route as the yardstick
    prompts = np.stack([r.prompt for r in make_requests(
        cfg, SERVE["batch"], SERVE["prompt_len"], 1, seed=0)])
    toks = torch.tensor(prompts, dtype=torch.long, device=dev)
    ref_depth = min(ref_depth, cfg.n_layers)
    rcfg = cfg.replace(n_layers=ref_depth)
    rparams = _top_layers(params, ref_depth)
    plain = dict(attn_impl="reference", ssm_impl="reference")

    def last_logits(c):
        return tf.forward_prefill(rparams, {"tokens": toks}, c)[0]
    truth = last_logits(rcfg.replace(compute_dtype="float32", **plain))
    scale = float(truth.abs().max())
    e32, a32 = _gap(last_logits(rcfg.replace(compute_dtype="float32")), truth)
    ek, ak = _gap(last_logits(rcfg), truth)
    ep, ap_ = _gap(last_logits(rcfg.replace(**plain)), truth)
    log(f"  {arch}: prefill logits at depth {ref_depth} of {cfg.n_layers} "
        f"(|logits| max {scale:.3g}) against the fp32 plain route: fp32 "
        f"kernel route max_abs_err={e32:.3g} argmax_agree={a32:.3f}; "
        f"{cfg.compute_dtype} kernel route {ek:.4g} ({ak:.3f}); "
        f"{cfg.compute_dtype} plain route {ep:.4g} ({ap_:.3f})")
    if e32 > F32_LOGITS_ATOL:
        raise AssertionError(f"{arch}: fp32 kernel route {e32:.3g} from the "
                             f"plain route, beyond {F32_LOGITS_ATOL}")
    if ek > 2.0 * ep + BF16_MARGIN:
        raise AssertionError(f"{arch}: {cfg.compute_dtype} kernel route "
                             f"{ek:.4g} from the fp32 model, beyond twice the "
                             f"plain route's {ep:.4g} + {BF16_MARGIN}")

    # teacher forcing in fp32: prefill S-4 tokens, then 4 decode steps ==
    # prefill S
    S = SERVE["prompt_len"]
    fcfg = cfg.replace(compute_dtype="float32")
    lg, cache = tf.forward_prefill(params, {"tokens": toks[:, :S - 4]}, fcfg)
    cache = tf.grow_cache(cache, fcfg, S)
    for t in range(S - 4, S):
        lg, cache = tf.decode_step(params, cache, {"tokens": toks[:, t:t + 1]},
                                   fcfg)
    lg_full, _ = tf.forward_prefill(params, {"tokens": toks}, fcfg)
    err, agree = _gap(lg, lg_full)
    log(f"  {arch}: fp32 prefill {S - 4} + 4 decode steps vs prefill {S}: "
        f"max_abs_err={err:.3g} argmax_agree={agree:.3f} tol={TF_TOL}")
    if not torch.allclose(lg.float(), lg_full.float(), rtol=TF_TOL[0],
                          atol=TF_TOL[1]):
        raise AssertionError(f"{arch}: decode disagrees with prefill")
    del cache
    if profile:
        out = {}

        def prefill():
            out["cache"] = tf.forward_prefill(params, {"tokens": toks},
                                              cfg)[1]
        profile_device(f"{arch} prefill {SERVE['batch']}x{S}", prefill)
        cache = tf.grow_cache(out.pop("cache"), cfg, S + 1)
        profile_device(f"{arch} decode step at {S}",
                       lambda: tf.decode_step(params, cache,
                                              {"tokens": toks[:, -1:]}, cfg))
    del server, params, rparams
    torch.cuda.empty_cache()
    return launches


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--profile", action="store_true",
                    help="also profile one more fused Q4.1 run, one warm "
                         "served Q4.1 tick, and one prefill and one decode "
                         "step of each LM (device busy time by kernel, "
                         "idle share)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    t_start = time.perf_counter()
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.core import resolve_backend
    from repro_torch.etl.queries import build_q1, build_q4
    from repro_torch.etl.ssb import generate
    from repro_torch.kernels import _cuda

    # fp32 comparisons in full fp32: no TF32 in matmuls or convolutions
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # ---- phase 1: setup
    log(f"python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}")
    card = card_line()
    log(f"card: {card}")
    t0 = time.perf_counter()
    _cuda.library()
    log(f"kernel build: {time.perf_counter() - t0:.1f}s "
        f"(nvcc {_cuda.build_seconds:.1f}s) from {_cuda.CSRC}")
    log(f"ptxas: {ptxas_summary(_cuda.build_log)}")
    flash_ptxas(_cuda.build_log)
    scan_ptxas(_cuda.build_log)
    probe_ptxas(_cuda.build_log)
    bk = resolve_backend("torch")
    rng = np.random.default_rng(0)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)

    # ---- phase 2: kernels vs plain versions at the main paths' shapes
    t0 = time.perf_counter()
    data = generate(**SF1)
    log(f"SSB SF1 generated in {time.perf_counter() - t0:.1f}s: lineorder "
        f"{len(data.lineorder['lo_orderkey'])}, customer "
        f"{len(data.customer['c_custkey'])}, supplier "
        f"{len(data.supplier['s_suppkey'])}, part "
        f"{len(data.part['p_partkey'])}, date {len(data.date['d_datekey'])}")
    log("kernels:")
    probe, probe_device_pass = phase_hash_probe(bk, data)
    measured = {"hash_probe": probe,
                "radix_groupby": phase_radix_groupby(rng),
                "segment_sum": phase_segment_sum(rng)}
    probe_device_pass()
    measured["flash_attention"] = phase_flash_attention(gen)
    measured["mamba_scan"] = phase_mamba_scan(gen)
    torch.cuda.empty_cache()

    # ---- phase 3: the ETL main path
    log("ETL main path (SSB SF1, backend torch, fused, 8 splits):")
    t0 = time.perf_counter()
    expect = {"Q4.1": build_q4(data).oracle(data),
              "Q1.1": build_q1(data).oracle(data)}
    log(f"  oracles in {time.perf_counter() - t0:.1f}s")
    launches, walls, serial = run_main(data, expect)
    log("Q4.1 on the copy-everywhere baselines (SSB SF1, backend torch):")
    run_baselines(data, expect, walls)
    log(f"sharded runs (SSB SF1, backend torch, fused, streaming, 8 splits):")
    for k, v in phase_sharded(data, expect, serial).items():
        launches[k] += v
    log(f"served Q4.1 (SSB SF1 in {SERVE_TICKS} ticks and an empty one, "
        f"backend torch, fused, 8 splits):")
    served = phase_served_q41(data, expect, args.profile)
    for k, v in served.items():
        launches[k] += v
    if args.profile:
        profile_q41(data)
    del data
    log("Aggregate wider than one grouped-sum launch:")
    phase_wide_aggregate(rng)

    # ---- phase 4: the LM serving path, one model at a time
    log(f"LM serving path ({SERVE}):")
    launches["flash_attention"] = serve_model(
        "stablelm-3b", "flash_attention", ref_depth=32, dev=gen.device,
        profile=args.profile)
    launches["mamba_scan"] = serve_model(
        "falcon-mamba-7b", "mamba_scan", ref_depth=8, dev=gen.device,
        profile=args.profile)

    # ---- phase 5: result lines
    sources = {"hash_probe": ("src/repro_torch/csrc/hash_probe.cu",
                              "src/repro/kernels/hash_join/kernel.py:68"),
               "radix_groupby": ("src/repro_torch/csrc/radix_groupby.cu",
                                 "src/repro/kernels/radix_groupby/kernel.py:73"),
               "segment_sum": ("src/repro_torch/csrc/segment_sum.cu",
                               "src/repro/kernels/segment_sum/kernel.py:62"),
               "flash_attention": (
                   "src/repro_torch/csrc/flash_attention_mma.cu",
                   "src/repro/kernels/flash_attention/kernel.py:111"),
               "mamba_scan": ("src/repro_torch/csrc/mamba_scan.cu",
                              "src/repro/kernels/mamba_scan/kernel.py:79")}
    kernels = []
    for name, (src, replaces) in sources.items():
        m = measured[name]
        row = {"name": name, "route": "cuda", "source": src,
               "replaces": replaces, "launches": launches[name],
               "max_abs_err": m["max_abs_err"], "ms": m["ms"],
               "plain_ms": m["plain_ms"], "bound_ms": m["bound_ms"],
               "bound_by": m["bound_by"], "library_ms": m["library_ms"]}
        if name == "hash_probe":
            row.update({k: m[k] for k in ("device_ms", "other_tables")})
            row["probe_note"] = ("1,048,576 rows against part; device_ms "
                                 "from torch.profiler; other_tables: "
                                 "customer, supplier and date")
        if name == "flash_attention":
            row.update({k: v for k, v in m.items() if k.startswith("fp32_")})
            row["fp32_note"] = ("the fp32 FMA kernel "
                                "(src/repro_torch/csrc/flash_attention.cu) "
                                "at the same shape; its bound is fp32 FMAs "
                                "at 67 TFLOP/s")
        if name == "mamba_scan":
            row.update({k: v for k, v in m.items()
                        if k.startswith("fp32_") or k.endswith("lanes_ms")})
            row["fp32_note"] = ("the same kernel on fp32 delta/x at the same "
                                "shape; the row's own numbers are for bf16 "
                                "delta/x, as the model passes them")
            row["library_note"] = ("none: no single PyTorch call computes "
                                   "the selective scan")
        kernels.append(row)
    log(f"chip_smoke wall: {time.perf_counter() - t_start:.1f}s")
    print(json.dumps({"kernels": kernels}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
