"""Drive the PyTorch/CUDA port (``repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py                 # all phases
    python3 chip_smoke.py --profile       # all phases + a profiled Q4.1 run

Phases (any failure raises and the script exits non-zero):

1. Setup: torch/CUDA versions, the card's name and power limit, and the
   build of every ``src/repro_torch/csrc/*.cu`` kernel (timed).
2. Kernels: each hand-written kernel against its plain torch version on the
   card, at the shapes SSB scale factor 1 gives it, twice (bit-identical),
   with its median time (CUDA events), its bound, the plain version's time
   and a PyTorch library call as a yardstick the port never calls.
3. Main path: SSB scale factor 1 (seed 42) through the port's engines on
   backend ``torch`` with segment fusion: Q4.1 on OptimizedEngine and
   StreamingEngine, Q1.1 on OptimizedEngine.  Each run is checked against
   the query's float64 oracle and repeated (the second run must be
   byte-identical).  The launch counters are set to 0 just before the main
   path's first run and read after its last; each run's own launches must
   show that it went through the kernels.
4. The ``kernels`` JSON line, the card line and, last,
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


def bound_ms(nbytes: float, ops: float):
    t_bytes = nbytes / PEAK_BYTES_S * 1e3
    t_ops = ops / PEAK_OPS_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def ptxas_summary(build_log: str) -> str:
    """Entry points, most registers a thread and total spill bytes, from
    what ``nvcc -Xptxas -v`` printed."""
    regs = [int(m) for m in re.findall(r"Used (\d+) registers", build_log)]
    spills = sum(int(m) for m in re.findall(r"(\d+) bytes spill", build_log))
    if not regs:
        return "no report (the library was already built)"
    return (f"{len(regs)} entry points, at most {max(regs)} registers a "
            f"thread, {spills} bytes of spills")


def same(a: torch.Tensor, b: torch.Tensor) -> bool:
    return (a.dtype == b.dtype and a.shape == b.shape
            and bool(torch.equal(a, b)))


# ---------------------------------------------------------------------------
#  Phase 2: kernels
# ---------------------------------------------------------------------------
def probe_steps(ht, vals: torch.Tensor) -> int:
    """Table slots this probe batch visits in total (the data-dependent part
    of the hash probe's work)."""
    from repro_torch.kernels.hash_join import hash_keys
    size = ht["slot_idx"].shape[0]
    h = hash_keys([vals])
    done = torch.zeros(vals.shape[0], dtype=torch.bool, device=vals.device)
    steps = 0
    for step in range(ht["max_probes"]):
        cand = (h + step) & (size - 1)
        steps += int((~done).sum())
        occ = ht["slot_idx"][cand]
        hit = (occ >= 0) & (ht["slot_keys"][0][cand] == vals)
        done |= hit | (occ < 0)
    return steps


def phase_hash_probe(bk, data) -> dict:
    from repro_torch.etl.queries import build_q4
    from repro_torch.kernels.hash_join import hash_probe, hash_probe_ref
    lookups = {c.name: c for c in build_q4(data).flow.vertices.values()
               if type(c).__name__ == "Lookup"}
    chunk = 750_080                     # SF1 / 8 splits, 512-aligned
    bucket = bk.bucket_rows(chunk)      # 1,048,576 probe rows
    out = {}
    for name, col in (("lookup_part", "lo_partkey"),
                      ("lookup_customer", "lo_custkey")):
        lk = lookups[name]
        ht = bk._dim_hash(lk.dim)
        host = np.zeros(bucket, dtype=np.int32)
        host[:chunk] = data.lineorder[col][:chunk]
        vals = torch.from_numpy(host).cuda()
        args = (ht["slot_keys"], ht["slot_idx"], (vals,), ht["max_probes"])
        idx1, found1 = hash_probe(*args, impl="cuda")
        idx2, found2 = hash_probe(*args, impl="cuda")
        ridx, rfound = hash_probe_ref(*args)
        torch.cuda.synchronize()
        if not (same(idx1, ridx) and same(found1, rfound)):
            raise AssertionError(f"hash_probe[{name}] disagrees with plain")
        if not (same(idx1, idx2) and same(found1, found2)):
            raise AssertionError(f"hash_probe[{name}] not bit-stable")
        T = ht["slot_idx"].shape[0]
        ms = time_ms(lambda: hash_probe(*args, impl="cuda"))
        plain_ms = time_ms(lambda: hash_probe_ref(*args), iters=5)
        keys = bk._dim_device(lk.dim)["keys"]

        def library():
            i = torch.searchsorted(keys, vals).clamp_(0, keys.shape[0] - 1)
            return keys[i] == vals
        library_ms = time_ms(library)
        steps = probe_steps(ht, vals)
        nbytes = bucket * 4 + T * 8 + bucket * (4 + 1)
        ops = bucket * 11 + steps * 4   # fmix32 + 3 per visited slot + cmp
        b, by = bound_ms(nbytes, ops)
        log(f"  hash_probe[{name}]: rows={bucket} T={T} "
            f"max_probes={ht['max_probes']} found={int(found1.sum())} "
            f"slots_visited={steps} ms={ms:.4f} plain_ms={plain_ms:.4f} "
            f"library_ms={library_ms:.4f} bound_ms={b:.4f} ({by}) "
            f"identical=True")
        out[name] = dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                         bound_ms=b, bound_by=by, max_abs_err=0.0)
    return out["lookup_part"]


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
    out_cols = c + (1 if with_counts else 0)
    nbytes = n * 4 + n * c * 4 + n_groups * out_cols * 4
    b, by = bound_ms(nbytes, n * out_cols)
    log(f"  {label}: rows={n} C={c} groups={n_groups} "
        f"{'exact' if exact else 'order-bound'} max_abs_err={err:.6g} "
        f"max_rel_err={rel:.3g} err_vs_f64={err64:.3g} ms={ms:.4f} "
        f"plain_ms={plain_ms:.4f} "
        f"library_ms={library_ms:.4f} bound_ms={b:.4f} ({by}) "
        f"bit_stable=True")
    return dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms, bound_ms=b,
                bound_by=by, max_abs_err=err)


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
    n, groups = 1 << 20, 4096
    ids = torch.from_numpy(rng.integers(0, groups, n).astype(np.int32)).to(dev)
    v = torch.from_numpy(rng.integers(0, 16, (n, 1)).astype(np.float32)).to(dev)
    _grouped_case("segment_sum[G=4096_int]", ids, v, groups, kernel,
                  segment_sum_ref, _index_add_yardstick(ids, v, groups, False),
                  with_counts=False, exact=True)
    return results["q11_revenue"]


# ---------------------------------------------------------------------------
#  Phase 3: main path
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


def run_main(data, expect: dict) -> dict:
    """Every run of the main path, with the launch counters set to 0 once
    before the first and read after the last; returns the total launches
    per kernel."""
    from repro_torch.core import (OptimizedEngine, OptimizeOptions,
                                  StreamingEngine, resolve_backend)
    from repro_torch.etl.queries import build_q1, build_q4
    from repro_torch.kernels import launch_counts, reset_launches
    rtol = resolve_backend("torch").oracle_rtol
    opts = OptimizeOptions(backend="torch", fuse_segments=True, num_splits=8)
    rows = len(data.lineorder["lo_orderkey"])
    torch.cuda.synchronize()
    reset_launches()
    for qname, build, engine in (("Q4.1", build_q4, OptimizedEngine),
                                 ("Q4.1", build_q4, StreamingEngine),
                                 ("Q1.1", build_q1, OptimizedEngine)):
        results = []
        for attempt in (1, 2):
            q = build(data)
            n_lookups = sum(type(c).__name__ == "Lookup"
                            for c in q.flow.vertices.values())
            before = launch_counts()
            run = engine(q.flow, opts).run()
            torch.cuda.synchronize()
            after = launch_counts()
            counts = {k: after[k] - before[k] for k in after}
            got = q.sink.result()
            label = f"{qname}/{run.engine}#{attempt}"
            check_oracle(got, expect[qname], rtol, label)
            if run.degradations != 0:
                raise AssertionError(f"{label}: {run.degradations} "
                                     f"degradations")
            chunks = -(-rows // run.runtime_plan.chunk_rows)
            if counts["hash_probe"] != n_lookups * chunks:
                raise AssertionError(
                    f"{label}: hash_probe launched {counts['hash_probe']} "
                    f"times, expected {n_lookups} lookups x {chunks} chunks")
            need = "radix_groupby" if qname == "Q4.1" else "segment_sum"
            if counts[need] < 1:
                raise AssertionError(f"{label}: {need} never launched")
            log(f"  {label}: wall={run.wall_time:.3f}s "
                f"rows/s={rows / run.wall_time:.4g} h2d={run.h2d_transfers} "
                f"h2d_bytes={run.h2d_bytes} d2h={run.d2h_transfers} "
                f"d2h_bytes={run.d2h_bytes} dispatch={run.dispatch_calls} "
                f"degradations={run.degradations} groups="
                f"{len(next(iter(got.values())))} launches={counts} "
                f"oracle_rtol={rtol} ok")
            results.append(got)
        first, second = results
        for k in first:
            if (first[k].dtype != second[k].dtype
                    or first[k].tobytes() != second[k].tobytes()):
                raise AssertionError(f"{qname}/{engine.__name__}: second run "
                                     f"differs in {k}")
        log(f"  {qname}/{engine.__name__}: second run byte-identical")
    torch.cuda.synchronize()
    return launch_counts()


def profile_q41(data) -> None:
    """One more fused Q4.1 run on OptimizedEngine under ``torch.profiler``:
    the device's busy time by kernel and its idle share of the run's wall
    time (the profiler's own overhead inflates the wall)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core import OptimizedEngine, OptimizeOptions
    from repro_torch.etl.queries import build_q4
    q = build_q4(data)
    opts = OptimizeOptions(backend="torch", fuse_segments=True, num_splits=8)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        OptimizedEngine(q.flow, opts).run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    spans = sorted((e.time_range.start, e.time_range.end, e.name)
                   for e in prof.events() if e.device_type == DeviceType.CUDA)
    if not spans:
        log("  profile: no device events recorded (device time not measured)")
        return
    busy_us, reach = 0.0, float("-inf")      # union of the device intervals
    by_name: dict = {}
    for start, end, name in spans:
        busy_us += max(0.0, end - max(start, reach))
        reach = max(reach, end)
        tot, cnt = by_name.get(name, (0.0, 0))
        by_name[name] = (tot + end - start, cnt + 1)
    busy = busy_us / 1e6
    log(f"  profile Q4.1/optimized: wall={wall:.4f}s device_busy={busy:.4f}s "
        f"idle_share={1.0 - busy / wall:.4f} device_events={len(spans)}")
    for name, (us, cnt) in sorted(by_name.items(), key=lambda kv: -kv[1][0]
                                  )[:12]:
        log(f"    {us / 1e3:10.3f} ms  x{cnt:<5d} {name[:100]}")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--profile", action="store_true",
                    help="after the main path, profile one more fused Q4.1 "
                         "run (device busy time by kernel, idle share)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.core import resolve_backend
    from repro_torch.etl.queries import build_q1, build_q4
    from repro_torch.etl.ssb import generate
    from repro_torch.kernels import _cuda

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
    bk = resolve_backend("torch")
    rng = np.random.default_rng(0)

    # ---- phase 2: kernels vs plain versions at the main path's shapes
    t0 = time.perf_counter()
    data = generate(**SF1)
    log(f"SSB SF1 generated in {time.perf_counter() - t0:.1f}s: lineorder "
        f"{len(data.lineorder['lo_orderkey'])}, customer "
        f"{len(data.customer['c_custkey'])}, supplier "
        f"{len(data.supplier['s_suppkey'])}, part "
        f"{len(data.part['p_partkey'])}, date {len(data.date['d_datekey'])}")
    log("kernels:")
    measured = {"hash_probe": phase_hash_probe(bk, data),
                "radix_groupby": phase_radix_groupby(rng),
                "segment_sum": phase_segment_sum(rng)}

    # ---- phase 3: the main path
    log("main path (SSB SF1, backend torch, fused, 8 splits):")
    t0 = time.perf_counter()
    expect = {"Q4.1": build_q4(data).oracle(data),
              "Q1.1": build_q1(data).oracle(data)}
    log(f"  oracles in {time.perf_counter() - t0:.1f}s")
    launches = run_main(data, expect)
    if args.profile:
        profile_q41(data)

    # ---- phase 4: result lines
    sources = {"hash_probe": ("src/repro_torch/csrc/hash_probe.cu",
                              "src/repro/kernels/hash_join/kernel.py:68"),
               "radix_groupby": ("src/repro_torch/csrc/radix_groupby.cu",
                                 "src/repro/kernels/radix_groupby/kernel.py:73"),
               "segment_sum": ("src/repro_torch/csrc/segment_sum.cu",
                               "src/repro/kernels/segment_sum/kernel.py:62")}
    kernels = []
    for name, (src, replaces) in sources.items():
        m = measured[name]
        kernels.append({"name": name, "route": "cuda", "source": src,
                        "replaces": replaces, "launches": launches[name],
                        "max_abs_err": m["max_abs_err"], "ms": m["ms"],
                        "plain_ms": m["plain_ms"], "bound_ms": m["bound_ms"],
                        "bound_by": m["bound_by"],
                        "library_ms": m["library_ms"]})
    print(json.dumps({"kernels": kernels}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
