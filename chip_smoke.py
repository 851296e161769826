"""Drive the PyTorch/CUDA port (``repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py                 # all phases
    python3 chip_smoke.py --profile       # all phases + profiled Q4.1 run,
                                          # served Q4.1 tick, LM prefill
                                          # and decode step, a train
                                          # step of each trained config

Phases (any failure raises and the script exits non-zero):

1. Setup: torch/CUDA versions, the card's name and power limit, and the
   build of every ``src/repro_torch/csrc/*.cu`` kernel (timed), with each
   flash, selective-scan (with and without carries), hash-probe and
   backward entry point's registers and spills as ``ptxas`` reports them.
2. Kernels: each hand-written kernel against its plain torch version on the
   card, at the shapes its main path gives it (SSB scale factor 1 for the
   ETL kernels; stablelm-3b and falcon-mamba-7b prefill for flash attention
   and the selective scan; flash on both of its routes, bf16 on the tensor
   cores and fp32 in FMAs, and in bf16 at mixtral-8x7b's and grok-1's
   prefill shapes, llama-3.2-vision-11b's cross-attention (2048 queries
   against 1601 vision tokens, non-causal) and hubert-xlarge's encoder
   (non-causal, hd 80) and the dense configs' prefills at hd 128
   (qwen2.5-32b's 8 kv heads at G 5, qwen2-72b's at G 8, granite-20b's
   one kv head at G 48) too, with their device times from CUDA events
   around 20 launches back to back; the scan on bf16 and fp32
   delta/x, with its lane splits timed) plus small cases for the options
   those paths do not use, twice (bit-identical), with its median time
   (CUDA events), its
   bound, the plain version's time and a PyTorch library call as a
   yardstick the port never calls.  For each grouped-sum case, the device
   kernels one call launches and their device time (``torch.profiler``);
   at the main paths' shapes a call may launch at most two.  The hash
   probe runs against all four Q4.1 dimensions on its packed table, with
   its device time taken after every other event time (a profiler session
   slows later launches on the host).  fp32 flash attention runs
   at every head dim.  The grouped sums also run at the sharded runs'
   shapes: a shard's Q4.1, Q1.1 and supplier partials and the mesh
   combiner's sums (the supplier's on the wide direct route, one launch),
   and on the partitioned route (two launches) beside ``index_add_``'s
   device time: 2^20 cells (4M rows; its device time printed against the
   targets PARTITIONED_TARGETS), SF1 lineorder by lo_partkey and by
   lo_custkey, the part-keyed combiner and the sort route's 4M keys.  The
   two backward kernels (training's gradients) at the trained models'
   microbatch shapes (flash: stablelm-3b's [2, 2048, 32, 80] bf16, causal,
   beside scaled_dot_product_attention's forward + backward, and the
   GQA microbatches of mixtral-8x7b, qwen2.5-32b (G 5) and granite-20b
   (MQA: 1 kv head, G 48, the dK/dV kernel's grid 32 blocks), and the
   non-causal ones: llama-3.2-vision-11b's cross-attention (2048 queries
   against 1601 vision tokens, G 4, hd 128: a last key tile of one key)
   and hubert-xlarge's encoder (4 x 2048, 16 heads of 80); the scan:
   falcon-mamba-7b's Bt 1, T 2048, d 8192, N 16 with bf16 delta/x, each of
   its four launches timed) and at the card tests' shapes, each against
   its plain version from the forward kernel's own output and log-sum-exp
   or carries, twice (bit-identical), with its median time, device time,
   bound and the plain version's time.
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
   Then the keyed Aggregates on the partitioned grouped sums, each twice
   and byte-identical, within FLOAT_RTOL of a float64 oracle: by
   lo_partkey (200,000 groups) serial on the optimized engine and over 4
   mesh shards (against the serial run), by lo_custkey (30,000) serial.
   Then kernel failures on SF1 Q4.1 (streaming, fused, 8 splits): the
   probe's CUDA entry raising once, the radix groupby's raising once, and a
   kernel library that cannot load; the card has no degradation ladder, so
   each run must abort with its error and record no step.  Every other run
   must record no degradation.
   Then served Q4.1: the declarative Q4.1 flow through ``Session.serve``,
   SF1's lineorder in 12 ticks and an empty one; the replayed deltas must
   equal a batch run of the flow, each tick must go through the probe (4 x
   chunks launches) and, with rows, the radix groupby; warm ticks must
   compile and upload nothing, and no tick may be retried or dead-lettered.
   Its launches are counted from 0 on their own and added to the kernels
   line's.  Then a keyed Aggregate with 40 sum outputs, more than one
   grouped-sum launch takes, on ``torch`` against ``torch_cpu``.
4. LM serving path, once each for stablelm-3b, falcon-mamba-7b,
   mixtral-8x7b and grok-1-314b at their full published widths
   (``configs/<arch>.CONFIG``, random weights from a seed); the two moe
   models, which do not fit the card whole, at 8 of 32 and 4 of 64 layers.
   ``BatchedServer`` serves 8 requests (waves of 4, prompts of 2048 tokens
   from numpy seed 0, 32 new tokens, greedy) twice, with the counters set
   to 0 just before and read just after.  Each prefill must launch its
   kernel once per layer and the second run must give the same tokens.
   Against the fp32 plain route's prefill logits, the fp32 kernel route
   must agree within F32_LOGITS_ATOL and the bf16 kernel route must be no
   further off than the bf16 plain route allows (BF16_MARGIN); in fp32,
   prefill + 4 decode steps must agree with a longer prefill, for mixtral
   also at one prompt past its 4096-token window (4196 + 4 against 4200),
   with the largest expert load of each MoE prefill against its capacity.
   Then llama-3.2-vision-11b and hubert-xlarge whole (40 and 48 layers),
   fp32 params.  The vlm's cross-attention gates are set nonzero from
   GATE_SEED (zero, they would hide the branch from every check); it
   serves the same traffic through ``generate(..., vision=...)`` with
   random patch embeddings [4, 1601, 4096] a wave, twice (tokens
   identical, 40 + 8 flash launches a prefill), then the same route check
   and fp32 teacher forcing with vision (decode over the cached vision
   K/V against flash's cross-attention).  hubert encodes 8 clips of 2048
   stub frames in waves of 4 through ``forward_prefill``, twice (logits
   bit-identical, 48 flash launches a wave); its route check compares the
   hidden state at every position.  Then the dense configs no earlier
   phase runs, as stablelm-3b is served, at full width and cut in depth
   (DENSE_SERVE): qwen2.5-32b (QKV bias, G 5; its plain route attends in
   query chunks of 1024) at 16 of 64 layers, qwen2-72b (QKV bias, G 8, a
   152,064-token vocabulary) at 8 of 80 and granite-20b (MQA, a gelu
   MLP) at 20 of 52, each route check at 2 layers.
5. LM training path.  Gradient route checks at full width and 2 layers
   of stablelm-3b and falcon-mamba-7b: one microbatch through
   ``forward_train`` and its backward on the kernel route (the kernels'
   autograd Functions: the forward kernels, then the backward kernels) and
   the plain route in bf16, against the fp32 plain route:
   loss, global and per-leaf gradient norms within phase 4's BF16_MARGIN
   rule.  Then stablelm-3b whole (2.795e9 parameters, fp32 params, grads
   and AdamW moments: 41.7 GiB) and falcon-mamba-7b at 8 of 64 layers
   through ``launch.train.train_loop``, twice from seed 0: finite losses,
   step 0 within 10% of ln(vocab) of the initialised model's expected
   loss (``initial_loss``), the forward kernel launched twice a call a
   microbatch (forward and remat recompute) and the backward kernel
   once, a call being a layer's and, for the vlm, a cross-attention
   layer's second one (``forward_calls``), the second run's losses within
   RERUN_RTOL (and whether they are bit-identical); step ms, tokens/s,
   6·N·tokens / step time against the bf16 peak, peak memory, a
   microbatch's forward/backward split and, at each of a microbatch's
   flash shapes (the model's own causality; the vlm's cross-attention
   too), the forward kernel, the backward kernel through the Function
   and the plain backward.  Then TRAIN's other configs, each at full
   width, its route check at the smallest depth its period allows (2
   layers; the vlm 5, one cross-attention layer, with its gates set from
   GATE_SEED as phase 4 sets them and every ``xattn`` leaf's fp32 and
   kernel-route gradient norm above zero: at zero gates the per-leaf rule
   would compare zeros) (grok-1 and mixtral with their largest expert
   loads against the capacity) and the same two ``train_loop`` runs of 2
   steps: qwen2.5-32b, qwen2-72b with its bf16 accumulator, granite-20b,
   mixtral-8x7b, grok-1-314b with bf16 parameters and AdamW moments,
   llama-3.2-vision-11b at 10 of 40 layers (8 x 2048 tokens and a vision
   input [1601, 4096] a sequence; ``train_loop`` keeps the zero gates of
   the initialised model, so its cross-attention backward runs on a
   gradient of about zero at step 0) and hubert-xlarge whole (16 x 2048
   stub frames, the loss over ``labels`` at every position, non-causal);
   grok-1's run once more on the plain attention route
   (``plain_witness``): its losses, step 1's after the first bf16 AdamW
   update included, within BF16_MARGIN of the kernel route's.
   qwen2-72b at ACCUM_DEPTH layers with its bf16 accumulator against an
   fp32 one from the same seed: the losses' gap, logged.  Then resume at
   the stablelm smoke config: 2 steps, a checkpoint, 2 resumed steps
   equal to 4 straight ones.  ``--profile``: one train step of each
   trained config under the profiler.
6. LM sharded path (``train/sharding.py``, DTensor over a ``DeviceMesh``):
   a world of one ``nccl`` rank and a 1x1 mesh with the real
   ``make_rules``.  stablelm-3b whole, two steps of phase 5's batch (8 x
   2048 in 4 microbatches, seed 0) through ``sharded_train_step`` against
   two of the unsharded ``make_train_step`` from the same seed: losses and
   global grad norms within SHARD_RTOL (bit-identity reported), step ms of
   both, flash launched twice a layer a microbatch and its backward once.
   Then a 4 x 2048
   prefill (``prefill`` profile) and 4 decode steps (``decode`` profile)
   through ``sharded_serve_steps`` against the unsharded serve steps on
   the same weights, logits within SHARD_RTOL.  The flash launches are
   counted from 0 just before and added to the kernels line's.  Four ranks
   on the one card are not run: gloo's collectives on CUDA tensors do not
   carry DTensor there (PERF.md).
7. LM dry run (``launch/dryrun.py``: a step traced on meta tensors, its
   FLOPs, HBM bytes, collectives and live bytes counted op by op and
   priced at the H100's data-sheet figures).  (a) Phase 5's stablelm-3b
   step traced at a world of one, then run on the card under
   ``FlopCounterMode``: params and opt state bytes equal, the traced peak
   within DRYRUN_PEAK_RANGE of the card's, FLOPs within
   DRYRUN_FLOPS_RTOL; its flash launches (forward and backward) are
   counted from 0 just before and added to the kernels line's.  (b) stablelm-3b ``train_4k`` at
   16x16, mixtral-8x7b ``decode_32k`` at 2x16x16 and falcon-mamba-7b
   ``prefill_32k`` at 16x16, each traced on the fake process group in a
   process of its own, started before (a): one line a cell (trace
   seconds, a device's argument and peak bytes, FLOPs, HBM and wire bytes
   by kind, the three roofline terms, the bottleneck, the useful and
   roofline fractions).
8. The port's examples (``examples/torch_*.py``), through the functions
   their ``main``s call, with the launch counters set to 0 just before:
   ``torch_etl_ssb`` over phase 3's SF1 data, every flow of ``BUILDERS``
   (Q1.1, Q2.1, Q3.1, Q4.1, Q4.1s) on the four engines (8 splits), each
   sink against its oracle (computed once a flow), no degradation, each
   run's grouped sums on EXAMPLE_ROUTES (Q3.1's Aggregate on the wide
   route), walls, rows/s and copies; ``torch_quickstart`` at SF1 (Theorem
   1's plan from the card's activity times, the walls at its degree and
   at 8 splits); ``torch_declarative_q41`` (streaming, optimize 2,
   fused); ``torch_serve_lm`` at mixtral-8x7b's full width and
   EXAMPLE_SERVE_LAYERS of 32 layers (8 requests, a flash launch a layer
   a wave); ``torch_train_lm``'s ~100M model (8 heads of 64), 200 steps
   with the restart at 100, the loss falling by more than 0.5 (a forward
   launch, a remat one and a backward launch a layer a microbatch).  Its
   launches are added to the kernels line's.
9. The ``kernels`` JSON line, the card line and, last,
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


def back_to_back_ms(fn, n: int = 20) -> float:
    """Device time a call of ``fn``, from CUDA events around ``n`` calls
    launched back to back: the launches queue up on the device, so the
    host's share of a call is hidden (no profiler session, which would
    slow every later launch on the host)."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / n


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
    dtype, state bucket, lanes a channel, whether it saves carries for
    training); none may spill (the wrapper picks the lanes from the shape,
    so every instance is on some path)."""
    rows = []
    for name, (regs, spills) in ptxas_entries(build_log).items():
        m = re.search(r"mamba_scan_kernelI([ft])Li(\d+)ELi(\d+)ELb([01])E",
                      name)
        if m:
            rows.append(("bf16" if m.group(1) == "t" else "fp32",
                         int(m.group(2)), int(m.group(3)),
                         " with carries" if m.group(4) == "1" else "", regs,
                         spills))
    if not rows:
        log("  scan ptxas: no report (the library was already built)")
        return
    for dtype, ns, lanes, carries, regs, spills in sorted(rows):
        log(f"  scan ptxas: {dtype} N<={ns} lanes {lanes}{carries}: {regs} "
            f"registers a thread, {spills} bytes of spills")
        if spills:
            raise AssertionError(f"mamba_scan {dtype} N<={ns} lanes {lanes}"
                                 f"{carries} spills {spills} bytes")


def backward_ptxas(build_log: str) -> None:
    """Print each backward kernel's registers and spills (flash: the bf16
    wgmma (hd 64 to 128), bf16 mma.sync (hd 8, 16, 32, 256) and fp32 dK/dV
    and dQ kernels by head dim; the scan: its local sweep and its walk by
    dtype and state bucket); neither a bf16 wgmma flash kernel (every
    full-size model's head dim, with and without a softcap) nor any scan
    instance (each bucket is on some model's path) may spill.  A wgmma kernel's
    count is its registers at entry: setmaxnreg then gives its consumer
    warpgroups up to 224."""
    rows = []
    route = {"wgmma": "bf16 wgmma", "kernel": "bf16 mma.sync",
             "f32": "fp32"}
    for name, (regs, spills) in ptxas_entries(build_log).items():
        m = re.search(r"flash_bwd_(dkdv|dq)_(kernel|f32|wgmma)ILi(\d+)E"
                      r"(Lb([01])E)?", name)
        if m:
            cap = {"1": " softcap", "0": " no softcap"}.get(m.group(5), "")
            rows.append((f"flash {m.group(1)} {route[m.group(2)]}",
                         f"hd {m.group(3)}{cap}", regs, spills,
                         m.group(2) == "wgmma"))
        m = re.search(r"mamba_scan_bwd_(walk|local)I([ft])Li(\d+)E", name)
        if m:
            rows.append((f"scan {m.group(1)} "
                         f"{'bf16' if m.group(2) == 't' else 'fp32'}",
                         f"N<={m.group(3)}", regs, spills, True))
    if not rows:
        log("  backward ptxas: no report (the library was already built)")
        return
    for kind, shape, regs, spills, strict in sorted(rows):
        log(f"  backward ptxas: {kind} {shape}: {regs} registers a thread, "
            f"{spills} bytes of spills")
        if strict and spills:
            raise AssertionError(f"{kind} {shape} spills {spills} bytes")


def grouped_ptxas(build_log: str) -> None:
    """Print each grouped-sum instance's registers and spills: the direct
    route's (value columns kept in registers, 32-row batches loaded at a
    time, blocks an SM it is bounded for: the narrow one and the two wide
    ones) and the partitioned route's partition and accumulate kernels (few
    columns, up to 32), in each of the two sources; none may spill."""
    rows = set()
    for name, (regs, spills) in ptxas_entries(build_log).items():
        m = re.search(r"gs_(direct|partition|accumulate)ILi(\d+)ELi(\d+)"
                      r"ELi(\d+)E", name)
        if m:
            rows.add((m.group(1), int(m.group(2)), int(m.group(3)),
                      int(m.group(4)), regs, spills))
    if not rows:
        log("  grouped-sum ptxas: no report (the library was already built)")
        return
    for kind, cols, batches, blocks, regs, spills in sorted(rows):
        log(f"  grouped-sum ptxas: {kind}, {cols} columns, {batches} "
            f"batches in flight, {blocks} block(s) an SM: {regs} registers "
            f"a thread, {spills} bytes of spills")
        if spills:
            raise AssertionError(f"gs_{kind}<{cols}, {batches}, {blocks}> "
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
    from repro_torch.kernels._grouped_sum import is_direct, is_wide
    direct = is_direct(n_groups, c, with_counts)
    route = ("wide" if is_wide(n_groups, c, with_counts) else "narrow"
             if direct else "partitioned")
    fmt = lambda v: f"{v:.4f}" if v is not None else "not measured"
    # the library call's device time beside the kernel's where the
    # partitioned route's six launches meet one index_add_
    library_device_ms = (call_kernels(library)[1] if not direct else None)
    by_pass = (device_split_ms(lambda: kernel(ids, vals, n_groups),
                               PARTITIONED_KERNELS, calls=5)
               if not direct else None)
    lib_dev = (f" library_device_ms={fmt(library_device_ms)} "
               f"device_ms_by_pass=" + (",".join(
                   f"{k}:{v:.4f}" for k, v in by_pass.items())
                   if by_pass else "not measured")
               if not direct else "")
    log(f"  {label}: rows={n} C={c} groups={n_groups} route={route} "
        f"{'exact' if exact else 'order-bound'} max_abs_err={err:.6g} "
        f"max_rel_err={rel:.3g} err_vs_f64={err64:.3g} ms={ms:.4f} "
        f"plain_ms={plain_ms:.4f} slower_than_plain={ms > plain_ms} "
        f"library_ms={library_ms:.4f} faster_than_library="
        f"{ms < library_ms} bound_ms={b:.4f} ({by}) "
        f"bit_stable=True kernels_a_call="
        f"{n_kernels if n_kernels is not None else 'not measured'} "
        f"device_ms_a_call={fmt(device_ms)}{lib_dev}")
    return dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms, bound_ms=b,
                bound_by=by, max_abs_err=err, kernels_a_call=n_kernels,
                device_ms=device_ms, library_device_ms=library_device_ms,
                device_ms_by_pass=by_pass, direct=direct, route=route)


#: the partitioned route's two launches (csrc/grouped_sum.cuh)
PARTITIONED_KERNELS = (("gs_partition", "partition"),
                       ("gs_accumulate", "accumulate"))


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
    """A grouped sum at a main-path, sharded or keyed shape runs at most two
    kernels a call, on every route (the direct routes, narrow and wide,
    launch one, the partitioned route two; the supplier shard and combiner
    take the wide one)."""
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
    shard = _grouped_case(
        "radix_groupby[supplier_shard]", ids, v, cells, kernel,
        radix_groupby_ref, _index_add_yardstick(ids, v, cells, True),
        with_counts=True, exact=False)
    check_main_launches("radix_groupby[supplier_shard]", shard)
    # the same ids with small integer values: sums and counts exact
    v = torch.from_numpy(rng.integers(0, 8, (n, 1)).astype(np.float32)
                         ).to(dev)
    check_main_launches("radix_groupby[supplier_shard_int]", _grouped_case(
        "radix_groupby[supplier_shard_int]", ids, v, cells, kernel,
        radix_groupby_ref, _index_add_yardstick(ids, v, cells, True),
        with_counts=True, exact=True))
    # many partitions: 2^20 cells, 4M rows, ~2% padding rows
    n, cells = 4 << 20, 1 << 20
    big = rng.integers(0, cells, n).astype(np.int32)
    big[rng.random(n) < 0.02] = -1
    ids = torch.from_numpy(big).to(dev)
    extra = {"supplier_shard": shard}
    for label, vals, exact in (
            ("2^20cells_int", rng.integers(0, 8, (n, 1)), True),
            ("2^20cells_float", rng.random((n, 2)), False)):
        v = torch.from_numpy(vals.astype(np.float32)).to(dev)
        extra[label] = _grouped_case(
            f"radix_groupby[{label}]", ids, v, cells, kernel,
            radix_groupby_ref, _index_add_yardstick(ids, v, cells, True),
            with_counts=True, exact=exact)
        check_main_launches(f"radix_groupby[{label}]", extra[label])
    partitioned_targets(extra)
    # the partitioned route on the ETL path: SF1 lineorder (6M rows)
    # aggregated by lo_partkey (200,000 ids: 196 partitions) and by
    # lo_custkey (30,000 ids: 235 partitions), each in 2 slices, revenue
    # sums and counts; then small integers on the same ids (exact)
    n = SF1["lineorder_rows"]
    revenue = (rng.integers(90_000, 1_100_000, n)
               * (100 - rng.integers(0, 11, n)) // 100).astype(np.float32)
    for label, groups in (("part_keyed", SF1["parts"]),
                          ("customer_keyed", SF1["customers"])):
        ids = torch.from_numpy(rng.integers(0, groups, n).astype(np.int32)
                               ).to(dev)
        for case, vals, exact in (
                (label, revenue[:, None], False),
                (f"{label}_int", rng.integers(0, 8, (n, 1)), True)):
            v = torch.from_numpy(vals.astype(np.float32)).to(dev)
            extra[case] = _grouped_case(
                f"radix_groupby[{case}]", ids, v, groups, kernel,
                radix_groupby_ref, _index_add_yardstick(ids, v, groups, True),
                with_counts=True, exact=exact)
            check_main_launches(f"radix_groupby[{case}]", extra[case])
        del ids
    return dict(results["q41_profit"], **{
        k: _case_summary(m) for k, m in extra.items()
        if not k.endswith("_int") or k.startswith("2^20")})


#: the partitioned route's device time at 2^20 cells a call at most, C 1
#: and C 2: a quarter of the six-launch route's (0.9364 / 0.9958 ms on an
#: NVIDIA H100 80GB HBM3 at 700 W, PERF.md)
PARTITIONED_TARGETS = {"2^20cells_int": 0.234, "2^20cells_float": 0.249}


def partitioned_targets(cases: dict) -> None:
    """Print the 2^20-cell cases' device time against the targets and
    against ``index_add_``'s device time in the same run."""
    for label, target in PARTITIONED_TARGETS.items():
        m = cases[label]
        dev_ms, lib = m["device_ms"], m["library_device_ms"]
        log(f"  radix_groupby[{label}] partitioned route: kernels_a_call="
            f"{m['kernels_a_call']} device_ms={dev_ms} target_ms={target} "
            f"target_met={dev_ms is not None and dev_ms <= target} "
            f"library_device_ms={lib} at_or_below_library="
            f"{None if dev_ms is None or lib is None else dev_ms <= lib}")


def _case_summary(m: dict) -> dict:
    """A grouped-sum case's numbers for the kernels line."""
    return {k: m[k] for k in ("route", "ms", "device_ms", "kernels_a_call",
                              "device_ms_by_pass", "plain_ms", "library_ms",
                              "library_device_ms", "bound_ms", "bound_by",
                              "max_abs_err")}


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
    extra = {}
    for label, comb, hi in (
            ("q41_combiner", np.tile(np.arange(35), 4), 1 << 30),
            ("supplier_combiner", rng.permutation(2_000), 1 << 30),
            ("supplier_combiner_int", rng.permutation(2_000), 1 << 20)):
        g = int(comb.max()) + 1
        cids = torch.from_numpy(comb.astype(np.int32)).to(dev)
        v = torch.from_numpy(rng.integers(30_000, hi, (len(comb), 1))
                             .astype(np.float32)).to(dev)
        extra[label] = _grouped_case(
            f"segment_sum[{label}]", cids, v, g, kernel, segment_sum_ref,
            _index_add_yardstick(cids, v, g, False), with_counts=False,
            exact=label.endswith("_int"))
        check_main_launches(f"segment_sum[{label}]", extra[label])
    n, groups = 1 << 20, 4096
    ids = torch.from_numpy(rng.integers(0, groups, n).astype(np.int32)).to(dev)
    v = torch.from_numpy(rng.integers(0, 16, (n, 1)).astype(np.float32)).to(dev)
    _grouped_case("segment_sum[G=4096_int]", ids, v, groups, kernel,
                  segment_sum_ref, _index_add_yardstick(ids, v, groups, False),
                  with_counts=False, exact=True)
    # the partitioned route: the mesh combiner of the part-keyed Aggregate
    # over 4 shards (each key's partial from one shard: 200,000 rows over
    # 200,000 ids, in shard order), and the sort route's segment sum over
    # 4M distinct keys (4M rows over 4M ascending ids: 977 partitions of
    # 4,096 ids)
    n = SF1["parts"]
    comb = torch.from_numpy(rng.permutation(n).astype(np.int32)).to(dev)
    asc = torch.arange(4_000_000, dtype=torch.int32, device=dev)
    for label, ids, hi, exact in (
            ("part_combiner", comb, 1 << 30, False),
            ("part_combiner_int", comb, 1 << 10, True),
            ("sort_4m", asc, 1 << 30, False),
            ("sort_4m_int", asc, 1 << 10, True)):
        g = ids.shape[0]
        v = torch.from_numpy(rng.integers(0, hi, (g, 1)).astype(np.float32)
                             ).to(dev)
        extra[label] = _grouped_case(
            f"segment_sum[{label}]", ids, v, g, kernel, segment_sum_ref,
            _index_add_yardstick(ids, v, g, False), with_counts=False,
            exact=exact)
        if label.startswith("part_combiner"):
            check_main_launches(f"segment_sum[{label}]", extra[label])
    return dict(results["q11_revenue"], **{
        k: _case_summary(extra[k])
        for k in ("supplier_combiner", "part_combiner", "sort_4m")})


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


def _check_close(label, got, want, tol) -> float:
    rtol, atol = tol
    err = float((got.float() - want.float()).abs().max()) if got.numel() \
        else 0.0
    if not torch.allclose(got.float(), want.float(), rtol=rtol, atol=atol):
        raise AssertionError(f"{label}: max_abs_err {err:.3g} beyond rtol "
                             f"{rtol} atol {atol} of the plain version")
    return err


def _flash_case(label, gen, B, Sq, Skv, Kh, G, hd, causal, window, softcap,
                dtype, library: bool, device: bool = False,
                dispatch: bool = False) -> dict:
    """``dispatch``: also time the launch itself (``flash_attention_cuda``)
    against the wrapper's route through the registered op, in turns
    (direct, op, op, direct)."""
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_ref)
    from repro_torch.kernels.flash_attention.ops import (allowed_pairs,
                                                         flash_attention_cuda)

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
    device_ms = (back_to_back_ms(lambda: flash_attention(
        q, k, v, impl="cuda", **kw)) if device else None)
    turns = ""
    if dispatch:
        direct = lambda: flash_attention_cuda(q, k, v, **kw)
        via_op = lambda: flash_attention(q, k, v, impl="cuda", **kw)
        t = [time_ms(f) for f in (direct, via_op, via_op, direct)]
        turns = (f" direct_ms={t[0]:.4f},{t[3]:.4f} "
                 f"op_ms={t[1]:.4f},{t[2]:.4f}")
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
        f"tol={tol} ms={ms:.4f}"
        f"{f' device_ms={device_ms:.4f}' if device else ''}{turns} "
        f"plain_ms={plain_ms:.4f} library_ms={lib} bound_ms={bnd:.4f} ({by}) "
        f"tflops={flops / ms / 1e9:.2f} share_of_bound={bnd / ms:.4f} "
        f"bit_stable=True")
    out = dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms,
               bound_ms=bnd, bound_by=by, max_abs_err=err)
    if device:
        out["device_ms"] = device_ms
    return out


def phase_flash_attention(gen) -> dict:
    """Both flash kernels at the stablelm-3b prefill shape (4 prompts of
    2048 tokens, 32 heads (MHA), hd 80, causal), each beside
    scaled_dot_product_attention in its dtype; the kernels line's flash row
    is the bf16 tensor-core kernel the served model runs, with the fp32 FMA
    kernel's numbers in fields of their own."""
    bf16, f32 = torch.bfloat16, torch.float32
    shape = (4, 2048, 2048, 32, 1, 80, True, 0, 0.0)
    main = _flash_case("stablelm-3b prefill, bf16 tensor cores", gen, *shape,
                       bf16, library=True, dispatch=True)
    fp32 = _flash_case("stablelm-3b prefill, fp32 FMA", gen, *shape, f32,
                       library=True)
    main.update({f"fp32_{k}": fp32[k] for k in ("ms", "plain_ms",
                                                "library_ms", "bound_ms",
                                                "max_abs_err")})
    # the moe models' prefill shapes (4 prompts of 2048 tokens, 8 kv heads
    # of 128): mixtral-8x7b, G 4 under its 4096 window (the window holds
    # every causal pair at 2048); grok-1, G 6 with softcap 30, which
    # scaled_dot_product_attention does not take
    main["mixtral_prefill"] = _flash_case(
        "mixtral-8x7b prefill, bf16 tensor cores", gen, 4, 2048, 2048, 8, 4,
        128, True, 4096, 0.0, bf16, library=True, device=True)
    main["grok_prefill"] = _flash_case(
        "grok-1-314b prefill, bf16 tensor cores", gen, 4, 2048, 2048, 8, 6,
        128, True, 0, 30.0, bf16, library=False, device=True)
    # llama-3.2-vision-11b's cross-attention (non-causal, 2048 queries
    # against 1601 vision tokens = 25 x 64 + 1: the last kv tile holds one
    # key) and hubert-xlarge's encoder (non-causal, 16 heads of 80)
    main["vlm_cross_prefill"] = _flash_case(
        "llama-3.2-vision-11b cross-attention, bf16 tensor cores", gen, 4,
        2048, 1601, 8, 4, 128, False, 0, 0.0, bf16, library=True,
        device=True)
    main["hubert_prefill"] = _flash_case(
        "hubert-xlarge encoder, bf16 tensor cores", gen, 4, 2048, 2048, 16,
        1, 80, False, 0, 0.0, bf16, library=True, device=True)
    # the dense configs served in phase 4 at hd 128: qwen2.5-32b (8 kv
    # heads, G 5), qwen2-72b (8 kv heads, G 8) and granite-20b (MQA: 1 kv
    # head, G 48; the grid folds (b, kh, g), so 4 x 48 rows of query tiles
    # still fill the card)
    for key, arch, kh, G in (("qwen25_prefill", "qwen2.5-32b", 8, 5),
                             ("qwen2_prefill", "qwen2-72b", 8, 8),
                             ("granite_prefill", "granite-20b", 1, 48)):
        main[key] = _flash_case(
            f"{arch} prefill (Kh {kh}, G {G}), bf16 tensor cores", gen, 4,
            2048, 2048, kh, G, 128, True, 0, 0.0, bf16, library=True,
            device=True)
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
               dtype=torch.float32, device: bool = False) -> dict:
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
    device_ms = (back_to_back_ms(lambda: mamba_scan(*args, impl="cuda"))
                 if device else None)
    plain_ms = time_ms(lambda: mamba_scan_ref(*args), iters=3, warmup=1)
    # bytes at the dtypes passed (inputs read once, y and hT written once)
    # against one exp2 a (b, t, c, n)
    nbytes = sum(t.numel() * t.element_size() for t in args) + 4 * (
        y.numel() + hT.numel())
    bnd, by = bound_ms(nbytes, Bt * T * d * N, PEAK_EX2_S)
    log(f"  mamba_scan[{label}]: Bt={Bt} T={T} d={d} N={N} "
        f"{str(dtype).split('.')[-1]} max_abs_err={err:.3g} tol={SCAN_TOL} "
        f"ms={ms:.4f}{f' device_ms={device_ms:.4f}' if device else ''} "
        f"plain_ms={plain_ms:.4f} library_ms=none "
        f"bound_ms={bnd:.4f} ({by}) GB/s={nbytes / ms / 1e6:.1f} "
        f"share_of_bound={bnd / ms:.4f} bit_stable=True"
        + (" same_as_widened=True" if dtype == torch.bfloat16 else ""))
    out = dict(ms=ms, plain_ms=plain_ms, library_ms=None, bound_ms=bnd,
               bound_by=by, max_abs_err=err)
    if device:
        out["device_ms"] = device_ms
    return out


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
                      zero_h0=True, dtype=bf16, device=True)
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
#  Phase 2, the backward kernels
# ---------------------------------------------------------------------------
#: fp32 flash backward: fp32 sums in other orders (the card tests'); bf16
#: takes FLASH_TOL_BF16 (P and dS rounded to bf16 for the tensor cores,
#: each gradient rounded to bf16)
FLASH_BWD_TOL_F32 = (1e-4, 1e-5)
#: the bf16 flash backward is also held by relative norm: on every tile of
#: 64 rows along the sequence (keys for dK and dV, queries for dQ),
#: ||got - want|| / ||want|| within this.  Most dK and dV elements at S
#: 2048 are far below FLASH_TOL_BF16's atol, so the elementwise check
#: alone would pass a kernel that dropped query tiles for late keys
FLASH_BWD_REL_BF16 = 1e-2
#: the scan's gradients whose elements sum many products (dB and dC over
#: the d channels, dA over Bt * T steps) are held within SCAN_TOL's rtol
#: plus its atol times the gradient's largest value: either side's fp32
#: rounding scales with the products, not with the sum
SCAN_LONG_SUMS = ("B", "C", "A")


def rel_gaps(got, want, tile: int = 64) -> tuple:
    """(||got - want|| / ||want|| over the whole tensor, the largest of it
    over tiles of ``tile`` rows along dim 1).  A tile where ``want`` is
    all zero counts 0 if ``got`` is too, else inf."""
    diff = (got.double() - want.double()).square().transpose(0, 1)
    ref = want.double().square().transpose(0, 1)
    n = diff.shape[0]
    dsq, wsq = (torch.nn.functional.pad(t.reshape(n, -1).sum(1),
                                        (0, -n % tile)).view(-1, tile).sum(1)
                for t in (diff, ref))
    tiles = torch.where(wsq > 0, (dsq / wsq.clamp_min(1e-300)).sqrt(),
                        torch.where(dsq > 0, float("inf"), 0.0))
    whole = float((dsq.sum() / wsq.sum()).sqrt()) if float(wsq.sum()) > 0 \
        else (0.0 if float(dsq.sum()) == 0 else float("inf"))
    return whole, float(tiles.max()) if tiles.numel() else 0.0


def _flash_bwd_case(label, gen, B, Sq, Skv, Kh, G, hd, causal, window,
                    softcap, dtype, library: bool = False,
                    device: bool = False) -> dict:
    """The backward kernel on the forward kernel's own output and
    log-sum-exp, against ``flash_attention_backward_ref`` on the same."""
    from repro_torch.kernels.flash_attention import (
        flash_attention_backward_ref)
    from repro_torch.kernels.flash_attention.ops import (
        allowed_pairs, flash_attention_backward_cuda, flash_attention_cuda)

    def rand(*shape):
        return torch.randn(shape, generator=gen, device=gen.device).to(dtype)
    q, k, v = rand(B, Sq, Kh, G, hd), rand(B, Skv, Kh, hd), rand(B, Skv, Kh,
                                                                 hd)
    dout = rand(B, Sq, Kh, G, hd)
    kw = dict(causal=causal, window=window, softcap=softcap)
    out, lse = flash_attention_cuda(q, k, v, return_lse=True, **kw)
    bwd = lambda: flash_attention_backward_cuda(q, k, v, out, lse, dout,
                                                **kw)
    a, b = bwd(), bwd()
    r = flash_attention_backward_ref(q, k, v, out, lse, dout, **kw)
    torch.cuda.synchronize()
    if not all(same(x, y) for x, y in zip(a, b)):
        raise AssertionError(f"flash_attention_backward[{label}]: two "
                             f"launches differ")
    bf16 = dtype == torch.bfloat16
    tol = FLASH_TOL_BF16 if bf16 else FLASH_BWD_TOL_F32
    err, rel = 0.0, {}
    for n, x, y in zip("qkv", a, r):
        err = max(err, _check_close(f"flash_attention_backward[{label}] "
                                    f"d{n}", x, y, tol))
        rel[n] = rel_gaps(x, y)
        if bf16 and rel[n][1] > FLASH_BWD_REL_BF16:
            raise AssertionError(
                f"flash_attention_backward[{label}] d{n}: relative norm "
                f"{rel[n][0]:.3g} (worst 64-row tile {rel[n][1]:.3g}) beyond "
                f"{FLASH_BWD_REL_BF16} of the plain version")
    del a, b, r
    ms = time_ms(bwd)
    device_ms = back_to_back_ms(bwd) if device else None
    plain_ms = time_ms(lambda: flash_attention_backward_ref(
        q, k, v, out, lse, dout, **kw), iters=5)
    library_ms = library_device_ms = fwd_bwd_ms = library_fwd_bwd_ms = None
    if library:
        import torch.nn.functional as F
        qt = q.reshape(B, Sq, Kh * G, hd).transpose(1, 2).contiguous()
        kt, vt = (t.transpose(1, 2).contiguous() for t in (k, v))
        go = dout.reshape(B, Sq, Kh * G, hd).transpose(1, 2).contiguous()
        leaves = [t.requires_grad_(True) for t in (qt, kt, vt)]
        sdpa = lambda: F.scaled_dot_product_attention(
            *leaves, is_causal=causal, enable_gqa=G > 1)
        # its backward alone, on a graph built outside the timed call, as
        # the kernel's ms is its backward alone
        graph = sdpa()
        sdpa_bwd = lambda: torch.autograd.grad(graph, leaves, go,
                                               retain_graph=True)
        library_ms = time_ms(sdpa_bwd)
        library_device_ms = back_to_back_ms(sdpa_bwd) if device else None
        del graph, sdpa_bwd
        library_fwd_bwd_ms = time_ms(lambda: torch.autograd.grad(
            sdpa(), leaves, go))
        fwd_bwd_ms = time_ms(lambda: flash_attention_backward_cuda(
            q, k, v, *flash_attention_cuda(q, k, v, return_lse=True, **kw),
            dout, **kw))
    split = (device_split_ms(bwd, FLASH_BWD_KERNELS) if device and bf16
             else None)
    pairs = allowed_pairs(Sq, Skv, causal, window)
    rows = B * Kh * G
    # the gradient's products: S, dP, dV, dK, dQ (10·hd a pair) and D
    # (2·hd a row); the kernels rebuild S and dP in both the dK/dV and the
    # dQ kernel (14·hd a pair), which kernel_ops_ms prices
    flops = rows * hd * (10 * pairs + 2 * Sq)
    kernel_flops = rows * hd * (14 * pairs + 2 * Sq)
    nbytes = (3 * q.numel() + 2 * k.numel() + 2 * v.numel() + out.numel()
              ) * q.element_size() + 4 * lse.numel()
    peak = PEAK_BF16_S if bf16 else PEAK_OPS_S
    bnd, by = bound_ms(nbytes, flops, peak)
    kernel_ops_ms = kernel_flops / peak * 1e3
    lib = f"{library_ms:.4f}" if library_ms is not None else "none"
    both = ""
    if library_device_ms is not None:
        both += f" library_device_ms={library_device_ms:.4f}"
    if device and bf16:
        both += (" device_ms_by_kernel=" + (",".join(
            f"{k}:{v:.4f}" for k, v in split.items()) if split
            else "not measured"))
    if library:
        both += (f" fwd_bwd_ms={fwd_bwd_ms:.4f} library_fwd_bwd_ms="
                 f"{library_fwd_bwd_ms:.4f}")
    log(f"  flash_attention_backward[{label}]: B={B} Sq={Sq} Skv={Skv} "
        f"Kh={Kh} G={G} hd={hd} causal={causal} window={window} "
        f"softcap={softcap} {str(dtype).split('.')[-1]} pairs={pairs} "
        f"max_abs_err={err:.3g} tol={tol} rel_norm="
        + ",".join(f"d{n}:{w:.3g}/{t:.3g}" for n, (w, t) in rel.items())
        + f" (whole/worst 64-row tile; limit "
        f"{FLASH_BWD_REL_BF16 if bf16 else 'none'}) ms={ms:.4f}"
        f"{f' device_ms={device_ms:.4f}' if device else ''} "
        f"plain_ms={plain_ms:.4f} library_ms={lib} (sdpa backward)"
        f"{both} bound_ms={bnd:.4f} ({by}; 10·hd a pair) "
        f"kernel_ops_ms={kernel_ops_ms:.4f} (14·hd a pair) "
        f"tflops={flops / ms / 1e9:.2f} share_of_bound={bnd / ms:.4f} "
        f"bit_stable=True")
    res = dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms,
               bound_ms=bnd, bound_by=by, max_abs_err=err,
               kernel_ops_ms=kernel_ops_ms,
               rel_norm={f"d{n}": list(v) for n, v in rel.items()})
    if device:
        res["device_ms"] = device_ms
        if bf16:
            res["device_ms_by_kernel"] = split
    if library:
        res.update(fwd_bwd_ms=fwd_bwd_ms,
                   library_fwd_bwd_ms=library_fwd_bwd_ms)
        if device:
            res["library_device_ms"] = library_device_ms
    return res


def device_split_ms(fn, tags, calls: int = 10, attempts: int = 3):
    """Device ms a call of each kernel of ``fn`` over ``calls`` calls under
    ``torch.profiler``: ``tags`` pairs a substring of a kernel's name with
    its key (the flash backward's ``FLASH_BWD_KERNELS``, the scan
    backward's ``SCAN_BWD_KERNELS``); None when ``attempts`` sessions miss
    one (not measured).  Taken after a case's event times: a profiler
    session slows later launches on the host."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for _ in range(attempts):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        split: dict = {}
        for e in prof.events():
            if e.device_type != DeviceType.CUDA:
                continue
            for tag, key in tags:
                if tag in e.name:
                    t = e.time_range
                    split[key] = split.get(key, 0.0) + (t.end - t.start) / 1e3
        if len(split) == len(tags):
            return {key: split[key] / calls for _, key in tags}
    return None


#: the flash backward's kernels: the row dot products, dK/dV, dQ
FLASH_BWD_KERNELS = (("row_dot", "D"), ("flash_bwd_dkdv", "dkdv"),
                     ("flash_bwd_dq", "dq"))
#: the scan backward's four launches: the time chunks' sweeps, their ends
#: chained, the full walks, the sums
SCAN_BWD_KERNELS = tuple((f"mamba_scan_bwd_{k}", k)
                         for k in ("local", "cross", "walk", "reduce"))


def phase_flash_backward(gen) -> dict:
    """The flash backward kernel at stablelm-3b's training microbatch
    (2 sequences of 2048, 32 heads of 80, causal) in bf16, as the model
    trains (the kernels line's row), and in fp32 (fields of their own);
    at the other trained configs' microbatches (``*_train``); then the card
    tests' options: GQA, window, softcap, Sq != Skv, rows with no allowed
    key, hd 8 through 256."""
    bf16, f32 = torch.bfloat16, torch.float32
    shape = (2, 2048, 2048, 32, 1, 80, True, 0, 0.0)
    main = _flash_bwd_case("stablelm-3b train microbatch, bf16 tensor cores",
                           gen, *shape, bf16, library=True, device=True)
    fp32 = _flash_bwd_case("stablelm-3b train microbatch, fp32 FMA", gen,
                           *shape, f32)
    main.update({f"fp32_{k}": fp32[k] for k in ("ms", "plain_ms",
                                                "bound_ms", "kernel_ops_ms",
                                                "max_abs_err", "rel_norm")})
    # the GQA configs' training shape (mixtral-8x7b's train_4k sequence,
    # 8 kv heads of 128, G 4, window 4096: the window holds every causal
    # pair, so scaled_dot_product_attention's causal backward is the same
    # function)
    main["gqa_train"] = _flash_bwd_case(
        "mixtral-8x7b train microbatch (G 4, hd 128, window 4096), bf16 "
        "tensor cores", gen, 2, 4096, 4096, 8, 4, 128, True, 4096, 0.0, bf16,
        library=True, device=True)
    # phase 5's dense microbatches (one sequence of 2048): qwen2.5-32b at
    # G 5, and granite-20b under MQA, where the dK/dV kernel's grid is
    # (B x Kh, Skv / 64) = 32 blocks for 132 SMs, each walking all 48
    # query heads
    main["g5_train"] = _flash_bwd_case(
        "qwen2.5-32b train microbatch (Kh 8, G 5, hd 128), bf16 tensor "
        "cores", gen, 1, 2048, 2048, 8, 5, 128, True, 0, 0.0, bf16,
        library=True, device=True)
    main["mqa_train"] = _flash_bwd_case(
        "granite-20b train microbatch (MQA: Kh 1, G 48, hd 128), bf16 "
        "tensor cores", gen, 1, 2048, 2048, 1, 48, 128, True, 0, 0.0, bf16,
        library=True, device=True)
    # the non-causal microbatches: llama-3.2-vision-11b's cross-attention
    # (1601 = 25 x 64 + 1 vision keys: the last key tile holds one key, and
    # its dK/dV rows are a 64-row tile of one row) and hubert-xlarge's
    # encoder (16 heads of 80, every pair allowed)
    main["vlm_cross_train"] = _flash_bwd_case(
        "llama-3.2-vision-11b cross-attention train microbatch (Sq 2048, "
        "Skv 1601, Kh 8, G 4, hd 128, non-causal), bf16 tensor cores", gen,
        1, 2048, 1601, 8, 4, 128, False, 0, 0.0, bf16, library=True,
        device=True)
    main["hubert_train"] = _flash_bwd_case(
        "hubert-xlarge train microbatch (16 heads of 80, non-causal), bf16 "
        "tensor cores", gen, 4, 2048, 2048, 16, 1, 80, False, 0, 0.0, bf16,
        library=True, device=True)
    for args in (("gqa+window+softcap hd128", 2, 257, 257, 2, 2, 128, True,
                  100, 30.0, bf16),
                 ("causal Sq<Skv G4 hd128", 1, 130, 190, 2, 4, 128, True, 0,
                  0.0, bf16),
                 ("causal Sq>Skv window softcap hd80", 1, 190, 70, 1, 4, 80,
                  True, 48, 10.0, bf16),
                 ("masked rows hd80", 1, 100, 20, 1, 2, 80, False, 10, 0.0,
                  bf16),
                 ("cross ragged hd256", 1, 77, 213, 1, 4, 256, False, 0, 0.0,
                  bf16),
                 ("non-causal hd8", 1, 70, 65, 2, 4, 8, False, 0, 0.0, bf16),
                 ("gqa+window+softcap fp32 hd128", 2, 257, 257, 2, 2, 128,
                  True, 100, 30.0, f32),
                 ("masked rows fp32 hd80", 1, 100, 20, 1, 2, 80, False, 10,
                  0.0, f32),
                 ("causal Sq>Skv fp32 hd256", 1, 130, 97, 1, 2, 256, True, 0,
                  0.0, f32)):
        _flash_bwd_case(*args[:1], gen, *args[1:])
    return main


def _scan_bwd_case(label, gen, Bt, T, d, N, dtype, lanes=None,
                   device: bool = False) -> dict:
    """The backward kernels on the forward kernel's own carries (its lane
    split ``lanes``), against ``mamba_scan_backward_ref`` on the same
    (delta and x widened to fp32: with bf16 ones the kernels' gradients of
    them must be exactly their fp32 gradients of the widened values,
    rounded).  ``device``: also the device time a call, back to back, and
    each of the four passes' from ``torch.profiler``."""
    from repro_torch.kernels.mamba_scan import mamba_scan_backward_ref
    from repro_torch.kernels.mamba_scan.ops import (mamba_scan_backward_cuda,
                                                    mamba_scan_cuda)
    args = _scan_inputs(gen, Bt, T, d, N, False, dtype)
    dev = gen.device
    dy = torch.randn((Bt, T, d), generator=gen, device=dev)
    dhT = torch.randn((Bt, d, N), generator=gen, device=dev)
    _, _, carries = mamba_scan_cuda(*args, lanes=lanes, carries=True)
    bwd = lambda: mamba_scan_backward_cuda(*args, carries, dy, dhT)
    a, b = bwd(), bwd()
    wide = [t.float() for t in args[:2]] + list(args[2:])
    f = mamba_scan_backward_cuda(*wide, carries, dy, dhT)
    r = mamba_scan_backward_ref(*wide, carries, dy, dhT)
    torch.cuda.synchronize()
    err, long_sum_rel = 0.0, {}
    for name, x, y, w, plain, arg in zip(("delta", "x", "B", "C", "A", "h0"),
                                         a, b, f, r, args):
        if not same(x, y):
            raise AssertionError(f"mamba_scan_backward[{label}] d{name}: "
                                 f"two launches differ")
        if not same(x, w.to(arg.dtype)):
            raise AssertionError(f"mamba_scan_backward[{label}] d{name}: "
                                 f"not the widened inputs' gradient")
        rtol, atol = SCAN_TOL
        if name in SCAN_LONG_SUMS:
            atol *= float(plain.abs().max())
            # how much of the limit's atol the kernel uses
            long_sum_rel[f"d{name}"] = float(
                (w - plain).abs().max() / plain.abs().max())
        err = max(err, _check_close(f"mamba_scan_backward[{label}] d{name}",
                                    w, plain, (rtol, atol)))
    del a, b, f, r
    ms = time_ms(bwd)
    device_ms = back_to_back_ms(bwd) if device else None
    split = device_split_ms(bwd, SCAN_BWD_KERNELS) if device else None
    plain_ms = time_ms(lambda: mamba_scan_backward_ref(
        *args, carries, dy, dhT), iters=3, warmup=1)
    # one exp2 a (b, t, c, n) against the bytes read once (delta, x, B,
    # C, A, the carries, dy, dhT) and written once (the six gradients,
    # each the size of its input)
    size = lambda ts: sum(t.numel() * t.element_size() for t in ts)
    nbytes = size(args[:5]) + size((carries, dy, dhT)) + size(args)
    bnd, by = bound_ms(nbytes, Bt * T * d * N, PEAK_EX2_S)
    # the design's own work: two exp2 a (b, t, c, n), the local sweep's
    # and the walk's rebuild
    kernel_ops_ms = 2 * Bt * T * d * N / PEAK_EX2_S * 1e3
    split_s = ""
    if device:
        split_s = " device_ms_by_pass=" + (",".join(
            f"{k}:{v:.4f}" for k, v in split.items()) if split
            else "not measured")
    log(f"  mamba_scan_backward[{label}]: Bt={Bt} T={T} d={d} N={N} "
        f"{str(dtype).split('.')[-1]} lanes={lanes or 'default'} "
        f"carries={tuple(carries.shape)} max_abs_err={err:.3g} "
        f"tol={SCAN_TOL} (dB, dC, dA: atol x their largest value; "
        f"their max gap / max value: "
        + ", ".join(f"{k} {v:.3g}" for k, v in long_sum_rel.items())
        + ") "
        f"ms={ms:.4f}{f' device_ms={device_ms:.4f}' if device else ''}"
        f"{split_s} plain_ms={plain_ms:.4f} library_ms=none "
        f"bound_ms={bnd:.4f} ({by}) kernel_ops_ms={kernel_ops_ms:.4f} "
        f"(2 exp2 a state a step) share_of_bound={bnd / ms:.4f} "
        f"bit_stable=True same_as_widened=True")
    res = dict(ms=ms, plain_ms=plain_ms, library_ms=None, bound_ms=bnd,
               bound_by=by, max_abs_err=err, long_sum_rel=long_sum_rel,
               kernel_ops_ms=kernel_ops_ms)
    if device:
        res["device_ms"] = device_ms
        res["device_ms_by_pass"] = split
    return res


def phase_scan_backward(gen) -> dict:
    """The scan's backward kernels at falcon-mamba-7b's training microbatch
    (1 sequence of 2048, d_inner 8192, N 16) with bf16 delta/x, as the
    model passes them (the kernels line's row), with each pass's device
    time; then the card tests' options: N 4, 8, 32, a ragged last time
    chunk, d not a multiple of the 64-channel block, fp32 delta/x, and
    carries from each of the forward's lane splits."""
    bf16, f32 = torch.bfloat16, torch.float32
    shape = (1, 2048, 8192, 16)
    main = _scan_bwd_case("falcon-mamba-7b train microbatch, bf16 delta/x",
                          gen, *shape, bf16, device=True)
    for args in (("ragged T/d N=16 fp32", 3, 333, 1000, 16, f32),
                 ("N=4 lanes 1 bf16", 2, 45, 64, 4, bf16, 1),
                 ("N=8 lanes 4 fp32", 1, 100, 130, 8, f32, 4),
                 ("N=32 lanes 1 fp32", 2, 33, 40, 32, f32, 1),
                 ("N=32 lanes 2 bf16", 1, 61, 64, 32, bf16, 2),
                 ("odd d N=5 lanes 4 bf16", 2, 70, 131, 5, bf16, 4)):
        _scan_bwd_case(*args[:1], gen, *args[1:])
    return main


# ---------------------------------------------------------------------------
#  Phase 2, AdamW and the global norm
# ---------------------------------------------------------------------------
#: the models whose training cells the benchmark runs, at the depth it runs
#: them (0: the published depth), and their microbatches
ADAMW_MODELS = {"stablelm-3b": (0, 2), "falcon-mamba-7b": (32, 4)}
#: bytes a parameter at fp32 state: the update reads p, g, m, v and writes
#: p, m, v (28), the norm reads g (4)
ADAMW_BYTES = 32


def _adamw_state(shapes, dtype, gen):
    """params, gradients (sums over the passes) and moments of ``shapes``
    on the card, drawn from ``gen``; the step at 0."""
    from repro_torch.train.optimizer import tree_map
    dev = gen.device

    def draw(scale, positive=False):
        def one(t):
            x = torch.randn(t.shape, device=dev, generator=gen,
                            dtype=torch.float32).mul_(scale)
            return (x.abs_() if positive else x).to(dtype)
        return tree_map(one, shapes)
    params, grads = draw(0.02), draw(1e-3)
    opt = {"m": draw(1e-4), "v": draw(1e-8, positive=True),
           "step": torch.zeros((), dtype=torch.int32, device=dev)}
    return params, grads, opt


def _adamw_gate(arch: str, cfg, div: int, gen) -> float:
    """The kernels against the plain route at two layers of ``arch``'s
    leaves (embedding and head whole), fp32 and bf16 state, ``div``
    passes: p, m and v bitwise at clip 0 over two steps, the norm within
    rtol 1e-6, a rerun at clip 1 bitwise.  Returns the largest relative
    gap of the norm."""
    from repro_torch.models.transformer import param_shapes
    from repro_torch.train.optimizer import (OptConfig, adamw_update,
                                             tree_leaves, tree_map)
    shapes = param_shapes(cfg.replace(n_layers=2))
    worst = 0.0
    for dtype in (torch.float32, torch.bfloat16):
        runs = {}
        for impl, clip in (("auto", 0.0), ("reference", 0.0), ("auto", 1.0),
                           ("auto", 1.0)):
            gen.manual_seed(35)
            p, g, opt = _adamw_state(shapes, dtype, gen)
            ocfg = OptConfig(grad_clip=clip, warmup_steps=1)
            norms = []
            for k in range(2):
                gk = tree_map(lambda t: t.clone(), g)
                norms.append(adamw_update(gk, p, opt, ocfg, cfg, grad_div=div,
                                          impl=impl)["grad_norm"])
            leaves = tree_leaves(p) + tree_leaves(opt["m"]) \
                + tree_leaves(opt["v"])
            runs.setdefault((impl, clip), []).append((leaves, norms))
            del p, g, opt
        (kl, kn), = runs[("auto", 0.0)]
        (rl, rn), = runs[("reference", 0.0)]
        if not all(same(a, b) for a, b in zip(kl, rl)):
            raise AssertionError(f"adamw {arch} {dtype}: the kernels' p, m, "
                                 f"v differ from the plain route's")
        gap = max(abs(float(a) - float(b)) / float(b) for a, b in zip(kn, rn))
        if gap > 1e-6:
            raise AssertionError(f"adamw {arch} {dtype}: norm gap {gap}")
        (al, an), (bl, bn) = runs[("auto", 1.0)]
        if not (all(same(a, b) for a, b in zip(al, bl))
                and all(same(a, b) for a, b in zip(an, bn))):
            raise AssertionError(f"adamw {arch} {dtype}: reruns differ")
        worst = max(worst, gap)
        log(f"  adamw[{arch} gate, {str(dtype).split('.')[-1]} state, "
            f"{div} passes]: p, m, v bitwise the plain route's at clip 0, "
            f"norm within {gap:.2e}, reruns bitwise at clip 1")
        del runs, kl, rl, al, bl
        torch.cuda.empty_cache()
    return worst


def _adamw_leaf_gate(arch: str, cfg, div: int, gen) -> float:
    """The kernels against the plain route on each of ``arch``'s leaves
    at the cells' depth and fp32 state, one leaf at a time and whole, as
    the main path hands them over (a stacked leaf is one flat buffer;
    falcon-mamba-7b's ``mamba.in_proj`` at 32 layers holds 2**31
    elements): the kernels on copies of p, m and v, the plain route on
    the originals, one gradient, ``div`` passes, clip 0.  p, m and v
    bitwise, the leaf's norm within rtol 1e-6.  Returns the largest
    relative gap of a norm."""
    from repro_torch.models.transformer import param_shapes
    from repro_torch.train.optimizer import (OptConfig, adamw_update,
                                             tree_leaves)
    ocfg = OptConfig(grad_clip=0.0, warmup_steps=1)
    leaves = tree_leaves(param_shapes(cfg))
    worst, most = 0.0, 0
    for i, shape in enumerate(leaves):
        gen.manual_seed(35 + i)
        p, g, opt = _adamw_state({"x": shape}, torch.float32, gen)
        kp, km, kv = (t["x"].clone() for t in (p, opt["m"], opt["v"]))
        # the kernels leave g as it is; the plain route divides it in place
        kn = adamw_update(g, {"x": kp}, {"m": {"x": km}, "v": {"x": kv},
                                         "step": opt["step"].clone()},
                          ocfg, cfg, grad_div=div)["grad_norm"]
        rn = adamw_update(g, p, opt, ocfg, cfg, grad_div=div,
                          impl="reference")["grad_norm"]
        if not (same(kp, p["x"]) and same(km, opt["m"]["x"])
                and same(kv, opt["v"]["x"])):
            raise AssertionError(f"adamw {arch} leaf {i} "
                                 f"{tuple(shape.shape)}: the kernels' p, m, "
                                 f"v differ from the plain route's")
        gap = abs(float(kn) - float(rn)) / float(rn)
        if gap > 1e-6:
            raise AssertionError(f"adamw {arch} leaf {i} "
                                 f"{tuple(shape.shape)}: norm gap {gap}")
        worst, most = max(worst, gap), max(most, shape.numel())
        del p, g, opt, kp, km, kv
        torch.cuda.empty_cache()
    log(f"  adamw[{arch} gate, {len(leaves)} leaves whole at "
        f"{cfg.n_layers} layers, fp32 state, {div} passes]: p, m, v bitwise "
        f"the plain route's at clip 0, each leaf's norm within {worst:.2e} "
        f"(largest leaf {most} elements)")
    return worst


def _adamw_times(arch: str, cfg, div: int, gen) -> dict:
    """One step's norm and update over ``arch``'s whole leaves (fp32
    state, ``div`` passes): launches, ms (CUDA events), device ms (5 steps
    back to back) and each kernel's, the bound, the plain route's ms and
    ``torch._fused_adamw_``'s over the same lists (decoupled decay, no
    norm, no division: a yardstick the port never calls)."""
    from repro_torch.kernels import launch_counts, reset_launches
    from repro_torch.kernels.adamw import adamw_cuda, square_sums_cuda
    from repro_torch.models.transformer import param_shapes
    from repro_torch.train.optimizer import (OptConfig, adamw_update,
                                             tree_leaves)
    ocfg = OptConfig(grad_clip=1.0)
    gen.manual_seed(35)
    p, g, opt = _adamw_state(param_shapes(cfg), torch.float32, gen)
    n = sum(t.numel() for t in tree_leaves(p))
    P, G, M, V = (tree_leaves(t) for t in (p, g, opt["m"], opt["v"]))
    one = torch.ones((), device=gen.device)
    reset_launches()
    adamw_update(g, p, opt, ocfg, cfg, grad_div=div)
    torch.cuda.synchronize()
    launches = launch_counts()
    launches = launches["adamw_update"] + launches["adamw_square_sum"]
    step = lambda: adamw_update(g, p, opt, ocfg, cfg, grad_div=div)

    def update():
        for pp, gg, mm, vv in zip(P, G, M, V):
            adamw_cuda(pp, gg, mm, vv, lr=one, scale=one, bc1=one, bc2=one,
                       b1=0.9, b2=0.95, eps=1e-8, wd=0.1, grad_div=div)
    out = {"params": n, "launches": launches, "ms": time_ms(step, 5, 1),
           "device_ms": back_to_back_ms(step, 5),
           "update_device_ms": back_to_back_ms(update, 5),
           "norm_device_ms": back_to_back_ms(
               lambda: square_sums_cuda(G, div, 1.0), 5)}
    out["bound_ms"], out["bound_by"] = bound_ms(ADAMW_BYTES * n, 0)
    # the plain route divides the gradients in place at every call; its
    # time does not depend on their values
    out["plain_ms"] = time_ms(lambda: adamw_update(
        g, p, opt, ocfg, cfg, grad_div=div, impl="reference"), 3, 1)
    steps = [torch.ones((), device=gen.device) for _ in P]
    out["library_ms"] = time_ms(lambda: torch._fused_adamw_(
        P, G, M, V, [], steps, lr=3e-4, beta1=0.9, beta2=0.95,
        weight_decay=0.1, eps=1e-8, amsgrad=False, maximize=False), 5, 1)
    out["library_device_ms"] = back_to_back_ms(lambda: torch._fused_adamw_(
        P, G, M, V, [], steps, lr=3e-4, beta1=0.9, beta2=0.95,
        weight_decay=0.1, eps=1e-8, amsgrad=False, maximize=False), 5)
    log(f"  adamw[{arch}, {len(P)} leaves, {n} parameters, fp32 state, "
        f"{div} passes]: {launches} launches a step, {out['ms']:.3f} ms, "
        f"device {out['device_ms']:.3f} (update {out['update_device_ms']:.3f}"
        f", norm {out['norm_device_ms']:.3f}), bound "
        f"{out['bound_ms']:.3f} ({ADAMW_BYTES} B a parameter at "
        f"{PEAK_BYTES_S / 1e12} TB/s), plain {out['plain_ms']:.3f}, "
        f"torch._fused_adamw_ {out['library_ms']:.3f} (device "
        f"{out['library_device_ms']:.3f})")
    del p, g, opt, P, G, M, V
    torch.cuda.empty_cache()
    return out


def phase_adamw(gen) -> dict:
    """The fused AdamW update and global norm (``csrc/adamw.cu``) at the
    benchmark's training cells' leaves: stablelm-3b whole (the kernels
    line's row) and falcon-mamba-7b at 32 layers (``falcon_*`` fields).
    First the bitwise gates, at two layers of each in fp32 and bf16 state
    (``_adamw_gate``) and on every leaf whole at the cells' depth
    (``_adamw_leaf_gate``), then one step's times over every leaf
    (``_adamw_times``)."""
    from repro_torch.configs import get_config
    out = {}
    for arch, (depth, div) in ADAMW_MODELS.items():
        cfg = get_config(arch)
        if depth:
            cfg = cfg.replace(n_layers=depth)
        gap = max(_adamw_gate(arch, cfg, div, gen),
                  _adamw_leaf_gate(arch, cfg, div, gen))
        m = _adamw_times(arch, cfg, div, gen)
        m["norm_rel_gap"] = gap
        out[arch] = m
    row = dict(out["stablelm-3b"], max_abs_err=0.0)
    row.update({f"falcon_{k}": v for k, v in out["falcon-mamba-7b"].items()})
    return row


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


def keyed_flow(data, key: str):
    """lineorder -> Aggregate(key: revenue sum, row count) -> sink.  Keyed
    on a source column, so the shard planner partitions by hash (each key's
    rows on one shard): lo_suppkey 2,000 groups at SF1, lo_custkey 30,000,
    lo_partkey 200,000."""
    from repro_torch.core.graph import Dataflow
    from repro_torch.etl.components import Aggregate, ArraySource, CollectSink
    flow = Dataflow(f"{key}-revenue")
    sink = CollectSink("sink")
    flow.chain(ArraySource("lineorder", data.lineorder),
               Aggregate(f"by_{key}", [key],
                         {"revenue": ("lo_revenue", "sum"),
                          "orders": ("lo_revenue", "count")}),
               sink)
    return flow, sink


def keyed_oracle(data, key: str) -> dict:
    """The keyed flow's float64 oracle: ``np.unique`` + ``bincount``."""
    uniq, inv = np.unique(data.lineorder[key], return_inverse=True)
    return {key: uniq,
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
    supp = session.run(keyed_flow(data, "lo_suppkey"), engine="streaming",
                       fuse=True, num_splits=8)
    supp_serial = supp.table
    log(f"  lo_suppkey serial: wall={supp.run.wall_time:.4f}s "
        f"rows/s={rows / supp.run.wall_time:.6g}")
    _, run, counts = sharded_run(
        session, f"lo_suppkey shards={SHARDS} mesh",
        keyed_flow(data, "lo_suppkey"), keyed_oracle(data, "lo_suppkey"),
        supp_serial, rows,
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


def phase_keyed(data) -> dict:
    """The partitioned grouped sums on the ETL path: SF1 lineorder through
    keyed Aggregates on ``torch`` (fused, 8 splits).  By lo_partkey
    (200,000 ids) serial on the optimized engine, then over 4 shards on the
    mesh route (each shard's groupby over the whole id range, the
    combiner's segment sum over 200,000 ids); by lo_custkey (30,000 ids)
    serial.  Each run twice, byte-identical, within FLOAT_RTOL of its
    float64 oracle, with no degradation; each prints its wall, rows/s and
    the grouped sums' launches, counted from 0 just before it.  Returns
    the launches of all these runs."""
    import repro_torch
    from repro_torch.kernels import launch_counts, reset_launches
    session = repro_torch.Session(backend="torch", metadata=None)
    rows = len(data.lineorder["lo_orderkey"])
    total = {k: 0 for k in ETL_KERNELS}

    def twice(label, run_once):
        tables = []
        for attempt in (1, 2):
            got, counts = run_once(f"{label}#{attempt}")
            for k in total:
                total[k] += counts[k]
            tables.append(got)
        first, second = tables
        for k in first:
            if (first[k].dtype != second[k].dtype
                    or first[k].tobytes() != second[k].tobytes()):
                raise AssertionError(f"{label}: second run differs in {k}")
        log(f"  {label}: second run byte-identical")
        return first

    def serial(key, expect):
        def once(label):
            torch.cuda.synchronize()
            reset_launches()
            res = session.run(keyed_flow(data, key), engine="optimized",
                              fuse=True, num_splits=8)
            torch.cuda.synchronize()
            counts = launch_counts()
            run = res.run
            check_oracle(res.table, expect, FLOAT_RTOL, label)
            if run.degradations != 0:
                raise AssertionError(f"{label}: degradations "
                                     f"{run.degradation_events}")
            if counts["radix_groupby"] < 1:
                raise AssertionError(f"{label}: radix_groupby never "
                                     f"launched")
            log(f"  {label}: wall={run.wall_time:.4f}s "
                f"rows/s={rows / run.wall_time:.6g} "
                f"groups={len(res.table[key])} launches="
                f"{ {k: counts[k] for k in ETL_KERNELS} } "
                f"oracle_rtol={FLOAT_RTOL} ok")
            return res.table, counts
        return once

    def sharded(key, expect, serial_table):
        def once(label):
            got, run, counts = sharded_run(
                session, label, keyed_flow(data, key), expect, serial_table,
                rows, ("radix_groupby", "segment_sum"), shards=SHARDS,
                shard_impl="mesh")
            if run.shard.mode != "hash" or run.shard.impl != "mesh":
                raise AssertionError(f"{label}: {run.shard.impl}/"
                                     f"{run.shard.mode}, expected mesh/hash")
            check_oracle(got, expect, FLOAT_RTOL, label)
            return got, counts
        return once

    part = keyed_oracle(data, "lo_partkey")
    part_serial = twice("lo_partkey serial optimized",
                        serial("lo_partkey", part))
    twice(f"lo_partkey shards={SHARDS} mesh",
          sharded("lo_partkey", part, part_serial))
    twice("lo_custkey serial optimized",
          serial("lo_custkey", keyed_oracle(data, "lo_custkey")))
    return total


# ---------------------------------------------------------------------------
#  Phase 3c: kernel failures abort
# ---------------------------------------------------------------------------
LAUNCH_ERROR = "CUDA error 7 (too many resources requested for launch)"


class FailOnce:
    """Test double for a kernel's CUDA entry point: its first call raises a
    launch-style error, later calls go to the real entry.  Installed and
    removed by the fault phase."""

    def __init__(self, module, entry: str, kernel: str):
        self.module, self.entry, self.kernel = module, entry, kernel
        self.real = getattr(module, entry)
        self.failed = False

    def __call__(self, *args, **kwargs):
        if not self.failed:
            self.failed = True
            raise RuntimeError(f"{self.kernel}: {LAUNCH_ERROR}")
        return self.real(*args, **kwargs)

    def __enter__(self):
        setattr(self.module, self.entry, self)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.entry, self.real)
        return False


def phase_faults(data) -> None:
    """Kernel failures on SF1 Q4.1 through ``Session.run`` (streaming,
    fused, 8 splits): the probe's CUDA entry raising once, the radix
    groupby's raising once, and a kernel library that cannot load.  The
    card has no degradation ladder, so each run must abort with its error,
    record no degradation and leave the backend on no other route.  Prints
    each run's time to the abort."""
    import repro_torch
    from repro_torch.core import faults, resolve_backend
    from repro_torch.etl.queries import build_q4
    from repro_torch.kernels import KernelLibraryError, _cuda
    from repro_torch.kernels.hash_join import ops as probe_ops
    from repro_torch.kernels.radix_groupby import ops as groupby_ops
    bk = resolve_backend("torch")
    session = repro_torch.Session(backend="torch", metadata=None)

    def aborts(label, exc_type, double):
        t0 = time.perf_counter()
        with double, faults.fault_recorder() as rec:
            try:
                session.run(build_q4(data), engine="streaming", fuse=True,
                            num_splits=8)
            except exc_type as e:
                torch.cuda.synchronize()
                log(f"  {label}: aborted with {type(e).__name__}: {e} "
                    f"after {time.perf_counter() - t0:.4f}s")
            else:
                raise AssertionError(f"{label}: the run did not abort")
        if rec.degradations or bk._join_route or bk._groupby_route:
            raise AssertionError(f"{label}: stepped a ladder: "
                                 f"{[d.spec() for d in rec.degradations]}")

    class NoLibrary:
        """``_cuda.library`` raising as a library that cannot load does."""
        def __call__(self):
            raise KernelLibraryError("the CUDA kernel library could not be "
                                     "built or loaded")

        def __enter__(self):
            self.real, _cuda.library = _cuda.library, self

        def __exit__(self, *exc):
            _cuda.library = self.real
            return False

    aborts("Q4.1 probe failing once", RuntimeError,
           FailOnce(probe_ops, "hash_probe_cuda", "hash_probe"))
    aborts("Q4.1 radix groupby failing once", RuntimeError,
           FailOnce(groupby_ops, "radix_groupby_cuda", "radix_groupby"))
    aborts("Q4.1 library that cannot load", KernelLibraryError, NoLibrary())


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
#: the dense configs served at full width, each cut to its first layers:
#: qwen2.5-32b 16 of 64 layers, qwen2-72b 8 of 80, granite-20b 20 of 52
#: (8.2-9.5B fp32 parameters, 30.5-35.4 GiB).  24, 12 and 32 layers
#: (12.7-13.3B) fit too, peaking at 55.4-65.5 GiB on an NVIDIA H100 80GB
#: HBM3 at 700 W, where they took the whole script past 9 minutes
DENSE_SERVE = {"qwen2.5-32b": 16, "qwen2-72b": 8, "granite-20b": 20}


def _gap(got: torch.Tensor, want: torch.Tensor):
    """Largest absolute difference and the share of rows with the same
    argmax; raises on non-finite logits."""
    g, w = got.float(), want.float()
    if not bool(torch.isfinite(g).all()):
        raise AssertionError("logits not finite")
    return (float((g - w).abs().max()),
            float((g.argmax(-1) == w.argmax(-1)).float().mean()))


def teacher_forcing(arch: str, params, fcfg, toks: torch.Tensor,
                    gated: bool = True, extra: dict = None) -> None:
    """In fp32: prefill all but the last 4 tokens, then 4 decode steps, must
    give the logits of a prefill of all of them within TF_TOL.  ``extra``:
    more batch entries for both prefills (a vlm's vision, whose K/V decode
    reads from the cache).

    With MoE layers that is an identity only where no slot is dropped
    differently: a prefill drops a group's slots past the capacity C, decode
    (a group of B tokens, C >= 8) never does, and over a batch the longer
    prefill's groups hold other tokens than the shorter one's.  The loads
    of the longer prefill show it; ``gated=False`` reports such a run
    without holding it to TF_TOL."""
    from repro_torch.models import transformer as tf
    S = toks.shape[1]
    extra = extra or {}
    lg, cache = tf.forward_prefill(params, dict(extra,
                                                tokens=toks[:, :S - 4]), fcfg)
    cache = tf.grow_cache(cache, fcfg, S)
    for t in range(S - 4, S):
        lg, cache = tf.decode_step(params, cache, {"tokens": toks[:, t:t + 1]},
                                   fcfg)
    del cache
    with expert_loads() as loads:
        lg_full, _ = tf.forward_prefill(params, dict(extra, tokens=toks),
                                        fcfg)
    err, agree = _gap(lg, lg_full)
    window = (f" (window {fcfg.sliding_window}, {S - 4} mod it = "
              f"{(S - 4) % fcfg.sliding_window})"
              if fcfg.sliding_window and S - 4 > fcfg.sliding_window else "")
    moe = f"; prefill {S}: {loads.summary()}" if loads.layers else ""
    log(f"  {arch}: fp32 batch {toks.shape[0]}, prefill {S - 4} + 4 decode "
        f"steps vs prefill {S}{window}: max_abs_err={err:.3g} "
        f"argmax_agree={agree:.3f} "
        f"{f'tol={TF_TOL}' if gated else 'not gated'}{moe}")
    if gated and not torch.allclose(lg.float(), lg_full.float(),
                                    rtol=TF_TOL[0], atol=TF_TOL[1]):
        raise AssertionError(f"{arch}: decode disagrees with prefill "
                             f"({S - 4} + 4 tokens)")


def _top_layers(params, n: int):
    """The same parameter tree cut to its first ``n`` layers (views)."""
    def cut(t):
        return {k: cut(v) for k, v in t.items()} if isinstance(t, dict) \
            else t[:n]
    return dict(params, blocks=cut(params["blocks"]))


class expert_loads:
    """Within the block, records each MoE layer's largest expert load (the
    slots its tokens ask of one expert) in the last group and in any group,
    beside the capacity C: a load over C drops slots."""

    def __enter__(self):
        from repro_torch.models import moe
        self.moe, self.real, self.layers = moe, moe.route, []

        def spy(xg, valid, router, k, capacity):
            r = self.real(xg, valid, router, k, capacity)
            self.layers.append((int(r.load[-1].max()), int(r.load.max()),
                                capacity))
            return r
        moe.route = spy
        return self

    def __exit__(self, *exc):
        self.moe.route = self.real

    def summary(self) -> str:
        last, most, C = (max(col) for col in zip(*self.layers))
        drops = "slots dropped" if most > C else "none dropped"
        return (f"largest expert load: last group {last}, any group {most}, "
                f"against C={C} ({drops})")


def route_check(arch: str, cfg, params, batch: dict,
                hidden: bool = False) -> None:
    """The kernel route's prefill against the plain route's, with the fp32
    plain route as the yardstick: the last position's logits, or with
    ``hidden`` the backbone's output at every position (an encoder, whose
    earlier positions see later frames: where a masking fault shows).  The
    fp32 kernel route must be within F32_LOGITS_ATOL of it, and the
    compute-dtype kernel route no further than twice the compute-dtype
    plain route plus BF16_MARGIN."""
    from repro_torch.models import transformer as tf
    plain = dict(attn_impl="reference", ssm_impl="reference")

    def run(c):
        if not hidden:
            return tf.forward_prefill(params, batch, c)[0]
        x = tf._embed(params, batch, c, tf.NO_RULES)
        pos = torch.arange(x.shape[1], device=x.device)
        return tf.backbone(params, x, c, tf.NO_RULES, "prefill", pos,
                           pos)[0]
    truth = run(cfg.replace(compute_dtype="float32", **plain))
    scale = float(truth.abs().max())
    e32, a32 = _gap(run(cfg.replace(compute_dtype="float32")), truth)
    ek, ak = _gap(run(cfg), truth)
    ep, ap_ = _gap(run(cfg.replace(**plain)), truth)
    what = (f"hidden state at all {tuple(truth.shape)} positions"
            if hidden else "prefill logits")
    agree = ((lambda a: "") if hidden
             else (lambda a: f" argmax_agree={a:.3f}"))
    log(f"  {arch}: {what} at depth {cfg.n_layers} (|max| {scale:.3g}) "
        f"against the fp32 plain route: fp32 kernel route "
        f"max_abs_err={e32:.3g}{agree(a32)}; {cfg.compute_dtype} kernel "
        f"route {ek:.4g}{agree(ak)}; {cfg.compute_dtype} plain route "
        f"{ep:.4g}{agree(ap_)}")
    if e32 > F32_LOGITS_ATOL:
        raise AssertionError(f"{arch}: fp32 kernel route {e32:.3g} from the "
                             f"plain route, beyond {F32_LOGITS_ATOL}")
    if ek > 2.0 * ep + BF16_MARGIN:
        raise AssertionError(f"{arch}: {cfg.compute_dtype} kernel route "
                             f"{ek:.4g} from the fp32 model, beyond twice the "
                             f"plain route's {ep:.4g} + {BF16_MARGIN}")


def make_model(arch: str, dev: torch.device, depth: int = 0):
    """(cfg, params): ``arch`` at its full width, cut to its first ``depth``
    layers where given, random weights from seed 0 made on the card; logs
    the parameter count, the memory and the card, and resets the peak
    memory counter."""
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as tf
    full = get_config(arch)
    cfg = full.replace(n_layers=depth) if depth else full
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = tf.init_params(cfg, seed=0, device=dev)
    torch.cuda.synchronize()
    n_params = tf.param_count(cfg) / 1e9
    cut = (f"{n_params:.3f}B at the {cfg.n_layers} of {full.n_layers} "
           f"layers served, of {tf.param_count(full) / 1e9:.3f}B"
           if depth else f"{n_params:.3f}B")
    moe = (f", {cfg.n_experts} experts top-{cfg.experts_per_token}, group "
           f"{cfg.moe_group_size}, capacity factor {cfg.capacity_factor}, "
           f"window {cfg.sliding_window}, softcap {cfg.logit_softcap}"
           if cfg.n_experts else "")
    heads = (f", {cfg.n_heads} heads over {cfg.n_kv_heads} kv heads of "
             f"{cfg.hd}" + (", non-causal" if not cfg.causal else ""))
    log(f"{arch}: {cut} {cfg.param_dtype} params ({cfg.n_layers} layers, "
        f"d_model {cfg.d_model}, d_ff {cfg.d_ff}{heads}{moe}, compute "
        f"{cfg.compute_dtype}) made on the card in "
        f"{time.perf_counter() - t0:.1f}s, "
        f"{torch.cuda.memory_allocated() / 2**30:.1f} GiB (peak while made "
        f"{torch.cuda.max_memory_allocated() / 2**30:.1f}); card: "
        f"{card_line()}")
    torch.cuda.reset_peak_memory_stats()
    return cfg, params


@torch.no_grad()
def serve_model(arch: str, kernel: str, ref_depth: int,
                dev: torch.device, profile: bool = False,
                depth: int = 0) -> int:
    """Serve ``SERVE`` through ``BatchedServer`` twice at the full width of
    ``arch``, cut to its first ``depth`` layers where given (a model that
    does not fit the card); returns the launches of ``kernel`` in those two
    runs."""
    from repro_torch.kernels import launch_counts, reset_launches
    from repro_torch.launch.serve import BatchedServer, make_requests
    from repro_torch.models import transformer as tf
    cfg, params = make_model(arch, dev, depth)
    card = card_line()
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
            f"({st['decode_steps']:.0f} steps); {kernel} launches={launched}"
            f"; card: {card}")
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
    route_check(arch, cfg.replace(n_layers=ref_depth),
                _top_layers(params, ref_depth), {"tokens": toks})

    # teacher forcing in fp32: prefill S-4 tokens, then 4 decode steps ==
    # prefill S
    S = SERVE["prompt_len"]
    fcfg = cfg.replace(compute_dtype="float32")
    teacher_forcing(arch, params, fcfg, toks, gated=not cfg.n_experts)
    if cfg.n_experts:
        # one prompt of two full groups, then 4 decode steps: the longer
        # prefill's first two groups hold the same tokens (and drop the
        # same slots), and its last holds the 4 decoded tokens alone
        one = np.random.default_rng(2).integers(
            2, cfg.vocab_size, (1, 2 * cfg.moe_group_size + 4))
        teacher_forcing(arch, params, fcfg, torch.tensor(one, device=dev))
    if cfg.sliding_window:
        # past the window: the cache is a ring from the prefill on
        W = cfg.sliding_window
        long = np.random.default_rng(1).integers(2, cfg.vocab_size,
                                                 (1, W + 104))
        teacher_forcing(arch, params, fcfg,
                        torch.tensor(long, device=dev))
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
    log(f"  {arch}: peak device memory over the model's runs and checks "
        f"{torch.cuda.max_memory_allocated() / 2**30:.1f} GiB (the "
        f"parameters included)")
    del server, params
    torch.cuda.empty_cache()
    return launches


#: the cross-attention gates are initialised to zero, and tanh(0) * out
#: would hide the whole branch from every check: each is set to a value in
#: [0.5, 1) drawn from this numpy seed before any check
GATE_SEED = 0


def set_gates(params, seed: int = GATE_SEED) -> list:
    """Fill every ``xattn.gate`` from numpy ``seed``; returns the values."""
    rng = np.random.default_rng(seed)
    values = []
    for sub in params["blocks"].values():
        if "xattn" in sub:
            g = sub["xattn"]["gate"]
            v = rng.uniform(0.5, 1.0, tuple(g.shape))
            g.copy_(torch.tensor(v, dtype=g.dtype))
            values += v.ravel().tolist()
    return values


class prefill_seconds:
    """Within the block, the host seconds of each ``forward_prefill`` that
    ``generate`` calls, synchronised at its end (time to the first
    tokens, as ``BatchedServer.stats`` counts it)."""

    def __enter__(self):
        from repro_torch.train import serve_step
        self.mod, self.real, self.seconds = (serve_step,
                                             serve_step.forward_prefill, [])

        def timed(*args, **kwargs):
            t = time.perf_counter()
            out = self.real(*args, **kwargs)
            torch.cuda.synchronize()
            self.seconds.append(time.perf_counter() - t)
            return out
        serve_step.forward_prefill = timed
        return self

    def __exit__(self, *exc):
        self.mod.forward_prefill = self.real


@torch.no_grad()
def serve_vlm(dev: torch.device, profile: bool = False) -> int:
    """llama-3.2-vision-11b at full depth and width: ``SERVE``'s requests
    in waves, each wave through ``generate(..., vision=...)`` with random
    patch embeddings [batch, 1601, d_model] from the card's generator,
    twice.  Every prefill launches flash once a self-attention layer and
    once a cross-attention layer; decode reads the cached vision K/V with
    plain attention.  Returns flash's launches in those two runs."""
    from repro_torch.kernels import launch_counts, reset_launches
    from repro_torch.launch.serve import make_requests
    from repro_torch.models import transformer as tf
    from repro_torch.train.serve_step import generate
    arch, kernel = "llama-3.2-vision-11b", "flash_attention"
    cfg, params = make_model(arch, dev)
    gates = set_gates(params)
    n_cross = sum(cfg.has_cross_attn(i) for i in range(cfg.n_layers))
    log(f"  {arch}: {n_cross} cross-attention layers over "
        f"{cfg.n_vision_tokens} vision tokens; gates set from numpy seed "
        f"{GATE_SEED}: {', '.join(f'{g:.4f}' for g in gates)}")
    B, S, new = SERVE["batch"], SERVE["prompt_len"], SERVE["max_new"]
    waves = -(-SERVE["requests"] // B)
    prompts = torch.tensor(np.stack([r.prompt for r in make_requests(
        cfg, SERVE["requests"], S, new, seed=0)]), dtype=torch.long,
        device=dev)
    vgen = torch.Generator(device=dev)
    vgen.manual_seed(0)
    vision = [torch.randn((B, cfg.n_vision_tokens, cfg.d_model),
                          generator=vgen, device=dev) for _ in range(waves)]
    outputs = []
    torch.cuda.synchronize()
    reset_launches()
    for attempt in (1, 2):
        before = launch_counts()[kernel]
        t = time.perf_counter()
        with prefill_seconds() as pre:
            toks = torch.cat([generate(params, cfg, prompts[w * B:(w + 1) * B],
                                       new, vision=vision[w]).cpu()
                              for w in range(waves)])
        wall = time.perf_counter() - t
        launched = launch_counts()[kernel] - before
        if launched != (cfg.n_layers + n_cross) * waves:
            raise AssertionError(f"{arch}#{attempt}: {kernel} launched "
                                 f"{launched} times, expected "
                                 f"({cfg.n_layers} + {n_cross}) x {waves} "
                                 f"waves")
        if tuple(toks.shape) != (SERVE["requests"], new) or int(
                toks.min()) < 0 or int(toks.max()) >= cfg.vocab_size:
            raise AssertionError(f"{arch}#{attempt}: bad output tokens")
        steps = waves * (new - 1)
        prefill_s = sum(pre.seconds)
        log(f"  {arch}#{attempt}: {SERVE['requests']} requests in {waves} "
            f"waves through generate with vision, {toks.numel()} tokens in "
            f"{wall:.3f}s ({toks.numel() / wall:.1f} tok/s); prefill "
            f"{prefill_s / waves * 1e3:.1f} ms a wave of {B}x{S} "
            f"(+{cfg.n_vision_tokens} vision tokens); decode "
            f"{(wall - prefill_s) / steps * 1e3:.2f} ms a step ({steps} "
            f"steps); {kernel} launches={launched}")
        outputs.append(toks)
    launches = launch_counts()[kernel]
    if not torch.equal(outputs[0], outputs[1]):
        raise AssertionError(f"{arch}: the second run gave other tokens")
    log(f"  {arch}: second run token-identical; peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.1f} GiB")

    batch = {"tokens": prompts[:B], "vision": vision[0]}
    route_check(arch, cfg, params, batch)
    # decode over the cached vision K/V (plain attention) against the
    # longer prefill's cross-attention (flash)
    teacher_forcing(arch, params, cfg.replace(compute_dtype="float32"),
                    prompts[:B], extra={"vision": vision[0]})
    if profile:
        out = {}

        def prefill():
            out["cache"] = tf.forward_prefill(params, batch, cfg)[1]
        profile_device(f"{arch} prefill {B}x{S} + vision", prefill)
        cache = tf.grow_cache(out.pop("cache"), cfg, S + 1)
        profile_device(f"{arch} decode step at {S}",
                       lambda: tf.decode_step(params, cache,
                                              {"tokens": prompts[:B, -1:]},
                                              cfg))
    log(f"  {arch}: peak device memory over the model's runs and checks "
        f"{torch.cuda.max_memory_allocated() / 2**30:.1f} GiB (the "
        f"parameters included)")
    del params, vision
    torch.cuda.empty_cache()
    return launches


@torch.no_grad()
def serve_encoder(dev: torch.device, profile: bool = False) -> int:
    """hubert-xlarge at full depth and width: stub frame embeddings
    [requests, prompt_len, d_model] from the card's generator, encoded by
    ``forward_prefill`` in waves of ``SERVE["batch"]``, twice (an encoder
    has no decode step).  Every wave launches flash (non-causal) once a
    layer; the two runs' logits must be bit-identical.  Returns flash's
    launches in those two runs."""
    from repro_torch.kernels import launch_counts, reset_launches
    from repro_torch.models import transformer as tf
    arch, kernel = "hubert-xlarge", "flash_attention"
    cfg, params = make_model(arch, dev)
    B, S = SERVE["batch"], SERVE["prompt_len"]
    waves = -(-SERVE["requests"] // B)
    fgen = torch.Generator(device=dev)
    fgen.manual_seed(0)
    frames = torch.randn((SERVE["requests"], S, cfg.d_model), generator=fgen,
                         device=dev)
    outputs = []
    torch.cuda.synchronize()
    reset_launches()
    for attempt in (1, 2):
        before = launch_counts()[kernel]
        t = time.perf_counter()
        logits = []
        for w in range(waves):
            lg, _ = tf.forward_prefill(
                params, {"frames": frames[w * B:(w + 1) * B]}, cfg)
            logits.append(lg)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        launched = launch_counts()[kernel] - before
        if launched != cfg.n_layers * waves:
            raise AssertionError(f"{arch}#{attempt}: {kernel} launched "
                                 f"{launched} times, expected "
                                 f"{cfg.n_layers} layers x {waves} waves")
        logits = torch.cat(logits)
        if not bool(torch.isfinite(logits).all()) or tuple(
                logits.shape) != (SERVE["requests"], 1, cfg.vocab_size):
            raise AssertionError(f"{arch}#{attempt}: bad logits "
                                 f"{tuple(logits.shape)}")
        log(f"  {arch}#{attempt}: {SERVE['requests']} clips of {S} frames "
            f"in {waves} waves through forward_prefill in {wall:.3f}s "
            f"({SERVE['requests'] * S / wall:.0f} frames/s); "
            f"{wall / waves * 1e3:.1f} ms a wave of {B}x{S}; {kernel} "
            f"launches={launched}")
        outputs.append(logits)
    launches = launch_counts()[kernel]
    if not torch.equal(outputs[0], outputs[1]):
        raise AssertionError(f"{arch}: the second run gave other logits")
    log(f"  {arch}: second run's logits bit-identical; peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.1f} GiB")

    batch = {"frames": frames[:B]}
    route_check(arch, cfg, params, batch, hidden=True)
    if profile:
        profile_device(f"{arch} prefill {B}x{S}",
                       lambda: tf.forward_prefill(params, batch, cfg))
    del params, frames
    torch.cuda.empty_cache()
    return launches


# ---------------------------------------------------------------------------
#  Phase 5: LM training
# ---------------------------------------------------------------------------
#: the trained models: stablelm-3b whole (global batch 8 x 2048 in the
#: config's 4 microbatches, 4 steps); falcon-mamba-7b at 8 of its 64 layers
#: (its whole 117 GB of state does not fit the card; 2 x 2048 in 2
#: microbatches, 3 steps).  Then, at full width and 2 steps, each with its
#: config's own microbatches of one sequence, cut in depth so that the
#: parameters, the accumulator and the AdamW moments fit the card:
#: qwen2.5-32b at 4 of 64 layers, qwen2-72b at 2 of 80 (a bf16
#: accumulator), granite-20b at 6 of 52, mixtral-8x7b at 2 of 32 and
#: grok-1-314b at 1 of 64 (bf16 parameters and moments),
#: llama-3.2-vision-11b at 10 of 40 (two periods of 5: cross-attention at
#: layers 3 and 8; 8 x 2048 in 8 microbatches) and hubert-xlarge whole (16
#: x 2048 frames in 4).  Tokens from ``InputPipeline``, seed 0 (the vlm's
#: vision and the encoder's frames: ``make_lm_batch_fn``'s stub
#: embeddings).  ``plain_witness``: the run once more on the plain
#: attention route.
TRAIN = {"stablelm-3b": dict(depth=0, batch=8, grad_accum=4, steps=4),
         "falcon-mamba-7b": dict(depth=8, batch=2, grad_accum=2, steps=3),
         "qwen2.5-32b": dict(depth=4, batch=16, grad_accum=16, steps=2),
         "qwen2-72b": dict(depth=2, batch=16, grad_accum=16, steps=2),
         "granite-20b": dict(depth=6, batch=8, grad_accum=8, steps=2),
         "mixtral-8x7b": dict(depth=2, batch=8, grad_accum=8, steps=2),
         "grok-1-314b": dict(depth=1, batch=16, grad_accum=16, steps=2,
                             plain_witness=True),
         "llama-3.2-vision-11b": dict(depth=10, batch=8, grad_accum=8,
                                      steps=2),
         "hubert-xlarge": dict(depth=0, batch=16, grad_accum=4, steps=2)}
#: qwen2-72b's bf16 accumulator against an fp32 one from the same seed, at
#: this depth: at phase 5's 2 layers the fp32 accumulator's 2 more bytes a
#: parameter (7.9 GiB) would come on top of the bf16 run's peak of 63.8 GiB
#: on an NVIDIA H100 80GB HBM3 at 700 W, past the 70 GiB the others keep
#: under
ACCUM_DEPTH = 1
TRAIN_SEQ = 2048
#: step 0's loss against the initialised model's expected loss, within
#: this share of ln(vocab): the final norm (ones at init) gives each
#: position unit rms and head_w is drawn N(0, s^2), s its init scale
#: (0.02), so the logits are about N(0, s^2 * d_model) and the expected
#: loss ln(vocab) + s^2 * d_model / 2 (near-uniform at stablelm-3b's
#: d_model 2560: +0.51; qwen2-72b's 8192: +1.64)
LOSS0_RTOL = 0.10


def initial_loss(cfg) -> float:
    """The expected loss of ``cfg``'s initialised model (LOSS0_RTOL), with
    head_w's init scale from the model's parameter definitions."""
    from repro_torch.models import transformer as tf
    s = {path: scale for path, _, _, scale in tf._top_defs(cfg)}["head_w"]
    return float(np.log(cfg.vocab_size)) + s ** 2 * cfg.d_model / 2


def forward_calls(cfg) -> int:
    """The forward-kernel calls of one microbatch through ``forward_train``:
    one a layer (flash, or the scan on an ssm layer) and one more a
    cross-attention layer, whose batch carries vision in every run of this
    phase.  Each call's backward kernel runs once, its forward once more
    in the period's remat recompute."""
    return cfg.n_layers + sum(cfg.has_cross_attn(i)
                              for i in range(cfg.n_layers))


#: a second run from the same seed: every loss within this relative gap
#: (the step is deterministic unless an atomic adds in another order)
RERUN_RTOL = 1e-3
#: the resume check's parameters after the resumed steps, within this of
#: the uninterrupted run's (a checkpoint round trip is exact; the losses
#: must be equal)
RESUME_ATOL = 1e-6


def _grad_norms(cfg, params, batch):
    """(loss, per-leaf gradient norms, launches of the flash and scan
    forward kernels, launches of their backward kernels, the leaves'
    names) of one ``forward_train`` + backward.  Each layer of a stacked
    leaf is a leaf of its own, as ``train_step`` binds them, whose
    gradient a hook squares, sums and drops as it arrives: no gradient
    tree lives beside the parameters (grok-1's two layers hold 23 GB of
    bf16 parameters)."""
    from repro_torch.kernels import launch_counts, reset_launches
    from repro_torch.models import transformer as tf
    from repro_torch.train.optimizer import square_sum
    names, sums, handles = [], [], []

    def bind(p, slot):
        leaf = p.detach().requires_grad_(True)

        def take(t):
            sums[slot] += square_sum(t.grad)
            t.grad = None
        handles.append(leaf.register_post_accumulate_grad_hook(take))
        return leaf

    def walk(t, path):
        if isinstance(t, dict):
            return {k: walk(v, f"{path}.{k}" if path else k)
                    for k, v in t.items()}
        names.append(path)
        sums.append(torch.zeros((), dtype=torch.float32, device=t.device))
        if path.startswith("blocks."):
            return [bind(t[i], len(sums) - 1) for i in range(t.shape[0])]
        return bind(t, len(sums) - 1)
    leaves = walk(params, "")
    reset_launches()
    try:
        loss, _ = tf.forward_train(leaves, batch, cfg)
        loss.backward()
    finally:
        for h in handles:
            h.remove()
    torch.cuda.synchronize()
    counts = launch_counts()
    norms = torch.stack(sums).sqrt().cpu()
    return (loss.item(), norms, counts["flash_attention"],
            counts["mamba_scan"], counts["flash_attention_backward"]
            + counts["mamba_scan_backward"], names)


def train_route_check(arch: str, dev: torch.device) -> None:
    """One microbatch of the trained shape (seed 0's first block) through
    ``forward_train`` and its backward at ``arch``'s full width and the
    fewest layers past one that its period allows (``transformer.period``:
    2, a vlm's 5, one cross-attention layer): the kernel route (the forward and backward kernels)
    against the plain route, both in the compute dtype, with the fp32
    plain route as the yardstick.  Loss, global
    gradient norm and every leaf's gradient norm: the kernel route's
    relative gap to the yardstick must be no larger than twice the plain
    route's plus BF16_MARGIN (phase 4's rule).  A vlm's gates are first
    set from GATE_SEED, and each of its ``xattn`` leaves must get a
    gradient on the fp32 plain and the kernel route: at the initialised
    zero gates the branch passes none, and the per-leaf rule would pass
    on zeros."""
    from repro_torch.configs import get_config
    from repro_torch.data import (InputPipeline, PipelineConfig,
                                  make_lm_batch_fn)
    from repro_torch.launch.train import to_device
    from repro_torch.models import transformer as tf
    spec = TRAIN[arch]
    period = tf.period(get_config(arch))
    depth = -(-2 // period) * period
    cfg, params = make_model(arch, dev, depth)
    gates = set_gates(params) if cfg.family == "vlm" else []
    rows = spec["batch"] // spec["grad_accum"]
    blk = next(iter(InputPipeline(PipelineConfig(
        seq_len=TRAIN_SEQ, global_batch=rows, vocab_size=cfg.vocab_size,
        docs_per_window=512, seed=0))))
    batch = to_device(make_lm_batch_fn(cfg)(blk), dev)
    plain = dict(attn_impl="reference", ssm_impl="reference")
    truth = _grad_norms(cfg.replace(compute_dtype="float32", **plain),
                        params, batch)
    with expert_loads() as loads:
        kernel = _grad_norms(cfg, params, batch)
    ref = _grad_norms(cfg.replace(**plain), params, batch)
    launched, backward = kernel[2] + kernel[3], kernel[4]
    calls = forward_calls(cfg)
    if launched != 2 * calls or backward != calls or sum(
            ref[2:5] + truth[2:5]):
        raise AssertionError(f"{arch}: the kernel route launched {launched} "
                             f"forward and {backward} backward kernels, "
                             f"expected {2 * calls} (a call, forward and "
                             f"remat recompute; {calls} calls at depth "
                             f"{depth}) and {calls}; the plain routes must "
                             f"launch none")
    if gates:
        xattn = [(name, float(truth[1][i]), float(kernel[1][i]))
                 for i, name in enumerate(truth[5]) if ".xattn." in name]
        log(f"  {arch}: gates set from numpy seed {GATE_SEED}: "
            f"{', '.join(f'{g:.4f}' for g in gates)}; xattn grad norms "
            f"fp32 plain / kernel route: " + ", ".join(
                f"{name.split('.', 2)[-1]} {t:.4g} / {k:.4g}"
                for name, t, k in xattn))
        if not xattn or not all(t > 0 and k > 0 for _, t, k in xattn):
            raise AssertionError(f"{arch}: a cross-attention leaf got no "
                                 f"gradient: {xattn}")

    def gaps(run):
        loss_gap = abs(run[0] - truth[0]) / abs(truth[0])
        leaf = (run[1] - truth[1]).abs() / truth[1].clamp(min=1e-30)
        glob = abs(float(run[1].norm() - truth[1].norm())) / float(
            truth[1].norm())
        return loss_gap, glob, leaf
    k_loss, k_glob, k_leaf = gaps(kernel)
    p_loss, p_glob, p_leaf = gaps(ref)
    worst = int(torch.argmax(k_leaf - 2 * p_leaf))
    log(f"  {arch}: train route check, {rows} x {TRAIN_SEQ} tokens at depth "
        f"{depth}: fp32 plain loss {truth[0]:.6f}, global grad norm "
        f"{float(truth[1].norm()):.6g}; {cfg.compute_dtype} kernel route "
        f"rel gaps loss {k_loss:.3g} global {k_glob:.3g} worst leaf "
        f"{float(k_leaf.max()):.3g}; {cfg.compute_dtype} plain route "
        f"{p_loss:.3g} / {p_glob:.3g} / {float(p_leaf.max()):.3g}; "
        f"{len(k_leaf)} leaves, nearest the rule {kernel[5][worst]} "
        f"({float(k_leaf[worst]):.3g} against {float(p_leaf[worst]):.3g}); "
        f"kernel launches {launched} forward, "
        f"{backward} backward (rule: kernel <= 2 x plain + {BF16_MARGIN})"
        f"{f'; {loads.summary()}' if loads.layers else ''}")
    bad = [(name, k, p) for name, k, p in (
        ("loss", k_loss, p_loss), ("global grad norm", k_glob, p_glob),
        (f"{kernel[5][worst]} grad norm", float(k_leaf[worst]),
         float(p_leaf[worst]))) if k > 2 * p + BF16_MARGIN]
    if bad:
        raise AssertionError(f"{arch}: kernel route beyond the plain "
                             f"route's margin: {bad}")
    del params
    torch.cuda.empty_cache()


def _function_times(arch: str, cfg, dev: torch.device) -> dict:
    """At one microbatch's shapes of the trained model (CUDA events, the
    median of 5): the forward kernel, the Function's backward (the
    backward kernel) and the plain backward on the same saved values.
    Flash at the model's own causality, window and softcap; a vlm's
    cross-attention too (``cross_*``: the text queries against its
    vision tokens, non-causal, no window)."""
    from repro_torch.kernels.flash_attention import (
        flash_attention, flash_attention_backward_ref)
    from repro_torch.kernels.mamba_scan import (mamba_scan,
                                                mamba_scan_backward_ref)
    spec = TRAIN[arch]
    rows, S = spec["batch"] // spec["grad_accum"], TRAIN_SEQ
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    bf16 = torch.bfloat16

    def timed(what, shape, ins, fwd, plain):
        leaves = [t.requires_grad_(True) for t in ins]
        with torch.no_grad():
            fwd_ms = time_ms(lambda: fwd(*leaves), iters=5, warmup=1)
        out = fwd(*leaves)
        g = torch.ones_like(out)

        def backward():
            torch.autograd.grad(out, leaves, g, retain_graph=True)
        bwd_ms = time_ms(backward, iters=5, warmup=1)
        saved = [t.detach() for t in out.grad_fn.saved_tensors]
        plain_ms = time_ms(lambda: plain(saved, g), iters=3, warmup=1)
        log(f"  {arch}: {what} at one microbatch ({shape}): forward kernel "
            f"{fwd_ms:.4f} ms, the Function's backward (the backward "
            f"kernel) {bwd_ms:.4f} ms, the plain backward {plain_ms:.4f} ms")
        return {"forward_ms": fwd_ms, "backward_ms": bwd_ms,
                "plain_backward_ms": plain_ms}

    def flash(what, Skv, **kw):
        kh, hd = cfg.n_kv_heads, cfg.hd
        G = cfg.n_heads // kh
        ins = [torch.randn(s, generator=gen, device=dev).to(bf16)
               for s in ((rows, S, kh, G, hd), (rows, Skv, kh, hd),
                         (rows, Skv, kh, hd))]
        return timed(
            what, f"[{rows}, {S}, {kh}, {G}, {hd}] against {Skv} keys, "
            f"bf16, causal {kw['causal']}, window {kw['window']}, softcap "
            f"{kw['softcap']}", ins,
            lambda *a: flash_attention(*a, impl="cuda", **kw),
            lambda saved, g: flash_attention_backward_ref(*saved, g, **kw))

    if cfg.family == "ssm":
        d, N = cfg.d_inner, cfg.ssm_state
        ins = list(_scan_inputs(gen, rows, S, d, N, True, bf16))
        return timed("scan", f"Bt {rows}, T {S}, d {d}, N {N}, bf16 "
                     f"delta/x", ins,
                     lambda *a: mamba_scan(*a, impl="cuda")[0],
                     lambda saved, g: mamba_scan_backward_ref(
                         *saved, g, torch.zeros_like(ins[5])))
    times = flash("flash", S, causal=cfg.causal, window=cfg.sliding_window,
                  softcap=cfg.logit_softcap)
    if cfg.family == "vlm":
        cross = flash("flash's cross-attention", cfg.n_vision_tokens,
                      causal=False, window=0, softcap=cfg.logit_softcap)
        times.update({f"cross_{k}": v for k, v in cross.items()})
    return times


def _step_breakdown(cfg, params, batch) -> dict:
    """One microbatch's forward and backward (host clock, synchronised)
    on the trained parameters."""
    from repro_torch.models import transformer as tf
    from repro_torch.train.optimizer import tree_leaves
    m = cfg.grad_accum
    mb = {k: v[:v.shape[0] // m] for k, v in batch.items()}
    for t in tree_leaves(params):
        t.requires_grad_(True)
    times = []
    for _ in range(2):                   # the first one warms the caches
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss, _ = tf.forward_train(params, mb, cfg)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        loss.backward()
        torch.cuda.synchronize()
        times.append((t1 - t0, time.perf_counter() - t1))
        for t in tree_leaves(params):
            t.grad = None
    for t in tree_leaves(params):
        t.requires_grad_(False)
    fwd, bwd = times[-1]
    return {"forward_s": fwd, "backward_s": bwd}


def train_model(arch: str, dev: torch.device, profile: bool = False):
    """``arch`` (TRAIN) through ``launch.train.train_loop`` twice from seed
    0: finite losses, step 0 near the initialised model's expected loss
    (``initial_loss``), the forward kernel launched once a call
    (``forward_calls``) a microbatch in the forward and once more in the
    remat recompute, the backward kernel once a call a microbatch, the
    second run's losses within RERUN_RTOL (and whether they are
    bit-identical).  Prints step ms, tokens/s, 6·N·tokens / step time
    against the bf16 peak (N the parameters a token runs through) and the
    peak memory; then the forward/backward split of a microbatch and the
    Function's kernels and the plain backward at a microbatch's shapes.
    Returns (the forward kernel's launches in the two runs, the backward
    kernel's, the Function times)."""
    from repro_torch.configs import get_config
    from repro_torch.data import (InputPipeline, PipelineConfig,
                                  make_lm_batch_fn)
    from repro_torch.kernels import launch_counts, reset_launches
    from repro_torch.launch.train import to_device, train_loop
    from repro_torch.models import transformer as tf
    from repro_torch.train.optimizer import tree_leaves
    spec = TRAIN[arch]
    full = get_config(arch)
    cfg = full.replace(n_layers=spec["depth"] or full.n_layers,
                       grad_accum=spec["grad_accum"])
    kernel = "mamba_scan" if cfg.family == "ssm" else "flash_attention"
    backward = f"{kernel}_backward"
    n, n_active = tf.param_count(cfg), cfg.active_param_count()
    n_leaves = sum(1 for t in tree_leaves(tf.param_shapes(cfg))
                   if t.numel())
    tokens = spec["batch"] * TRAIN_SEQ
    calls = forward_calls(cfg)
    per_step = calls * cfg.grad_accum * 2
    depth = (f"{cfg.n_layers} of {full.n_layers} layers, " if spec["depth"]
             else "whole, ")
    size = lambda name: torch.empty((), dtype=getattr(torch, name)
                                    ).element_size()
    acc = cfg.grad_accum_dtype or cfg.opt_state_dtype
    state = n * (size(cfg.param_dtype) + size(acc)
                 + 2 * size(cfg.opt_state_dtype))
    active = (f", {n_active / 1e9:.3f}B a token" if n_active != n else "")
    log(f"{arch}: training {depth}{n / 1e9:.3f}B {cfg.param_dtype} params"
        f"{active} (+ a {acc} accumulator, + AdamW m/v in "
        f"{cfg.opt_state_dtype}: {state / 2**30:.1f} GiB), compute "
        f"{cfg.compute_dtype}, remat {cfg.remat_policy}, global batch "
        f"{spec['batch']} x {TRAIN_SEQ} in {cfg.grad_accum} microbatches, "
        f"{spec['steps']} steps, {calls} {kernel} calls a microbatch; "
        f"card: {card_line()}")
    if cfg.family == "vlm":
        log(f"  {arch}: train_loop keeps the initialised zero gates (as the "
            f"reference's): at step 0 tanh(0) passes the cross-attention no "
            f"gradient, so its backward kernel runs on a gradient of about "
            f"zero there. Not a check of the branch; the route check, with "
            f"the gates set, is")
    runs, launches, bwd_launches, res = [], 0, 0, None
    torch.cuda.synchronize()
    reset_launches()
    for attempt in (1, 2):
        res = None
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        before = launch_counts()
        t = time.perf_counter()
        res = train_loop(cfg, steps=spec["steps"], batch=spec["batch"],
                         seq_len=TRAIN_SEQ, log_every=1, seed=0, device=dev)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        after = launch_counts()
        launched = after[kernel] - before[kernel]
        launched_bwd = after[backward] - before[backward]
        losses, step_s = res["losses"], res["step_seconds"]
        if launched != per_step * spec["steps"]:
            raise AssertionError(f"{arch}#{attempt}: {kernel} launched "
                                 f"{launched} times, expected {per_step} a "
                                 f"step ({calls} calls (forward_calls) x "
                                 f"{cfg.grad_accum} microbatches x 2: the "
                                 f"forward and the remat recompute) x "
                                 f"{spec['steps']}")
        if launched_bwd != per_step // 2 * spec["steps"]:
            raise AssertionError(f"{arch}#{attempt}: {backward} launched "
                                 f"{launched_bwd} times, expected "
                                 f"{per_step // 2} a step ({calls} calls x "
                                 f"{cfg.grad_accum} microbatches) x "
                                 f"{spec['steps']}")
        updates = after["adamw_update"] - before["adamw_update"]
        sums = after["adamw_square_sum"] - before["adamw_square_sum"]
        if (updates, sums) != (n_leaves * spec["steps"],
                               (n_leaves + 1) * spec["steps"]):
            raise AssertionError(f"{arch}#{attempt}: AdamW launched "
                                 f"{updates} updates and {sums} norm "
                                 f"kernels, expected {n_leaves} and "
                                 f"{n_leaves + 1} a step ({n_leaves} "
                                 f"leaves, one sum) x {spec['steps']}")
        if not all(np.isfinite(losses)):
            raise AssertionError(f"{arch}#{attempt}: losses {losses}")
        ln_v, loss0 = float(np.log(cfg.vocab_size)), initial_loss(cfg)
        if abs(losses[0] - loss0) > LOSS0_RTOL * ln_v:
            raise AssertionError(f"{arch}#{attempt}: step 0's loss "
                                 f"{losses[0]:.4f} is not within "
                                 f"{LOSS0_RTOL:.0%} of ln({cfg.vocab_size})"
                                 f" = {ln_v:.4f} of the expected "
                                 f"{loss0:.4f}")
        steady = statistics.median(step_s[1:])
        log(f"  {arch}#{attempt}: {spec['steps']} steps in {wall:.2f}s "
            f"(set-up included); losses "
            f"{', '.join(f'{x:.6f}' for x in losses)} (ln V = {ln_v:.4f}, "
            f"expected at step 0 {loss0:.4f}); "
            f"step ms {', '.join(f'{s * 1e3:.1f}' for s in step_s)}; "
            f"steady step {steady * 1e3:.1f} ms, {tokens / steady:.0f} "
            f"tok/s, 6*N*tokens/step = "
            f"{6 * n_active * tokens / steady / 1e12:.1f} TFLOP/s = "
            f"{6 * n_active * tokens / steady / PEAK_BF16_S:.4f} of the "
            f"989 TFLOP/s bf16 peak; {kernel} launches={launched} "
            f"({per_step} a step), {backward} launches={launched_bwd} "
            f"({per_step // 2} a step); peak device memory "
            f"{torch.cuda.max_memory_allocated() / 2**30:.1f} GiB; card: "
            f"{card_line()}")
        runs.append(losses)
        launches += launched
        bwd_launches += launched_bwd
        peak_gib = torch.cuda.max_memory_allocated() / 2**30
    same_losses = runs[0] == runs[1]
    gap = max(abs(a - b) / abs(b) for a, b in zip(*runs))
    log(f"  {arch}: second run's losses "
        f"{'bit-identical' if same_losses else f'max rel gap {gap:.3g}'} "
        f"(tolerance {RERUN_RTOL})")
    if gap > RERUN_RTOL:
        raise AssertionError(f"{arch}: the second run's losses differ by "
                             f"{gap:.3g}")
    params, opt = res["params"], res["opt_state"]
    del res
    blk = next(iter(InputPipeline(PipelineConfig(
        seq_len=TRAIN_SEQ, global_batch=spec["batch"],
        vocab_size=cfg.vocab_size, docs_per_window=max(spec["batch"] * 16,
                                                      512), seed=0))))
    batch = to_device(make_lm_batch_fn(cfg)(blk), dev)
    if profile:
        from repro_torch.train.optimizer import OptConfig
        from repro_torch.train.train_step import make_train_step
        step = make_train_step(cfg, OptConfig())
        step(params, opt, batch)                        # warm
        profile_device(f"{arch} train step ({spec['batch']} x {TRAIN_SEQ}, "
                       f"{cfg.grad_accum} microbatches)",
                       lambda: step(params, opt, batch))
    del opt
    torch.cuda.empty_cache()
    split = _step_breakdown(cfg, params, batch)
    fwd, bwd = split["forward_s"], split["backward_s"]
    log(f"  {arch}: one microbatch ({spec['batch'] // cfg.grad_accum} x "
        f"{TRAIN_SEQ}): forward {fwd * 1e3:.1f} ms, backward (the remat "
        f"recompute included) {bwd * 1e3:.1f} ms; backward share "
        f"{bwd / (fwd + bwd):.4f}; {cfg.grad_accum} microbatches = "
        f"{cfg.grad_accum * (fwd + bwd) * 1e3:.1f} ms of the "
        f"{steady * 1e3:.1f} ms step, the rest AdamW and the host")
    del params, batch
    torch.cuda.empty_cache()
    if spec.get("plain_witness"):
        plain_witness(arch, cfg, runs[0], dev)
    fn = _function_times(arch, cfg, dev)
    # a step's ms at each shape: the layers' calls, the cross-attention's
    n_cross = calls - cfg.n_layers
    a_step = {k: (cfg.n_layers * fn[k] + n_cross * fn.get(f"cross_{k}", 0))
              * cfg.grad_accum for k in ("forward_ms", "backward_ms",
                                         "plain_backward_ms")}
    log(f"  {arch}: the backward kernel, {calls * cfg.grad_accum} calls a "
        f"step: {a_step['backward_ms']:.1f} ms = "
        f"{a_step['backward_ms'] / (steady * 1e3):.4f} of the step (the "
        f"forward kernel {2 * a_step['forward_ms']:.1f} ms over "
        f"{2 * calls * cfg.grad_accum} launches; the plain backward would "
        f"take {a_step['plain_backward_ms']:.1f} ms)")
    fn.update(step_ms=steady * 1e3, backward_share=bwd / (fwd + bwd),
              function_backward_share=a_step["backward_ms"]
              / (steady * 1e3),
              peak_gib=peak_gib)
    torch.cuda.empty_cache()
    return launches, bwd_launches, fn


def plain_witness(arch: str, cfg, kernel_losses: list,
                  dev: torch.device) -> None:
    """``cfg`` (``train_model``'s) through ``train_loop`` once more from
    seed 0 on the plain attention route (the reference function and its
    autograd backward; no flash kernel may launch), in the same dtypes:
    step 0's loss comes before any update, step 1's after the first
    AdamW step on the plain route's gradients, so it shows the update
    moving the weights as the kernel route's did.  Each loss's relative
    gap to the kernel route's ``kernel_losses`` within BF16_MARGIN
    (phase 4's margin; no fp32 yardstick at this size: an fp32 copy of
    one grok-1 layer's experts alone is 19 GiB beside 52 GiB of state)."""
    from repro_torch.kernels import launch_counts
    from repro_torch.launch.train import train_loop
    spec = TRAIN[arch]
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    before = launch_counts()
    t = time.perf_counter()
    res = train_loop(cfg.replace(attn_impl="reference"),
                     steps=spec["steps"], batch=spec["batch"],
                     seq_len=TRAIN_SEQ, log_every=spec["steps"], seed=0,
                     device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    after = launch_counts()
    launched = sum(after[k] - before[k] for k in (
        "flash_attention", "flash_attention_backward"))
    losses, step_s = res["losses"], res["step_seconds"]
    del res
    torch.cuda.empty_cache()
    gaps = [abs(a - b) / abs(b) for a, b in zip(losses, kernel_losses)]
    log(f"  {arch}: plain attention route, {spec['steps']} steps in "
        f"{wall:.2f}s: losses {', '.join(f'{x:.6f}' for x in losses)} "
        f"against the kernel route's "
        f"{', '.join(f'{x:.6f}' for x in kernel_losses)}: rel gap a step "
        f"{', '.join(f'{g:.3g}' for g in gaps)} (tolerance {BF16_MARGIN}); "
        f"step ms {', '.join(f'{x * 1e3:.1f}' for x in step_s)}; peak "
        f"device memory {torch.cuda.max_memory_allocated() / 2**30:.1f} "
        f"GiB; flash launches {launched}; card: {card_line()}")
    if launched or not all(np.isfinite(losses)) or max(gaps) > BF16_MARGIN:
        raise AssertionError(f"{arch}: the plain route's losses {losses} "
                             f"(flash launches {launched}) against the "
                             f"kernel route's {kernel_losses}")


def train_resume(dev: torch.device) -> None:
    """stablelm-3b's smoke config on the card: 4 steps straight, against 2
    steps saved by ``CheckpointManager`` and 2 more resumed from it into a
    fresh state (``train_loop(..., resume=True)``, one schedule).  The
    resumed steps' losses must equal the uninterrupted run's exactly and
    their parameters be within RESUME_ATOL."""
    import tempfile
    from repro_torch.configs import get_config
    from repro_torch.launch.train import train_loop
    from repro_torch.train.checkpoint import latest_step
    from repro_torch.train.optimizer import OptConfig, tree_leaves
    cfg = get_config("stablelm-3b", smoke=True)
    kw = dict(batch=8, seq_len=256, log_every=100, device=dev,
              ocfg=OptConfig(lr=1e-2, warmup_steps=1, total_steps=4))
    whole = train_loop(cfg, steps=4, **kw)
    with tempfile.TemporaryDirectory() as d:
        first = train_loop(cfg, steps=2, ckpt_dir=d, ckpt_every=2, **kw)
        saved = latest_step(d)
        rest = train_loop(cfg, steps=4, ckpt_dir=d, resume=True, **kw)
    gap = max(float((a.float() - b.float()).abs().max()) for a, b in zip(
        tree_leaves(rest["params"]), tree_leaves(whole["params"])))
    log(f"  {cfg.name} (smoke, 8 x 256, grad_accum {cfg.grad_accum}): "
        f"uninterrupted losses {whole['losses']}; saved at step {saved}, "
        f"resumed {rest['steps_done']} steps: {rest['losses']}; params max "
        f"abs gap {gap:.3g} (tolerance {RESUME_ATOL})")
    if first["losses"] != whole["losses"][:2] or \
            rest["losses"] != whole["losses"][2:]:
        raise AssertionError("resume: the losses differ from the "
                             "uninterrupted run's")
    if saved != 2 or rest["steps_done"] != 2 or gap > RESUME_ATOL:
        raise AssertionError(f"resume: saved {saved}, resumed "
                             f"{rest['steps_done']} steps, params gap {gap}")


def accumulator_gap(arch: str, dev: torch.device, depth: int) -> None:
    """``arch`` at ``depth`` layers through ``train_loop`` twice from seed
    0, with its own (bf16) gradient accumulator and with an fp32 one: the
    losses' largest relative gap, logged beside each run's peak memory.
    Step 0's loss comes before any update and must agree within
    RERUN_RTOL; the later ones carry the rounding of the accumulated sums
    (a finding, not a gate)."""
    from repro_torch.configs import get_config
    from repro_torch.launch.train import train_loop
    spec = TRAIN[arch]
    cfg = get_config(arch).replace(n_layers=depth,
                                   grad_accum=spec["grad_accum"])
    runs = {}
    for acc in (cfg.grad_accum_dtype, "float32"):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        res = train_loop(cfg.replace(grad_accum_dtype=acc),
                         steps=spec["steps"], batch=spec["batch"],
                         seq_len=TRAIN_SEQ, log_every=spec["steps"], seed=0,
                         device=dev)
        runs[acc] = res["losses"]
        log(f"  {arch} at {depth} of {get_config(arch).n_layers} layers, a "
            f"{acc} accumulator over {cfg.grad_accum} microbatches: losses "
            f"{', '.join(f'{x:.6f}' for x in res['losses'])}; steps ms "
            f"{', '.join(f'{x * 1e3:.1f}' for x in res['step_seconds'])}; "
            f"peak device memory "
            f"{torch.cuda.max_memory_allocated() / 2**30:.1f} GiB")
        del res
    low, full = runs.values()
    gaps = [abs(a - b) / abs(b) for a, b in zip(low, full)]
    log(f"  {arch}: {cfg.grad_accum_dtype} against fp32 accumulator, loss "
        f"rel gap a step {', '.join(f'{g:.3g}' for g in gaps)}; card: "
        f"{card_line()}")
    if gaps[0] > RERUN_RTOL:
        raise AssertionError(f"{arch}: step 0's loss depends on the "
                             f"accumulator ({low[0]} against {full[0]})")
    torch.cuda.empty_cache()


def flash_trained() -> list:
    """TRAIN's configs that train on the flash kernels (every family but
    'ssm'), stablelm-3b first."""
    from repro_torch.configs import get_config
    return [arch for arch in TRAIN if get_config(arch).family != "ssm"]


#: the kernels line's fields (``train_<key>_*``) for these configs' flash
#: Function times, beside stablelm-3b's (``train_*``)
TRAIN_FIELDS = {"llama-3.2-vision-11b": "vlm", "hubert-xlarge": "hubert"}


def phase_train(dev: torch.device, profile: bool) -> dict:
    """Phase 5: the gradient route checks, stablelm-3b whole and
    falcon-mamba-7b at 8 layers through ``train_loop``, then the other
    ``flash_trained`` configs (each its route check, then ``train_loop``;
    grok-1-314b's plain-route witness), qwen2-72b's accumulator
    against an fp32 one, the resume check.  Returns each kernel's
    launches in the training runs (forward and backward kernels) and
    the Function times for the kernels line: stablelm-3b's and falcon's,
    and the vlm's (self- and cross-attention) and hubert's under
    TRAIN_FIELDS' keys."""
    t0 = time.perf_counter()
    train_route_check("stablelm-3b", dev)
    train_route_check("falcon-mamba-7b", dev)
    flash, flash_bwd, flash_fn = train_model("stablelm-3b", dev, profile)
    scan, scan_bwd, scan_fn = train_model("falcon-mamba-7b", dev, profile)
    for arch in flash_trained()[1:]:
        t1 = time.perf_counter()
        train_route_check(arch, dev)
        n, n_bwd, fn = train_model(arch, dev, profile)
        flash, flash_bwd = flash + n, flash_bwd + n_bwd
        if arch in TRAIN_FIELDS:
            flash_fn[TRAIN_FIELDS[arch]] = fn
        log(f"  {arch}: route check and training in "
            f"{time.perf_counter() - t1:.1f}s")
    accumulator_gap("qwen2-72b", dev, ACCUM_DEPTH)
    train_resume(dev)
    log(f"training phase wall: {time.perf_counter() - t0:.1f}s")
    return {"flash_attention": (flash, flash_fn),
            "flash_attention_backward": (flash_bwd, {}),
            "mamba_scan": (scan, scan_fn),
            "mamba_scan_backward": (scan_bwd, {})}


# ---------------------------------------------------------------------------
#  Phase 6: sharded training and serving
# ---------------------------------------------------------------------------
#: the sharded step against the unsharded one on a 1x1 nccl mesh:
#: stablelm-3b whole, phase 5's batch (8 x 2048 in 4 microbatches), 2 steps
SHARD_TRAIN = dict(batch=8, grad_accum=4, steps=2)
#: loss and global grad norm of the two steps within this relative gap (a
#: 1x1 mesh runs every op on the whole tensor, as the unsharded step does)
SHARD_RTOL = 1e-6
#: the serving check: one wave of 4 x 2048 prompts, then decode steps
SHARD_SERVE = dict(batch=4, prompt_len=2048, decode_steps=4)


def _rel(a: float, b: float) -> float:
    return abs(a - b) / max(abs(b), 1e-30)


def _two_steps(step, params, opt, batches):
    """(losses, grad norms, step seconds) of ``step`` over ``batches``."""
    losses, norms, secs = [], [], []
    for b in batches:
        torch.cuda.synchronize()
        t = time.perf_counter()
        params, opt, m = step(params, opt, b)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t)
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    return losses, norms, secs


@torch.no_grad()
def _serve_logits(prefill, decode, params, cfg, toks, steps):
    """Logits of a prefill of all but ``steps`` tokens, then of a decode
    step a token, whole, on the host."""
    from repro_torch.models import transformer as tf
    from repro_torch.train.sharding import full
    S = toks.shape[1]
    lg, cache = prefill(params, {"tokens": toks[:, :S - steps]})
    out = [full(lg).float().cpu()]
    cache = tf.grow_cache(cache, cfg, S)
    for t in range(S - steps, S):
        lg, cache = decode(params, cache, {"tokens": toks[:, t:t + 1]})
        out.append(full(lg).float().cpu())
    del cache
    return out


def phase_sharded_lm(dev: torch.device, backend: str = "nccl") -> int:
    """Phase 6: ``sharded_train_step`` and ``sharded_serve_steps`` on a 1x1
    ``nccl`` mesh with the real ``make_rules`` (profiles train, then
    prefill and decode), stablelm-3b whole: two train steps of phase 5's
    batch against the unsharded ``make_train_step`` from the same seed
    (loss and global grad norm within SHARD_RTOL, bit-identity reported,
    step ms of both), then a 4 x 2048 prefill and decode steps against the
    unsharded serve steps on the same weights.  Returns the flash
    launches of the sharded runs, counted from 0 just before them, by
    kernel (forward, backward)."""
    import torch.distributed as dist
    from repro_torch.configs import get_config
    from repro_torch.data import (InputPipeline, PipelineConfig,
                                  make_lm_batch_fn)
    from repro_torch.kernels import launch_counts, reset_launches
    from repro_torch.launch.mesh import init_distributed, make_host_mesh
    from repro_torch.launch.train import build_state, sharded_setup, to_device
    from repro_torch.models import transformer as tf
    from repro_torch.train.optimizer import OptConfig, tree_map
    from repro_torch.train.serve_step import (make_serve_steps,
                                              sharded_serve_steps)
    from repro_torch.train.sharding import local, make_rules
    from repro_torch.train.train_step import (make_train_step,
                                              sharded_train_step)
    from repro_torch.launch.specs import limit_specs_tree
    t0 = time.perf_counter()
    spec = SHARD_TRAIN
    cfg = get_config("stablelm-3b").replace(grad_accum=spec["grad_accum"])
    ocfg = OptConfig(total_steps=10, warmup_steps=1)
    blocks = iter(InputPipeline(PipelineConfig(
        seq_len=TRAIN_SEQ, global_batch=spec["batch"],
        vocab_size=cfg.vocab_size, docs_per_window=max(spec["batch"] * 16,
                                                      512), seed=0)))
    batches = [to_device(make_lm_batch_fn(cfg)(next(blocks)), dev)
               for _ in range(spec["steps"])]
    backend = init_distributed(backend, dev.type)
    mesh = make_host_mesh(1, 1, device=dev.type)
    log(f"stablelm-3b sharded on a 1x1 {backend} mesh {mesh} (world "
        f"{dist.get_world_size()}): {spec['steps']} steps of "
        f"{spec['batch']} x {TRAIN_SEQ} in {spec['grad_accum']} "
        f"microbatches; card: {card_line()}")
    try:
        params, opt = build_state(cfg, 0, dev)
        plain = _two_steps(make_train_step(cfg, ocfg), params, opt, batches)
        del params, opt
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        scfg, rules, p_specs, b_specs = sharded_setup(
            cfg, mesh, spec["batch"], TRAIN_SEQ)
        params, opt = build_state(scfg, 0, dev, mesh, p_specs)
        reset_launches()
        sharded = _two_steps(sharded_train_step(scfg, ocfg, rules, p_specs,
                                                b_specs, mesh),
                             params, opt, batches)
        torch.cuda.synchronize()
        launches = launch_counts()["flash_attention"]
        bwd_launches = launch_counts()["flash_attention_backward"]
        peak = torch.cuda.max_memory_allocated() / 2**30
        del opt
        torch.cuda.empty_cache()
        per_step = cfg.n_layers * cfg.grad_accum * 2
        gaps = [_rel(a, b) for a, b in zip(sharded[0] + sharded[1],
                                           plain[0] + plain[1])]
        same = sharded[0] == plain[0] and sharded[1] == plain[1]
        log(f"  train: unsharded losses {plain[0]} grad norms {plain[1]} "
            f"step ms {[round(x * 1e3, 1) for x in plain[2]]}; sharded "
            f"losses {sharded[0]} grad norms {sharded[1]} step ms "
            f"{[round(x * 1e3, 1) for x in sharded[2]]} (difference on "
            f"the second step: {(sharded[2][-1] - plain[2][-1]) * 1e3:+.1f}"
            f" ms, not attributed); max rel gap {max(gaps):.3g} (tolerance "
            f"{SHARD_RTOL}); "
            f"{'bit-identical' if same else 'not bit-identical'}; flash "
            f"launches {launches} ({per_step} a step), backward "
            f"{bwd_launches} ({per_step // 2} a step); peak "
            f"{peak:.1f} GiB; rules {rules.mapping}")
        if max(gaps) > SHARD_RTOL:
            raise AssertionError(f"sharded train step: gap {max(gaps):.3g} "
                                 f"to the unsharded step")
        if launches != per_step * spec["steps"] or \
                bwd_launches != per_step // 2 * spec["steps"]:
            raise AssertionError(f"sharded train step: {launches} flash and "
                                 f"{bwd_launches} backward launches, "
                                 f"expected {per_step} and "
                                 f"{per_step // 2} a step")

        sv = SHARD_SERVE
        toks = torch.from_numpy(np.random.default_rng(0).integers(
            2, cfg.vocab_size, (sv["batch"], sv["prompt_len"]
                                + sv["decode_steps"]))).to(dev)
        whole = tree_map(local, params)           # the same memory
        want = _serve_logits(*make_serve_steps(scfg), whole, scfg, toks,
                             sv["decode_steps"])
        pre_rules = make_rules(mesh, "prefill", scfg)
        dec_rules = make_rules(mesh, "decode", scfg)
        specs = limit_specs_tree(tf.param_specs(scfg, dec_rules),
                                 tf.param_shapes(scfg), mesh)
        total = toks.shape[1]
        prefill = sharded_serve_steps(scfg, pre_rules, specs, mesh,
                                      sv["batch"], total)[0]
        decode = sharded_serve_steps(scfg, dec_rules, specs, mesh,
                                     sv["batch"], total)[1]
        before = launch_counts()["flash_attention"]
        torch.cuda.synchronize()
        t = time.perf_counter()
        got = _serve_logits(prefill, decode, params, scfg, toks,
                            sv["decode_steps"])
        serve_s = time.perf_counter() - t
        served = launch_counts()["flash_attention"] - before
        gaps = [float((g - w).abs().max() / w.abs().max())
                for g, w in zip(got, want)]
        same = all(torch.equal(g, w) for g, w in zip(got, want))
        log(f"  serve: a {sv['batch']} x {sv['prompt_len']} prefill and "
            f"{sv['decode_steps']} decode steps, sharded against unsharded "
            f"on the same weights: max rel logit gap {max(gaps):.3g} "
            f"(tolerance {SHARD_RTOL}); "
            f"{'bit-identical' if same else 'not bit-identical'}; "
            f"{serve_s:.2f}s; flash launches {served} "
            f"({cfg.n_layers} a prefill, none in decode)")
        if max(gaps) > SHARD_RTOL or served != cfg.n_layers:
            raise AssertionError(f"sharded serving: gap {max(gaps):.3g}, "
                                 f"{served} flash launches")
        del params, whole
        torch.cuda.empty_cache()
        log(f"sharded phase wall: {time.perf_counter() - t0:.1f}s")
        return {"flash_attention": launches + served,
                "flash_attention_backward": bwd_launches}
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
#  Phase 7: the dry run
# ---------------------------------------------------------------------------
#: 7(a): the traced step's peak against the card's within this range, its
#: FLOPs against FlopCounterMode over the real step within DRYRUN_FLOPS_RTOL
DRYRUN_PEAK_RANGE = (0.8, 1.25)
DRYRUN_FLOPS_RTOL = 0.01
#: 7(b): production cells traced on the fake process group, each in a
#: process of its own (arch, shape, multi-pod)
DRYRUN_CELLS = (("stablelm-3b", "train_4k", False),
                ("mixtral-8x7b", "decode_32k", True),
                ("falcon-mamba-7b", "prefill_32k", False))
DRYRUN_CELL_PROG = """
import json, sys
from repro_torch.launch.dryrun import run_cell
rec = run_cell(sys.argv[1], sys.argv[2], multi_pod=sys.argv[3] == "1",
               verbose=False, save=False)
print("DRYRUN_RECORD " + json.dumps(rec))
"""


def start_dryrun_cells() -> list:
    """Phase 7(b)'s processes, started before 7(a) so that they trace on
    the host's cores while the card runs."""
    env = {**os.environ, "PYTHONPATH": os.path.join(ROOT, "src")}
    return [(cell, subprocess.Popen(
        [sys.executable, "-c", DRYRUN_CELL_PROG, cell[0], cell[1],
         "1" if cell[2] else "0"], stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True, env=env, cwd=ROOT))
        for cell in DRYRUN_CELLS]


def _dryrun_terms(r: dict) -> str:
    return (f"t_compute {r['t_compute_s'] * 1e3:.2f} ms, t_memory "
            f"{r['t_memory_s'] * 1e3:.2f} ms, t_collective "
            f"{r['t_collective_s'] * 1e3:.2f} ms, bottleneck "
            f"{r['bottleneck']}, useful {r['useful_flops_fraction']:.4f}, "
            f"roofline {r['roofline_fraction']:.4f}")


def phase_dryrun(dev: torch.device, procs: list) -> int:
    """Phase 7.  (a) phase 5's stablelm-3b step (8 x 2048 in 4
    microbatches, fp32 state) traced on meta tensors at a world of one
    (``launch.dryrun.trace_step``), then run on the card from seed 0 under
    ``FlopCounterMode``: the traced params and opt state bytes must equal
    the card's exactly, the traced peak lie within DRYRUN_PEAK_RANGE of
    ``torch.cuda.max_memory_allocated`` over the step, and the traced
    FLOPs within DRYRUN_FLOPS_RTOL of the counted ones.  (b) the
    DRYRUN_CELLS, traced on the fake process group at 256 or 512 ranks in
    ``procs`` (``start_dryrun_cells``), one line a cell.  Returns the
    flash launches of the real step, counted from 0 just before it, by
    kernel (forward, backward)."""
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data import (InputPipeline, PipelineConfig,
                                  make_lm_batch_fn)
    from repro_torch.kernels import launch_counts, reset_launches
    from repro_torch.launch.dryrun import record, trace_step
    from repro_torch.launch.train import build_state, to_device
    from repro_torch.train.optimizer import OptConfig, tree_leaves
    from repro_torch.train.train_step import make_train_step
    t0 = time.perf_counter()
    spec = TRAIN["stablelm-3b"]
    cfg = get_config("stablelm-3b").replace(grad_accum=spec["grad_accum"])
    shape = ShapeConfig("phase5", TRAIN_SEQ, spec["batch"], "train",
                        grad_accum=spec["grad_accum"])
    res = trace_step(cfg, shape)
    rec = record(res, cfg, shape, 1)
    mem, roof = rec["memory"], rec["roofline"]

    blocks = iter(InputPipeline(PipelineConfig(
        seq_len=TRAIN_SEQ, global_batch=spec["batch"],
        vocab_size=cfg.vocab_size, docs_per_window=max(spec["batch"] * 16,
                                                      512), seed=0)))
    batch = to_device(make_lm_batch_fn(cfg)(next(blocks)), dev)
    params, opt = build_state(cfg, 0, dev)
    state = sum(t.numel() * t.element_size()
                for t in tree_leaves(params) + tree_leaves(opt))
    step = make_train_step(cfg, OptConfig(total_steps=10, warmup_steps=1))
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t = time.perf_counter()
    with FlopCounterMode(display=False) as fc:
        params, opt, metrics = step(params, opt, batch)
        loss = float(metrics["loss"])
    torch.cuda.synchronize()
    step_s = time.perf_counter() - t
    launches = launch_counts()["flash_attention"]
    bwd_launches = launch_counts()["flash_attention_backward"]
    card_peak = torch.cuda.max_memory_allocated()
    del params, opt, batch
    torch.cuda.empty_cache()
    traced_state = (mem["argument_bytes_by_kind"]["params"]
                    + mem["argument_bytes_by_kind"]["opt_state"])
    ratio = mem["peak_bytes_per_device"] / card_peak
    flops, counted = roof["flops_per_device"], fc.get_total_flops()
    gap = _rel(flops, counted)
    gib = 2 ** 30
    log(f"  (a) stablelm-3b, phase 5's step ({spec['batch']} x {TRAIN_SEQ}"
        f" in {spec['grad_accum']} microbatches, fp32 state) at a world of "
        f"one: trace {res['trace_s']:.1f}s; params + opt state traced "
        f"{traced_state} B, card {state} B "
        f"({'equal' if traced_state == state else 'DIFFERENT'}); peak "
        f"traced {mem['peak_bytes_per_device'] / gib:.2f} GiB (args "
        f"{mem['argument_bytes'] / gib:.2f} + trace "
        f"{mem['trace_peak_bytes'] / gib:.2f}), card "
        f"{card_peak / gib:.2f} GiB, ratio {ratio:.4f} (range "
        f"{DRYRUN_PEAK_RANGE}); FLOPs traced {flops:.6e}, FlopCounterMode "
        f"{counted:.6e}, rel gap {gap:.3g} (tolerance {DRYRUN_FLOPS_RTOL});"
        f" HBM bytes traced {roof['bytes_per_device']:.4e}; "
        f"{_dryrun_terms(roof)}; the card's step under FlopCounterMode "
        f"{step_s:.2f}s, loss {loss:.6f}, flash launches {launches}, "
        f"backward {bwd_launches}; card: {card_line()}")
    if traced_state != state:
        raise AssertionError(f"dry run: traced params + opt state "
                             f"{traced_state} B, the card's {state} B")
    if not DRYRUN_PEAK_RANGE[0] <= ratio <= DRYRUN_PEAK_RANGE[1]:
        raise AssertionError(f"dry run: traced peak {ratio:.4f}x the "
                             f"card's, outside {DRYRUN_PEAK_RANGE}")
    if gap > DRYRUN_FLOPS_RTOL:
        raise AssertionError(f"dry run: traced FLOPs {flops:.6e} against "
                             f"{counted:.6e} counted on the card")
    per_step = cfg.n_layers * cfg.grad_accum * 2
    if launches != per_step or bwd_launches != per_step // 2:
        raise AssertionError(f"dry run: the real step launched flash "
                             f"{launches} times and its backward "
                             f"{bwd_launches}, expected {per_step} and "
                             f"{per_step // 2}")

    failed = []
    for (arch, shp, multi), proc in procs:
        out, err = proc.communicate(timeout=900)
        line = next((x for x in out.splitlines()
                     if x.startswith("DRYRUN_RECORD ")), None)
        if proc.returncode != 0 or line is None:
            failed.append(f"{arch} {shp}")
            log(f"  (b) {arch} x {shp}: FAILED (exit {proc.returncode})\n"
                f"{err[-3000:]}")
            continue
        r = json.loads(line.split(" ", 1)[1])
        m, ro = r["memory"], r["roofline"]
        wire = ", ".join(
            f"{k} {v:.4e} B ({int(ro['collective_count_by_kind'][k])})"
            for k, v in sorted(ro["collective_bytes_by_kind"].items()))
        log(f"  (b) [{r['mesh']}] {arch} x {shp}: trace {r['trace_s']}s; "
            f"a device: args {m['argument_bytes'] / gib:.2f} GiB, peak "
            f"{m['peak_bytes_per_device'] / gib:.2f} GiB (of "
            f"{m['hbm_bytes'] / 1e9:.0f} GB); FLOPs "
            f"{ro['flops_per_device']:.4e}, HBM bytes "
            f"{ro['bytes_per_device']:.4e}, wire bytes "
            f"{ro['collective_bytes_per_device']:.4e} [{wire}]; "
            f"{_dryrun_terms(ro)}")
    if failed:
        raise AssertionError(f"dry run: cells failed: {failed}")
    log(f"dry-run phase wall: {time.perf_counter() - t0:.1f}s")
    return {"flash_attention": launches,
            "flash_attention_backward": bwd_launches}


# ---------------------------------------------------------------------------
#  Phase 8: the port's examples
# ---------------------------------------------------------------------------
#: the splits of torch_etl_ssb's optimized and streaming engines (its own
#: default)
EXAMPLE_SPLITS = 8
#: mixtral-8x7b's layers (of 32) torch_serve_lm serves at full width
EXAMPLE_SERVE_LAYERS = 2
#: each flow's grouped sums a run, by kernel and route: one an Aggregate
#: (Q3.1's 2,646 ids with counts on the wide route; Q1.1's keyless sum on
#: the segment sum)
EXAMPLE_ROUTES = {"Q1.1": {"segment_sum/narrow": 1},
                  "Q2.1": {"radix_groupby/narrow": 1},
                  "Q3.1": {"radix_groupby/wide": 1},
                  "Q4.1": {"radix_groupby/narrow": 1},
                  "Q4.1s": {"radix_groupby/narrow": 1}}


def load_example(name: str):
    """``examples/<name>.py`` of this checkout, as a module."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(ROOT, "examples", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def example_log(msg: str = "") -> None:
    """An example's own lines, indented under the phase's."""
    for line in msg.strip("\n").split("\n"):
        log(f"    {line}")


def example_step_split(cfg, dev: torch.device, batch: int = 8,
                       seq_len: int = 256, steps: int = 10) -> dict:
    """Where a ``torch_train_lm`` step's time goes: the input pipeline
    alone (``InputPipeline`` blocks made into model batches on the host,
    ms a block) and the train step alone on one resident batch (fresh
    seed-0 state, synchronised, ms a step after a warm-up step)."""
    from repro_torch.data import InputPipeline, PipelineConfig, make_lm_batch_fn
    from repro_torch.launch.train import build_state, to_device
    from repro_torch.train.optimizer import OptConfig
    from repro_torch.train.train_step import make_train_step
    pc = PipelineConfig(seq_len=seq_len, global_batch=batch,
                        vocab_size=cfg.vocab_size,
                        docs_per_window=max(batch * 16, 512), seed=0)
    to_model = make_lm_batch_fn(cfg)
    blocks = iter(InputPipeline(pc))
    t0 = time.perf_counter()
    host = [to_model(next(blocks)) for _ in range(steps)]
    input_ms = (time.perf_counter() - t0) / steps * 1e3
    params, opt = build_state(cfg, 0, dev)
    step = make_train_step(cfg, OptConfig(total_steps=200, warmup_steps=20))
    mb = to_device(host[0], dev)
    params, opt, _ = step(params, opt, mb)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        params, opt, _ = step(params, opt, mb)
    torch.cuda.synchronize()
    return {"input_ms": input_ms,
            "step_ms": (time.perf_counter() - t0) / steps * 1e3}


def phase_examples(data, dev: torch.device) -> dict:
    """Phase 8: the functions the port's examples' ``main``s call, on the
    card, from the launch counters set to 0: (a) ``torch_etl_ssb`` over
    phase 3's SF1 data, every flow on the four engines, (b)
    ``torch_quickstart`` (Theorem 1's plan from the card's activity times),
    (c) ``torch_declarative_q41`` (streaming, optimize 2, fused), (d)
    ``torch_serve_lm`` at mixtral-8x7b's full width and
    EXAMPLE_SERVE_LAYERS layers, (e) ``torch_train_lm``'s 200 steps with
    the restart, then where its step's time goes (``example_step_split``).
    Each flow's oracle is computed once.  Returns each kernel's launches
    in the examples (the step split's not counted)."""
    from repro_torch.core import resolve_backend
    from repro_torch.etl import BUILDERS
    from repro_torch.kernels import launch_counts, reset_launches
    t_phase = time.perf_counter()
    rtol = resolve_backend("torch").oracle_rtol
    rows = len(data.lineorder["lo_orderkey"])
    t0 = time.perf_counter()
    oracles = {q: build(data).oracle(data) for q, build in BUILDERS.items()}
    log(f"  oracles of {len(oracles)} flows in "
        f"{time.perf_counter() - t0:.1f}s")
    torch.cuda.synchronize()
    reset_launches()

    log(f"  (a) torch_etl_ssb: {len(BUILDERS)} flows x 4 engines, SSB SF1, "
        f"backend torch, {EXAMPLE_SPLITS} splits:")
    t0 = time.perf_counter()
    runs = load_example("torch_etl_ssb").evaluate(
        data, splits=EXAMPLE_SPLITS, backend="torch", oracles=oracles,
        log=example_log)
    torch.cuda.synchronize()
    n_sinks = 0
    for qname, flow in runs.items():
        for engine, run in flow["engines"].items():
            label = f"{qname}/{engine}"
            check_oracle(run["table"], oracles[qname], rtol, label)
            if run["degradations"]:
                raise AssertionError(f"{label}: {run['degradations']} "
                                     f"degradations")
            if run["launches"].get("hash_probe", 0) < 1:
                raise AssertionError(f"{label}: hash_probe never launched")
            if run["routes"] != EXAMPLE_ROUTES[qname]:
                raise AssertionError(f"{label}: grouped sums "
                                     f"{run['routes']}, expected "
                                     f"{EXAMPLE_ROUTES[qname]}")
            n_sinks += 1
    log(f"  (a) {n_sinks} sinks within rtol {rtol} of their oracles, 0 "
        f"degradations, Q3.1's Aggregate on the wide route; "
        f"{time.perf_counter() - t0:.1f}s")
    for qname, flow in runs.items():
        log(f"    {qname}: " + "; ".join(
            f"{e} wall={r['wall']:.4f}s rows/s={rows / r['wall']:.6g} "
            f"copies={r['copies']} bytes_copied={r['bytes_copied']}"
            for e, r in flow["engines"].items()))

    log("  (b) torch_quickstart (SSB SF1 Q4.1, backend torch):")
    t0 = time.perf_counter()
    qs = load_example("torch_quickstart").quickstart(
        data, backend="torch", expect=oracles["Q4.1"], log=example_log)
    plan = qs["plan"]
    log(f"  (b) Theorem 1 from the card's activity times: staggering "
        f"{plan.staggering!r}, n {plan.n}, t0 {plan.t0:.6g}s, c "
        f"{plan.c:.6g}s, lambda {plan.lam:.6g}s/row, N {plan.N}, m* "
        f"{plan.m_star:.4f} -> degree {qs['degree']}; walls: "
        + ", ".join(f"{k} {v:.4f}s" for k, v in qs["walls"].items())
        + f"; activity times {qs['activity_times']}; "
        f"{time.perf_counter() - t0:.1f}s")
    if not (1 <= qs["degree"] <= 64 and np.isfinite(plan.m_star)):
        raise AssertionError(f"quickstart: degree {qs['degree']}, m* "
                             f"{plan.m_star}")

    log("  (c) torch_declarative_q41 (SSB SF1, backend torch, streaming, "
        "optimize 2, fused, 8 splits):")
    t0 = time.perf_counter()
    res = load_example("torch_declarative_q41").run(
        data, engine="streaming", optimize=2, backend="torch",
        expect=oracles["Q4.1"], log=example_log)
    check_oracle(res.table, oracles["Q4.1"], rtol, "declarative Q4.1")
    if res.run.degradations:
        raise AssertionError(f"declarative Q4.1: {res.run.degradations} "
                             f"degradations")
    log(f"  (c) wall={res.run.wall_time:.4f}s "
        f"rows/s={rows / res.run.wall_time:.6g}; "
        f"{time.perf_counter() - t0:.1f}s")

    sl = load_example("torch_serve_lm")
    cfg = sl.model_config(EXAMPLE_SERVE_LAYERS)
    log(f"  (d) torch_serve_lm: {cfg.name} at full width, "
        f"{cfg.n_layers} of 32 layers, random weights from seed 0, "
        f"{sl.TRAFFIC} in waves of {sl.BATCH}:")
    t0 = time.perf_counter()
    before = launch_counts()["flash_attention"]
    torch.cuda.reset_peak_memory_stats()
    served = sl.serve(cfg, device=str(dev), log=example_log)
    torch.cuda.synchronize()
    flash = launch_counts()["flash_attention"] - before
    waves = -(-sl.TRAFFIC["n"] // sl.BATCH)
    log(f"  (d) {served['tokens']} tokens, {served['tokens_per_s']:.1f} "
        f"tok/s, prefill {served['stats']['prefill_s']:.4f}s, decode "
        f"{served['stats']['decode_s']:.4f}s; flash launches {flash}; peak "
        f"{torch.cuda.max_memory_allocated() / 2**30:.1f} GiB; "
        f"{time.perf_counter() - t0:.1f}s (weights made included)")
    if flash != cfg.n_layers * waves:
        raise AssertionError(f"serve_lm: flash launched {flash} times, "
                             f"expected {cfg.n_layers} layers x {waves} "
                             f"prefills")
    if [len(r.out_tokens) for r in served["done"]] != \
            [sl.TRAFFIC["max_new"]] * sl.TRAFFIC["n"]:
        raise AssertionError("serve_lm: not every request got its tokens")
    del served
    torch.cuda.empty_cache()

    tl = load_example("torch_train_lm")
    cfg = tl.model_config()
    log(f"  (e) torch_train_lm: {cfg.name}, {cfg.n_layers} layers, d_model "
        f"{cfg.d_model}, {cfg.n_heads} heads of {cfg.hd}, vocab "
        f"{cfg.vocab_size}, grad_accum {cfg.grad_accum}; 200 steps of 8 x "
        f"256 with the restart at 100:")
    t0 = time.perf_counter()
    before = launch_counts()
    trained = tl.train(cfg, device=str(dev), log=example_log)
    torch.cuda.synchronize()
    after = launch_counts()
    steps = len(trained["losses"])
    step_ms = statistics.median(trained["step_seconds"]) * 1e3
    fwd = after["flash_attention"] - before["flash_attention"]
    bwd = (after["flash_attention_backward"]
           - before["flash_attention_backward"])
    micro = steps * cfg.grad_accum * cfg.n_layers
    log(f"  (e) loss {trained['first']:.4f} -> {trained['last']:.4f}, "
        f"resumed from step {trained['resumed_from']}; median step "
        f"{step_ms:.2f} ms, {8 * 256 / step_ms * 1e3:.0f} tok/s; phase-2 "
        f"{trained['tokens_per_s']:.0f} tok/s (checkpoints included); "
        f"flash launches {fwd} forward, {bwd} backward; "
        f"{time.perf_counter() - t0:.1f}s")
    launched = launch_counts()         # the examples' own, not the split's
    split = example_step_split(cfg, dev)
    log(f"  (e) step split: the input pipeline alone "
        f"{split['input_ms']:.2f} ms a block (host), the train step alone "
        f"{split['step_ms']:.2f} ms on a resident batch (synchronised)")
    if not trained["last"] < trained["first"] - 0.5:
        raise AssertionError(f"train_lm: loss {trained['first']} -> "
                             f"{trained['last']}, not down by 0.5")
    if trained["resumed_from"] != 100 or steps != 200:
        raise AssertionError(f"train_lm: {steps} steps, resumed from "
                             f"{trained['resumed_from']}")
    if fwd != 2 * micro or bwd != micro:
        raise AssertionError(f"train_lm: flash launched {fwd} / {bwd} "
                             f"times, expected {2 * micro} / {micro}")
    log(f"examples phase wall: {time.perf_counter() - t_phase:.1f}s")
    return launched


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--profile", action="store_true",
                    help="also profile one more fused Q4.1 run, one warm "
                         "served Q4.1 tick, one prefill and one decode "
                         "step of each LM and one train step of each "
                         "trained config (device busy time by kernel, "
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
    grouped_ptxas(_cuda.build_log)
    backward_ptxas(_cuda.build_log)
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
    measured["flash_attention_backward"] = phase_flash_backward(gen)
    measured["mamba_scan_backward"] = phase_scan_backward(gen)
    torch.cuda.empty_cache()
    measured["adamw"] = phase_adamw(gen)

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
    log("keyed Aggregates on the partitioned grouped sums (SSB SF1 "
        "lineorder, backend torch, fused, 8 splits):")
    for k, v in phase_keyed(data).items():
        launches[k] += v
    log("kernel failures (SSB SF1 Q4.1, backend torch, streaming, fused, "
        "8 splits):")
    phase_faults(data)
    log(f"served Q4.1 (SSB SF1 in {SERVE_TICKS} ticks and an empty one, "
        f"backend torch, fused, 8 splits):")
    served = phase_served_q41(data, expect, args.profile)
    for k, v in served.items():
        launches[k] += v
    if args.profile:
        profile_q41(data)
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
    # the moe models do not fit one card at full depth (mixtral: 187 GB in
    # its fp32 params, grok-1: 628 GB in bf16): full width, fewer layers
    launches["flash_attention"] += serve_model(
        "mixtral-8x7b", "flash_attention", ref_depth=8, dev=gen.device,
        profile=args.profile, depth=8)
    launches["flash_attention"] += serve_model(
        "grok-1-314b", "flash_attention", ref_depth=2, dev=gen.device,
        profile=args.profile, depth=4)
    # qwen2.5-32b (QKV bias, G 5, attention in query chunks of 1024 on the
    # plain route), qwen2-72b (QKV bias, G 8, a 152,064-token vocabulary)
    # and granite-20b (MQA, a gelu MLP): full width, fewer layers
    for arch, depth in DENSE_SERVE.items():
        launches["flash_attention"] += serve_model(
            arch, "flash_attention", ref_depth=2, dev=gen.device,
            profile=args.profile, depth=depth)
    # the vlm and the encoder fit the card whole: full depth and width
    launches["flash_attention"] += serve_vlm(gen.device, args.profile)
    launches["flash_attention"] += serve_encoder(gen.device, args.profile)

    # ---- phase 5: the LM training path
    log(f"LM training path (train_loop, sequences of {TRAIN_SEQ}):")
    launches.update(flash_attention_backward=0, mamba_scan_backward=0)
    trained = phase_train(gen.device, args.profile)
    for name, (n, fn) in trained.items():
        launches[name] += n
        measured[name].update({f"train_{k}": v for k, v in fn.items()})

    # ---- phase 6: sharded training and serving on a 1x1 nccl mesh
    log(f"LM sharded path (DTensor over a DeviceMesh, sequences of "
        f"{TRAIN_SEQ}):")
    sharded_lm = phase_sharded_lm(gen.device)
    for name, n in sharded_lm.items():
        launches[name] += n

    # ---- phase 7: the dry run: a traced step against the card's, then
    # production cells on the fake process group in their own processes
    log("LM dry run (meta tensors, H100 data-sheet roofline):")
    dry_procs = start_dryrun_cells()
    for name, n in phase_dryrun(gen.device, dry_procs).items():
        launches[name] += n

    # ---- phase 8: the port's examples, through the functions their main()s
    # call, over phase 3's SF1 data and at full model width
    log("the port's examples (examples/torch_*.py):")
    torch.cuda.empty_cache()
    examples = phase_examples(data, gen.device)
    del data
    for name, n in examples.items():
        launches[name] += n

    # ---- result lines
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
                              "src/repro/kernels/mamba_scan/kernel.py:79"),
               # no Pallas kernel: jax.grad of the plain functions
               "flash_attention_backward": (
                   "src/repro_torch/csrc/flash_attention_bwd.cu",
                   "src/repro/kernels/flash_attention/ref.py:11"),
               "mamba_scan_backward": (
                   "src/repro_torch/csrc/mamba_scan_bwd.cu",
                   "src/repro/models/mamba.py:25")}
    kernels = []
    for name, (src, replaces) in sources.items():
        m = measured[name]
        row = {"name": name, "route": "cuda", "source": src,
               "replaces": replaces, "launches": launches[name],
               "max_abs_err": m["max_abs_err"], "ms": m["ms"],
               "plain_ms": m["plain_ms"], "bound_ms": m["bound_ms"],
               "bound_by": m["bound_by"], "library_ms": m["library_ms"]}
        if name in ("radix_groupby", "segment_sum"):
            row.update({k: v for k, v in m.items() if isinstance(v, dict)})
            row["cases_note"] = (
                "the row's own numbers are the main path's (SSB Q4.1, Q1.1); "
                "supplier_shard (1.5M rows, 2,000 ids + counts) and "
                "supplier_combiner (2,000 rows, 2,000 ids): the hash-mode "
                "supplier flow's sharded sums, on the wide direct route; "
                "the partitioned route (two launches): 2^20cells_*, 4M rows "
                "over 2^20 ids; part_keyed and customer_keyed, 6M rows over "
                "200,000 and 30,000 ids + counts (SF1 lineorder by "
                "lo_partkey, lo_custkey); part_combiner, 200,000 rows over "
                "200,000 ids (the 4-shard part-keyed flow's combiner); "
                "sort_4m, 4M rows over 4M ascending ids (the sort route, "
                "global counters); device_ms and library_device_ms "
                "(index_add_) from torch.profiler; launches include the "
                "keyed Aggregates' (phase 3)")
        if name == "hash_probe":
            row.update({k: m[k] for k in ("device_ms", "other_tables")})
            row["probe_note"] = ("1,048,576 rows against part; device_ms "
                                 "from torch.profiler; other_tables: "
                                 "customer, supplier and date")
        row.update({k: v for k, v in m.items() if k.startswith("train_")})
        if name in sharded_lm:
            row["sharded_launches"] = sharded_lm[name]
            row["sharded_note"] = (
                "launches include the sharded phase's: stablelm-3b on a 1x1 "
                "nccl mesh, 2 train steps (a forward launch a layer a "
                "microbatch and one in the remat recompute, a backward "
                "launch a layer a microbatch) and, forward only, one "
                "4 x 2048 prefill; and the dry-run phase's real stablelm-3b "
                "step (256 forward, 128 backward)")
        if examples[name]:
            row["examples_launches"] = examples[name]
            row["examples_note"] = (
                "launches include phase 8's (examples/torch_*.py): "
                "torch_etl_ssb's 5 SSB SF1 flows on 4 engines, "
                "torch_quickstart's 4 Q4.1 runs, torch_declarative_q41's "
                "streaming run; torch_serve_lm's mixtral-8x7b prefills (2 "
                "layers x 2 waves); torch_train_lm's 200 steps (8 layers x "
                "2 microbatches: a forward launch, one in the remat "
                "recompute and a backward launch each)")
        if name in trained:
            row["train_note"] = (
                f"launches include {trained[name][0]} from training (two "
                f"train_loop runs of each trained config: a forward launch "
                f"a call a microbatch and one in the remat recompute, a "
                f"backward launch a call a microbatch; a call a layer and "
                f"one more a vlm cross-attention layer; the flash rows: "
                f"{', '.join(flash_trained())})")
        if trained.get(name, (0, {}))[1]:
            row["train_times_note"] = (
                "at one layer's microbatch shape: train_forward_ms the "
                "forward kernel, train_backward_ms the Function's backward "
                "(the backward kernel), train_plain_backward_ms the plain "
                "backward on the same saved values; train_step_ms the "
                "steady step; train_backward_share a microbatch's "
                "backward over its forward + backward; "
                "train_function_backward_share the backward kernel's calls "
                "over the step; train_peak_gib the training run's peak "
                "device memory; train_vlm, train_hubert: the same for "
                "llama-3.2-vision-11b (its self-attention [1, 2048, 8, 4, "
                "128], causal; cross_*: its cross-attention, 2048 queries "
                "against 1601 vision keys, non-causal) and hubert-xlarge "
                "([4, 2048, 16, 1, 80], non-causal)")
        if name in ("flash_attention_backward", "mamba_scan_backward"):
            row["replaces_note"] = (
                "no TPU kernel: the reference trains by jax.grad of its "
                "plain function at this line, which XLA compiles")
            row.update({k: v for k, v in m.items() if k.startswith("fp32_")
                        or k.endswith("_train")
                        or k in ("device_ms", "device_ms_by_pass",
                                 "kernel_ops_ms",
                                 "fwd_bwd_ms", "library_fwd_bwd_ms",
                                 "library_device_ms",
                                 "rel_norm", "long_sum_rel")})
        if name == "flash_attention":
            row.update({k: v for k, v in m.items() if k.startswith("fp32_")
                        or k.endswith("_prefill")})
            row["prefill_note"] = ("mixtral_prefill, grok_prefill: the same "
                                   "bf16 kernel at B 4, S 2048, 8 kv heads "
                                   "of 128, G 4 with window 4096 and G 6 "
                                   "with softcap 30; vlm_cross_prefill: "
                                   "B 4, Sq 2048 against Skv 1601, 8 kv "
                                   "heads of 128, G 4, non-causal; "
                                   "hubert_prefill: B 4, S 2048, 16 heads "
                                   "of 80, non-causal; qwen25_prefill, "
                                   "qwen2_prefill, granite_prefill: B 4, S "
                                   "2048, hd 128, causal, 8 kv heads at G 5 "
                                   "and G 8, 1 kv head at G 48 (MQA); "
                                   "device_ms from CUDA events around 20 "
                                   "launches back to back")
            row["fp32_note"] = ("the fp32 FMA kernel "
                                "(src/repro_torch/csrc/flash_attention.cu) "
                                "at the same shape; its bound is fp32 FMAs "
                                "at 67 TFLOP/s")
        if name == "mamba_scan":
            row.update({k: v for k, v in m.items()
                        if k.startswith("fp32_") or k.endswith("lanes_ms")
                        or k == "device_ms"})
            row["fp32_note"] = ("the same kernel on fp32 delta/x at the same "
                                "shape; the row's own numbers are for bf16 "
                                "delta/x, as the model passes them")
            row["library_note"] = ("none: no single PyTorch call computes "
                                   "the selective scan")
        if name == "flash_attention_backward":
            row["library_note"] = ("scaled_dot_product_attention's backward "
                                   "alone, on a graph built outside the "
                                   "timed call, at the same shape (B 2, S "
                                   "2048, 32 heads of 80, causal, bf16); "
                                   "library_device_ms: the same from CUDA "
                                   "events around 20 calls back to back, "
                                   "beside device_ms; "
                                   "fwd_bwd_ms: the forward kernel with its "
                                   "log-sum-exp then this kernel; "
                                   "library_fwd_bwd_ms: sdpa forward + "
                                   "backward; gqa_train: mixtral-8x7b's "
                                   "train_4k sequence [2, 4096, 8 kv heads, "
                                   "G 4, 128], window 4096; g5_train, "
                                   "mqa_train: one sequence of 2048 at "
                                   "qwen2.5-32b's Kh 8, G 5 and "
                                   "granite-20b's Kh 1, G 48 (hd 128, "
                                   "causal), with sdpa's enable_gqa; "
                                   "vlm_cross_train: llama-3.2-vision-11b's "
                                   "cross-attention microbatch [1, Sq 2048, "
                                   "Skv 1601, Kh 8, G 4, 128], non-causal "
                                   "(sdpa is_causal=False, enable_gqa); "
                                   "hubert_train: hubert-xlarge's "
                                   "microbatch [4, 2048, 16 heads of 80], "
                                   "non-causal")
            row["bound_note"] = ("the gradient's products, 10·hd an allowed "
                                 "pair a query head (S, dP, dV, dK, dQ) plus "
                                 "2·hd a row (D), at 989 TFLOP/s; "
                                 "kernel_ops_ms: the kernels' own 14·hd a "
                                 "pair (S and dP rebuilt in the dQ kernel); "
                                 "rel_norm: each gradient's ||got - want|| / "
                                 "||want||, whole and worst 64-row tile")
        if name == "mamba_scan_backward":
            row["library_note"] = ("none: no single PyTorch call computes "
                                   "the selective scan's gradient")
            row["shape_note"] = ("Bt 1, T 2048, d 8192, N 16, bf16 delta/x "
                                 "(falcon-mamba-7b's training microbatch)")
            row["bound_note"] = ("bound_ms: the function's own bytes (its "
                                 "inputs, the carries and the gradients); "
                                 "kernel_ops_ms: the time-parallel design's "
                                 "two exp2 a state a step at the "
                                 "special-function units' peak; "
                                 "device_ms_by_pass: the four launches "
                                 "(local sweeps, cross-chunk pass, walks, "
                                 "sums) from torch.profiler")
        kernels.append(row)
    kernels.append({
        "name": "adamw", "route": "cuda",
        "source": "src/repro_torch/csrc/adamw.cu",
        "replaces": "none: the reference's jnp AdamW "
                    "(src/repro/train/optimizer.py), which XLA fuses",
        **measured["adamw"],
        "note": "one training step's norm and update over stablelm-3b's "
                "leaves (falcon_*: falcon-mamba-7b's at 32 layers), fp32 "
                "state, the cells' pass counts; launches a step; ms CUDA "
                "events, device_ms 5 steps back to back; bound_ms 32 B a "
                "parameter; plain_ms the piecewise route with its division; "
                "library_ms torch._fused_adamw_ (no norm, no division), a "
                "yardstick the port never calls; max_abs_err 0: p, m and v "
                "bitwise the plain route's at two layers (fp32 and bf16 "
                "state) and on every leaf whole at the cells' depth (the "
                "gates); norm_rel_gap the largest gap of a norm there"})
    log(f"chip_smoke wall: {time.perf_counter() - t_start:.1f}s")
    print(json.dumps({"kernels": kernels}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
