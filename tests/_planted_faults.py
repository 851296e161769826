"""Planted faults against the kernels' checks, on a machine with an H100
and ``nvcc``:

    python3 tests/_planted_faults.py            # every copy
    python3 tests/_planted_faults.py --copy 3   # the third copy alone

Copies ``src/`` and ``chip_smoke.py`` into three temporary directories,
plants faults in each copy's CUDA sources (three in the first, one in
each other), builds each copy and holds its results against the plain
versions with ``chip_smoke.py``'s checks:

- ``flash_attention_bwd.cu``: the bf16 wgmma dK/dV kernel (producer and
  consumers alike) skips the last query tile it would visit for every
  key block in the second half of the sequence (at the training shape
  [2, 2048, 32, 80] and at a GQA case, hd 128);
  each of dK and dV must fail ``FLASH_BWD_REL_BF16`` (the relative norm
  over 64-row tiles); whether ``FLASH_TOL_BF16`` alone catches it is
  printed beside;
- ``mamba_scan_bwd.cu``: the walk drops carry interval 1's terms of dA,
  and the reduction drops channel block 1's partials of dB and dC; at
  falcon-mamba-7b's training shape (Bt 1, T 2048, d 8192, N 16), in bf16
  and fp32 delta/x, each of dA, dB, dC must fail ``SCAN_TOL`` with its
  atol times the gradient's largest value;
- second copy, ``mamba_scan_bwd.cu``: the cross-chunk pass skips time
  chunk 1's decay (chunk 0's walk starts from u(1) alone); at the same
  shape each of dA, dB (atol times the largest value) and dx must fail
  ``SCAN_TOL``;
- third copy, ``grouped_sum.cuh``: the partitioned route's scatter ranks
  a tile's rows by the order of its warps' ``atomicAdd`` on one counter a
  partition in place of lane and warp order; at SF1 lineorder by
  lo_custkey (6M rows, 30,000 ids) and at 2^20 cells (4M rows, C 2), with
  fractional values, ``_grouped_case``'s two launches must differ (its
  integer case, whose sums do not depend on the order, is printed beside).

Prints a line a gradient or case (its gap against the limit) and exits 1
if any planted fault passes the check meant to catch it.  The repo's own tree
is not touched.
"""
import os
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
#: the faults of each copy, and the scan gradients (index into the six,
#: name) each copy's scan check must see fail
COPIES = [
    ({"flash_attention_bwd.cu": [(
        "const int steps = G * n_qt;",
        "const int steps = G * n_qt - (n_qt > 1 && k0 >= Skv / 2 ? 1 : 0);")],
      "mamba_scan_bwd.cu": [
          ("dA[s] = __fmaf_rn(gh, dt, dA[s]);",
           "if (k != 1) dA[s] = __fmaf_rn(gh, dt, dA[s]);"),
          ("acc = __fadd_rn(acc, src[blk * tn]);",
           "if (blk != 1) acc = __fadd_rn(acc, src[blk * tn]);")]},
     ((2, "B"), (3, "C"), (4, "A"))),
    ({"mamba_scan_bwd.cu": [
        ("g = __fmaf_rn(p[j], g, u[j]);",
         "g = k != 1 ? __fmaf_rn(p[j], g, u[j]) : u[j];")]},
     ((4, "A"), (2, "B"), (1, "x"))),
    ({"grouped_sum.cuh": [
        ("tc + warp * n_parts, cnt_blk, start,", "tc, cnt_blk, start,"),
        ("const int32_t j = first + rank;",
         "const int32_t j = kStaged ? atomicAdd((int32_t*)cnt + p, 1) "
         ": first + rank;"),
        ("if (p >= 0 && rank == 0) cnt[p] = first + n_p;",
         "if (false) cnt[p] = first + n_p;")]},
     ()),
]
#: gradients whose atol scales with their largest value (long sums)
LONG_SUMS = ("A", "B", "C")


def plant(copy: Path, faults: dict) -> None:
    for name, edits in faults.items():
        path = copy / "src" / "repro_torch" / "csrc" / name
        text = path.read_text()
        for old, new in edits:
            if text.count(old) != 1:
                raise SystemExit(f"{name}: {old!r} is not in the source "
                                 f"exactly once")
            text = text.replace(old, new)
        path.write_text(text)


def check_copy(which: int) -> int:
    """Run inside planted copy ``which`` (its ``src`` first on the path)."""
    import torch

    import chip_smoke as c
    from repro_torch.kernels.flash_attention import (
        flash_attention_backward_ref)
    from repro_torch.kernels.flash_attention.ops import (
        flash_attention_backward_cuda, flash_attention_cuda)
    from repro_torch.kernels.mamba_scan import mamba_scan_backward_ref
    from repro_torch.kernels.mamba_scan.ops import (mamba_scan_backward_cuda,
                                                    mamba_scan_cuda)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    missed = []
    bf16 = torch.bfloat16
    faults, scan_grads = COPIES[which]
    flash = ((2, 2048, 32, 1, 80), (2, 257, 2, 2, 128)) \
        if "flash_attention_bwd.cu" in faults else ()
    for B, S, Kh, G, hd in flash:
        def rand(*shape):
            return torch.randn(shape, generator=gen, device="cuda").to(bf16)
        q, k, v = rand(B, S, Kh, G, hd), rand(B, S, Kh, hd), rand(B, S, Kh,
                                                                  hd)
        dout = rand(B, S, Kh, G, hd)
        out, lse = flash_attention_cuda(q, k, v, return_lse=True, causal=True)
        got = flash_attention_backward_cuda(q, k, v, out, lse, dout,
                                            causal=True)
        want = flash_attention_backward_ref(q, k, v, out, lse, dout,
                                            causal=True)
        for n, a, w in zip("qkv", got, want):
            whole, tile = c.rel_gaps(a, w)
            rtol, atol = c.FLASH_TOL_BF16
            elementwise = torch.allclose(a.float(), w.float(), rtol=rtol,
                                         atol=atol)
            print(f"flash S={S} G={G} hd={hd} d{n}: relative norm {whole:.4g},"
                  f" worst 64-row tile {tile:.4g} (limit "
                  f"{c.FLASH_BWD_REL_BF16}); elementwise "
                  f"{'passes' if elementwise else 'fails'}")
            if n in "kv" and tile <= c.FLASH_BWD_REL_BF16:
                missed.append(f"flash S={S} d{n}")
    if "grouped_sum.cuh" in faults:
        missed += check_grouped(c)
    for dtype in (bf16, torch.float32) if scan_grads else ():
        args = c._scan_inputs(gen, 1, 2048, 8192, 16, False, dtype)
        dy = torch.randn((1, 2048, 8192), generator=gen, device="cuda")
        dhT = torch.randn((1, 8192, 16), generator=gen, device="cuda")
        _, _, carries = mamba_scan_cuda(*args, carries=True)
        wide = [t.float() for t in args[:2]] + list(args[2:])
        got = mamba_scan_backward_cuda(*wide, carries, dy, dhT)
        want = mamba_scan_backward_ref(*wide, carries, dy, dhT)
        for i, n in scan_grads:
            a, w = got[i], want[i]
            rtol, atol = c.SCAN_TOL
            top = float(w.abs().max())
            scale = top if n in LONG_SUMS else 1.0
            caught = not torch.allclose(a, w, rtol=rtol, atol=atol * scale)
            print(f"scan {str(dtype).split('.')[-1]} d{n}: max gap / max "
                  f"value {float((a - w).abs().max()) / top:.4g} (atol "
                  f"{atol}{' x max' if n in LONG_SUMS else ''}); "
                  f"{'fails' if caught else 'PASSES'}")
            if not caught:
                missed.append(f"scan {dtype} d{n}")
    if missed:
        print("planted faults the checks missed: " + ", ".join(missed))
        return 1
    print("every planted fault fails its check")
    return 0


def check_grouped(c) -> list:
    """The planted scatter fault against ``_grouped_case``'s run-twice
    check: fractional values at the customer key's and the 2^20-cell
    shapes must give two launches that differ.  Returns the shapes where
    they did not."""
    import functools

    import numpy as np
    import torch

    from repro_torch.kernels.radix_groupby import (radix_groupby,
                                                   radix_groupby_ref)
    kernel = functools.partial(radix_groupby, impl="cuda")
    rng = np.random.default_rng(0)
    missed = []
    for label, n, groups, cols in (("customer_keyed", 6_000_000, 30_000, 1),
                                   ("2^20cells", 4 << 20, 1 << 20, 2)):
        ids = torch.from_numpy(rng.integers(0, groups, n).astype(np.int32)
                               ).cuda()
        for kind, exact in (("float", False), ("int", True)):
            vals = (rng.random((n, cols)) if not exact
                    else rng.integers(0, 8, (n, cols)))
            v = torch.from_numpy(vals.astype(np.float32)).cuda()
            try:
                c._grouped_case(f"planted[{label}_{kind}]", ids, v, groups,
                                kernel, radix_groupby_ref,
                                c._index_add_yardstick(ids, v, groups, True),
                                with_counts=True, exact=exact)
                outcome = "PASSES"
            except AssertionError as e:
                outcome = f"fails: {e}"
            print(f"grouped {label} {kind}: {outcome}", flush=True)
            if not exact and "two launches differ" not in outcome:
                missed.append(f"grouped {label}")
    return missed


def main() -> int:
    rc = 0
    only = (int(sys.argv[sys.argv.index("--copy") + 1]) - 1
            if "--copy" in sys.argv else None)
    for which, (faults, _) in enumerate(COPIES):
        if only is not None and which != only:
            continue
        with tempfile.TemporaryDirectory() as tmp:
            copy = Path(tmp)
            shutil.copytree(ROOT / "src", copy / "src",
                            ignore=shutil.ignore_patterns("_build",
                                                          "__pycache__"))
            shutil.copy2(ROOT / "chip_smoke.py", copy)
            shutil.copy2(__file__, copy / "planted_faults.py")
            plant(copy, faults)
            env = dict(os.environ, PYTHONPATH=str(copy / "src"))
            print(f"copy {which + 1}: " + "; ".join(
                f"{name}: {len(edits)} fault(s)"
                for name, edits in faults.items()), flush=True)
            rc |= subprocess.run(
                [sys.executable, "planted_faults.py", "--in-copy",
                 str(which)], cwd=copy, env=env).returncode
    return rc


if __name__ == "__main__":
    sys.exit(check_copy(int(sys.argv[2])) if "--in-copy" in sys.argv
             else main())
