"""Read, at a cell's own size on the card, the numbers its limits are set
from (not run by the benchmark's runs):

- the program against the reference, on every seed of ``--seeds`` (the
  lower readings);
- the controls, the reference itself in each precision its model file
  lists (``CONTROLS``: float8 products; for Mamba also the scan's decay,
  drive and states in bfloat16), against the float32 reference on each
  seed of ``--control-seeds``;
- the planted faults "half of the batch left out, the mean over the
  rest" and, for Mamba, "the scan's states dropped", as the reference
  computes them, on those seeds too.

    python3 portbench/tools/controls.py --workload <cell> \\
        --seeds 1,2,3 --control-seeds 1,2,3 --out readings.jsonl

Each reading is a JSON line on standard output and in ``--out``.
"""
import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]


def main() -> int:
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import torch

    from portbench import check
    from portbench.harness import log
    from portbench.reference.follow import follow, model_module
    from portbench.registry import Registry

    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--skip", default="",
                    help="readings to leave out, by kind, comma-separated")
    ap.add_argument("--out", required=True)
    args = ap.parse_args()
    reg = Registry()
    cell = reg.cell(args.workload)
    cj, tr = reg.config(cell["config"]), reg.traffic(cell["traffic"])
    runner = reg.runner(tr["runner"])
    n = cell["check_steps"]
    dev = torch.device("cuda")
    controls = {int(s) for s in args.control_seeds.split(",") if s}
    with open(args.out, "a") as out:
        def emit(kind, seed, values, seconds):
            line = json.dumps({"cell": args.workload, "seed": seed,
                               "kind": kind, "seconds": seconds, **values})
            print(line, flush=True)
            out.write(line + "\n")
            out.flush()

        for seed in (int(s) for s in args.seeds.split(",")):
            t = time.perf_counter()
            prog = runner.Program(cj, tr, seed, dev)
            try:
                program, rows = prog.first_steps(n, time.time())
            finally:
                prog.close()
            values = check.row_numbers(
                rows, runner.reference_rows(cj, tr, seed, n))
            t_prog = time.perf_counter() - t
            t = time.perf_counter()
            ref = follow(cj, tr, seed, n, dev)
            t_ref = time.perf_counter() - t
            values.update(check.numbers(program, ref))
            values["losses"] = program["losses"]
            values["ref_losses"] = ref["losses"]
            emit("program", seed, values, [t_prog, t_ref])
            if seed not in controls:
                continue
            mod = model_module(cj)
            variants = [(f"control_{p}", {"prec": p}) for p in mod.CONTROLS]
            variants += [(f"fault_{p}", {"prec": p}) for p in mod.FAULTS]
            for kind, kw in variants + [("fault_half_batch",
                                         {"drop_half": True})]:
                if kind in args.skip.split(","):
                    continue
                t = time.perf_counter()
                got = follow(cj, tr, seed, n, dev, **kw)
                emit(kind, seed, dict(check.numbers(got, ref),
                                      losses=got["losses"]),
                     time.perf_counter() - t)
            log(f"seed {seed} done")
    return 0


if __name__ == "__main__":
    sys.exit(main())
