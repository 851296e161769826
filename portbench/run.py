"""Run one cell of the benchmark of ``repro_torch`` on this machine's
CUDA device(s):

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

The last line of standard output is the result object; the numbers the
check compared, each beside its limit, are the last lines of standard
error.  Exits non-zero, printing no result, without enough CUDA devices,
without the port's sources beside this folder, or if JAX or the JAX
package was loaded.
"""
import time

PROCESS_START = time.time()

import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    try:
        import repro_torch
    except ImportError as e:
        print(f"the port's package is not beside the benchmark: {e}",
              file=sys.stderr)
        return 1
    if not Path(repro_torch.__file__).resolve().is_relative_to(ROOT / "src"):
        print(f"repro_torch was loaded from {repro_torch.__file__}, not from "
              f"{ROOT / 'src'}", file=sys.stderr)
        return 1
    from portbench.harness import main as run
    return run(process_start=PROCESS_START)


if __name__ == "__main__":
    sys.exit(main())
