"""Run one cell of the benchmark of ``br_tpu_torch`` and print its result.

    python3 portbench/run.py --workload NAME --seed N --seconds S --trace 0|1

from the root of a checkout.  Needs CUDA and as many devices as the cell
asks for; otherwise it exits with code 3 and prints no result.  The last
line on standard output is the result's JSON object; the last lines on
standard error are the numbers compared, each beside its limit.  Exit
code 4: a process of the run held a module it may not (JAX, the JAX
package; in the reference's workers also the port or torch).
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    # every build and kernel cache at a fixed path inside the checkout
    cache = ROOT / "build" / "portbench-cache"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["CUDA_CACHE_PATH"] = str(cache / "cuda")
    sys.path.insert(0, str(ROOT))

    from portbench import harness

    cell = harness.Cell(ROOT, args.workload)
    import br_tpu_torch  # noqa: F401  (the program: absent, the run ends here)
    import torch

    chips = cell.workload["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"error: the cell needs {chips} CUDA device(s); "
              f"available: {torch.cuda.is_available()}, count: "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    result, ref_names = harness.run_cell(ROOT, args.workload, args.seed,
                                         args.seconds, bool(args.trace),
                                         t_start=T_START)
    held = sorted(harness.top_level(sys.modules) & set(harness.FORBIDDEN))
    held_ref = sorted(ref_names & set(harness.FORBIDDEN_IN_REFERENCE))
    if held or held_ref:
        print(f"error: modules held: {held} in the run's process, "
              f"{held_ref} in the reference's workers", file=sys.stderr)
        return 4
    for name, chk in result["checks"].items():
        print(f"check {name}: {chk['value']} (limit {chk['limit']})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
