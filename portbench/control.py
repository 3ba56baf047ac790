"""The readings that the limit of ``records_wrong`` is set from: the
program's sound jobs and its control, each against the reference, one
job a seed, in one process.

    python3 portbench/control.py --workload NAME --seeds N [N ...] \\
        [--control 3]

For each seed: the corpus, the cell's set-up, whose warm-up is one job
as the cell runs it (the sound reading), and for the first ``--control`` seeds one more
job with the program's own ``-a`` one lower (the control: the
configuration guarantees that a k-mer is solid iff its exact count is
above ``a``; a count that is off by one, as a saturating or approximate
count would be, breaks it), each judged by ``check.records_wrong``
against the reference.  Prints one JSON line a seed.  The benchmark's
runs do not run this.
"""

import copy
import gc
import json
import shutil
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def read_seed(cell, seed: int, control: bool, device: str = "cuda",
              workers: int = 8) -> dict:
    """One seed's readings: ``records_wrong`` of a sound job and, with
    ``control``, of a job whose ``-a`` is one lower."""
    from portbench import check, corpus, harness
    from portbench.reference import correct as ref_correct

    c = cell.config
    records = corpus.make_corpus(c["reads"], c["genome_size"], cell.traffic,
                                 seed)
    workdir = Path(tempfile.mkdtemp(prefix="portbench-control-"))
    try:
        runner = harness.Runner(cell, records, seed, workdir, device)
        runner.setup()
        try:
            sound = runner.warm
            flipped = None
            if control:
                runner.cell = copy.copy(cell)
                runner.cell.config = dict(c, abundance=c["abundance"] - 1)
                flipped = runner.job()
        finally:
            runner.hooks.uninstall()
        chosen = sorted(runner.chosen)
        del runner
        gc.collect()
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    reference, _names = ref_correct.correct_reads(
        [s for _d, s in records], chosen, c["k"], c["abundance"], c["chain"],
        c["confirm"], c["max_search"], c["two_side"], workers)
    out = {"seed": seed, "chosen": len(chosen),
           "sound": check.records_wrong([sound], reference),
           "job_s": sound["wall_s"],
           "fallback_pct": 100.0 * sound["counters"]["fallback"]
           / max(1, sound["counters"]["reads"])}
    if flipped is not None:
        out["control"] = check.records_wrong([flipped], reference)
    return out


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control", type=int, default=3,
                    help="how many of the first seeds also run the control")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    from portbench import harness

    cell = harness.Cell(ROOT, args.workload)
    for i, seed in enumerate(args.seeds):
        t0 = time.perf_counter()
        row = read_seed(cell, seed, i < args.control)
        row["seconds"] = time.perf_counter() - t0
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
