"""On the card: a short run of each cell of BENCHMARK.json through
``run.py``, whose last line is the result with ``correct`` true.  Skips
without a CUDA device (decided in the ``cuda_device`` fixture)."""

import json
import subprocess
import sys

import pytest

from portbench.tests.conftest import ROOT

CELLS = [w["name"] for w in json.loads(
    (ROOT / "BENCHMARK.json").read_text())["workloads"]]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_short_run_on_the_card_is_correct(cuda_device, cell):
    r = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", cell, "--seed",
         str(2**33 + 77), "--seconds", "2", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-2000:]
    result = json.loads(r.stdout.strip().splitlines()[-1])
    assert result["correct"] and result["device"]["platform"] == "gpu"
    assert list(result)[-1] == "checks"
