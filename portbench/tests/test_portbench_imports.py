"""No process of a run holds JAX or the JAX package, and the reference
holds nothing of the port: the check compares whole top-level names."""

import json
import shutil
import subprocess
import sys

import pytest

from portbench import harness
from portbench.tests.conftest import ROOT


def _modules_after(code: str) -> set:
    out = subprocess.run(
        [sys.executable, "-c", code + "\nimport sys, json\n"
         "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))"],
        cwd=ROOT, capture_output=True, text=True, check=True)
    return set(json.loads(out.stdout.splitlines()[-1]))


def test_reference_imports_neither_the_port_nor_jax():
    held = _modules_after("import portbench.reference.correct, "
                          "portbench.reference.kmers, "
                          "portbench.reference.oracle")
    assert not held & {"br_tpu_torch", "br_tpu", "jax", "jaxlib", "flax",
                       "torch"}


def test_harness_and_readers_import_no_jax():
    held = _modules_after(
        "import json\nfrom portbench import harness, control\n"
        "c = harness.Cell('.', json.load(open('BENCHMARK.json'))"
        "['workloads'][0]['name'])\n"
        "[c.reader(m['name']) for m in c.end_to_end + c.per_layer]\n"
        "import br_tpu_torch.cli, br_tpu_torch.correct.engine3")
    assert "br_tpu_torch" in held
    assert not held & set(harness.FORBIDDEN)


@pytest.mark.parametrize("names,held", [
    ({"br_tpu_torch", "torch", "numpy"}, set()),
    ({"br_tpu_torchx", "jaxtyping", "flaxen"}, set()),
    ({"br_tpu"}, {"br_tpu"}),
    ({"jax", "jaxlib", "flax"}, {"jax", "jaxlib", "flax"}),
])
def test_check_compares_whole_top_level_names(names, held):
    mods = {f"{n}.sub" for n in names} | names
    assert harness.top_level(mods) & set(harness.FORBIDDEN) == held


def test_run_exits_without_a_result_when_no_cuda_or_no_program(tmp_path):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    name = json.loads((ROOT / "BENCHMARK.json").read_text())[
        "workloads"][0]["name"]
    for cwd, says in ((ROOT, "CUDA"), (tmp_path, "br_tpu_torch")):
        r = subprocess.run(
            [sys.executable, "portbench/run.py", "--workload", name,
             "--seed", str(2**33 + 1), "--seconds", "1", "--trace", "0"],
            cwd=cwd, capture_output=True, text=True, timeout=300)
        assert r.returncode != 0 and r.stdout == ""
        assert says in r.stderr
