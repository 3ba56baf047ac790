"""The harness on the CPU at a tiny size: a configuration, a traffic mix
and a per-layer metric added as files and entries only; whole runs with
the timed path sound, with the control, and with faults planted in the
program, each judged against the reference; the manifest's contract."""

import json
import re
import shutil

import pytest

from portbench import control, harness
from portbench.tests.conftest import ROOT

CELL = "tiny.short"
NEW_METRIC = '''
def read(run):
    return float(len(run["jobs"]))
'''


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    """A checkout's data with a throwaway configuration, traffic mix and
    metric added as new files and new entries of BENCHMARK.json."""
    r = tmp_path_factory.mktemp("root")
    for d in ("configs", "traffic", "metrics"):
        shutil.copytree(ROOT / "portbench" / d, r / "portbench" / d)
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cfg = json.loads((ROOT / bench["configs"][0]["file"]).read_text())
    cfg.update(name="tiny", k=13, genome_size=4000, reads=40,
               check=dict(cfg["check"], sample_reads=6, host_reads=2))
    (r / "portbench/configs/tiny.json").write_text(json.dumps(cfg))
    mix = json.loads((ROOT / "portbench/traffic/ont-r9-95to98.json")
                     .read_text())
    mix["length"] = dict(mix["length"], mean=800, max=3000)
    (r / "portbench/traffic/short.json").write_text(json.dumps(mix))
    (r / "portbench/metrics/jobs_n.py").write_text(NEW_METRIC)
    bench["configs"].append({"name": "tiny", "source": "a test",
                             "file": "portbench/configs/tiny.json",
                             "reduced": ["genome_size", "reads"],
                             "why": "a test"})
    bench["workloads"].append({"name": CELL, "config": "tiny",
                               "traffic": "short", "chips": 1,
                               "why": "a test"})
    bench["per_layer"].append({"name": "jobs_n", "unit": "jobs",
                               "better": "higher", "source": "host_clock",
                               "layer": "a test", "moves": "reads_per_s",
                               "workloads": [CELL]})
    (r / "BENCHMARK.json").write_text(json.dumps(bench))
    return r


@pytest.fixture
def small_chunks(monkeypatch):
    """Chunks of 2^14 positions, groups of 2: the CPU's plain versions
    run whole chunks."""
    from br_tpu_torch.correct.engine3 import Torch3Corrector

    monkeypatch.setattr(Torch3Corrector, "CHUNK", 1 << 14)
    monkeypatch.setattr(Torch3Corrector, "NC_MAX", 2)


def run(root, trace_on=False):
    return harness.run_cell(root, CELL, 2**33 + 5, 0.5, trace_on,
                            device="cpu", workers=2)


def test_added_files_are_found(root):
    cell = harness.Cell(root, CELL)
    assert cell.config["name"] == "tiny" and cell.traffic["length"]["mean"] == 800
    assert [m["name"] for m in cell.per_layer][-1] == "jobs_n"
    assert cell.reader("jobs_n")({"jobs": [1, 2]}) == 2.0
    assert cell.argv("r.fa", "o.fa", "cpu") == [
        "-i", "r.fa", "-o", "o.fa", "-b", "8192", "-C", "5", "-M", "7",
        "--device", "cpu", "fasta", "-i", "r.fa", "-k", "13", "-a", "2"]
    # the metric lists only the new cell: the others do not report it
    other = harness.Cell(root, json.loads(
        (ROOT / "BENCHMARK.json").read_text())["workloads"][0]["name"])
    assert "jobs_n" not in [m["name"] for m in other.per_layer]


def test_sound_runs_are_correct(root, small_chunks):
    res, names = run(root)
    assert res["correct"] and res["failed"] == 0
    # the CPU runs no kernel: kernel_ms reads nothing there
    assert set(res["metrics"]) == {"reads_per_s", "setup_s"}
    assert list(res)[-1] == "checks"
    assert not names & set(harness.FORBIDDEN_IN_REFERENCE)
    res, _ = run(root, trace_on=True)
    assert res["correct"]
    assert res["metrics"]["jobs_n"]["value"] >= 1
    assert {"count_s", "engine_rest_s", "write_s", "fallback_pct",
            "host_engine_s"} <= set(res["metrics"])
    assert res["device"]["window_s"] > 0 and "breakdown" in res


def test_each_job_draws_its_own_sample(root, tmp_path):
    """A job's sample of the corpus is drawn afresh from the seed: another
    job of the run checks other reads, and the same seed the same ones.
    The corpus's longest read and a sample of the first job's host reads
    are checked in every job."""
    cell = harness.Cell(root, CELL)
    records = [(b"r%d" % i, b"ACGT" * (i + 1)) for i in range(40)]
    runner = harness.Runner(cell, records, 7, tmp_path, "cpu")
    first, second = runner._choose([3, 5], 1), runner._choose([], 2)
    assert first != second and runner._choose([], 2) == second
    assert {3, 5, 39} <= first & second  # host_reads is 2 in this cell
    again = harness.Runner(cell, records, 7, tmp_path, "cpu")
    assert again._choose([3, 5], 1) == first


def _unchanged(monkeypatch):
    """The chain returns its input: every read the device finishes is
    written as it came."""
    import torch
    from br_tpu_torch.correct.engine3 import Torch3Corrector as T

    def run_chain(self, codes, rstart, rlen, two_side, table=None):
        return codes, rlen, torch.zeros(rstart.shape, dtype=torch.bool,
                                        device=codes.device)
    monkeypatch.setattr(T, "run_chain", run_chain)


def _half(monkeypatch):
    """A batch corrects and returns only its first half."""
    from br_tpu_torch.correct.engine3 import Torch3Corrector as T

    orig = T.correct_batch

    def correct_batch(self, seqs, two_side):
        return orig(self, seqs[: len(seqs) // 2], two_side)
    monkeypatch.setattr(T, "correct_batch", correct_batch)


def _altered(monkeypatch):
    """The decode writes G as A in every read the device finishes."""
    import numpy as np
    from br_tpu_torch.correct import engine3

    monkeypatch.setattr(engine3, "_DECODE",
                        np.frombuffer(b"ACTA", dtype=np.uint8))


@pytest.mark.parametrize("plant", [_unchanged, _half, _altered],
                         ids=["state-unchanged", "half-the-batch",
                              "answer-altered"])
def test_faults_in_the_timed_path_are_not_correct(root, small_chunks,
                                                  monkeypatch, plant):
    plant(monkeypatch)
    res, _ = run(root)
    assert not res["correct"]
    assert res["checks"]["records_wrong"]["value"] > 0


def test_control_is_not_correct(root, small_chunks):
    cell = harness.Cell(root, CELL)
    row = control.read_seed(cell, 2**33 + 6, True, device="cpu", workers=2)
    assert row["sound"] == 0 and row["control"] > 0


NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


def test_manifest_keeps_the_contract():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert bench["paths"] == ["portbench"] and 1 <= bench["run_seconds"] <= 51
    names = [c["name"] for c in bench["configs"]]
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("portbench/")
        assert (ROOT / c["file"]).exists()
        assert json.loads((ROOT / c["file"]).read_text())["name"] == c["name"]
    cells = set()
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["config"] in names and w["chips"] in (1, 4)
        assert (ROOT / "portbench/traffic" / f"{w['traffic']}.json").exists()
        assert len(w["why"]) <= 200 and (w["config"], w["traffic"]) not in cells
        cells.add((w["config"], w["traffic"]))
    e2e = {m["name"] for m in bench["end_to_end"]}
    assert "setup_s" in e2e
    for m in bench["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in (
            "host_clock", "device_trace")
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert (ROOT / "portbench/metrics" / f"{m['name']}.py").exists()
    for m in bench["per_layer"]:
        assert m["moves"] in e2e and m["source"] in (
            "device_trace", "program_span", "program_counter", "host_clock")
    assert len(json.dumps(bench)) < 64 * 1024
