"""Each metric reader on a hand-made run: two window jobs with their
stage and span log, and a Chrome trace of the traced job."""

import json

import pytest

from portbench import harness, trace
from portbench.tests.conftest import ROOT


def _ev(cat, name, ts, dur):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}


# the traced job: 0 .. 1,000,000 us; correct 200,000 .. 900,000 us;
# kernels at 300,000 (+100,000) and 350,000 (+100,000), overlapping, a
# copy at 950,000 (+10,000) in the write stage
EVENTS = [
    _ev("user_annotation", trace.JOB, 0, 1_000_000),
    _ev("user_annotation", "build-set", 0, 200_000),
    _ev("user_annotation", "correct", 200_000, 700_000),
    _ev("user_annotation", "portbench.host_engine", 600_000, 250_000),
    _ev("user_annotation", "write", 900_000, 100_000),
    _ev("gpu_user_annotation", "correct", 200_000, 700_000),
    _ev("kernel", "void br_dense_probe<int>(int*)", 300_000, 100_000),
    _ev("kernel", "br_one_sites", 350_000, 100_000),
    _ev("gpu_memcpy", "Memcpy DtoH", 950_000, 10_000),
    _ev("cpu_op", "aten::copy_", 940_000, 30_000),
    {"ph": "f", "cat": "ac2g", "name": "flow", "ts": 1, "id": 1},
]


def _job(wall, build, correct, write, host, reads, fallback):
    return {"wall_s": wall, "reads": 100, "rc": 0, "error": None,
            "stages": {"build-set": build, "correct": correct,
                       "write": write},
            "spans": {"host_engine": host},
            "counters": {"reads": reads, "fallback": fallback}}


RUN = {"setup_s": 12.5,
       "jobs": [_job(1.0, 0.2, 0.7, 0.1, 0.25, 100, 2),
                _job(3.0, 0.4, 0.9, 0.3, 0.35, 100, 4)],
       "traced_job": None, "trace": EVENTS,
       "memory": {"peak_bytes": 3 * 2**30}}

WANT = {
    "reads_per_s": 200 / 4.0,
    "setup_s": 12.5,
    "count_s": 0.3,
    "write_s": 0.2,
    "host_engine_s": 0.3,
    "fallback_pct": 3.0,
    "kernel_ms": 200.0,
    "correct_kernel_ms": 200.0,
    "idle_pct": 100 * (1 - 0.16),
    "device_mem_gib": 3.0,
    "engine_rest_s": 0.8 - 0.3 - 0.15,
}


@pytest.fixture(scope="module")
def cell():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    return harness.Cell(ROOT, bench["workloads"][0]["name"])


@pytest.mark.parametrize("name", sorted(WANT))
def test_reader_on_a_hand_made_run(cell, name):
    assert cell.reader(name)(RUN) == pytest.approx(WANT[name])


@pytest.mark.parametrize("name", ["kernel_ms", "correct_kernel_ms",
                                  "build_kernel_ms", "idle_pct",
                                  "engine_rest_s"])
def test_trace_reader_without_a_trace_reads_nothing(cell, name):
    assert cell.reader(name)(dict(RUN, trace=None)) is None


@pytest.mark.parametrize("name", ["host_engine_s", "engine_rest_s"])
def test_host_engine_unseen_reads_nothing(cell, name):
    """A job that sent reads to the host while the harness's span saw no
    call of the host engine has no host engine reading, so neither
    metric that reads it reports one."""
    hooks = harness.Hooks()
    hooks.fallback = 3
    assert hooks.host_span() is None
    hooks.host_calls, hooks.host_s = 1, 0.25
    assert hooks.host_span() == 0.25
    jobs = [RUN["jobs"][0], dict(RUN["jobs"][1], spans={"host_engine": None})]
    assert cell.reader(name)(dict(RUN, jobs=jobs)) is None


def test_kernel_time_by_stage(cell):
    """Kernels are summed by the stage they start in: a kernel of the set
    build counts for ``build_kernel_ms`` and not for
    ``correct_kernel_ms``; ``kernel_ms`` counts every kernel of the job."""
    run = dict(RUN, trace=EVENTS + [_ev("kernel", "solid_count", 50_000,
                                        20_000)])
    assert cell.reader("build_kernel_ms")(run) == pytest.approx(20.0)
    assert cell.reader("correct_kernel_ms")(run) == pytest.approx(200.0)
    assert cell.reader("kernel_ms")(run) == pytest.approx(220.0)
    assert cell.reader("build_kernel_ms")(RUN) is None


def test_every_metric_of_the_manifest_has_a_reader(cell):
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert callable(cell.reader(m["name"]))


def test_trace_breakdown():
    assert trace.busy_us(EVENTS) == 160_000
    assert trace.device_ops(EVENTS) == [["void br_dense_probe<int>", 0.1],
                                        ["br_one_sites", 0.1],
                                        ["Memcpy DtoH", 0.01]]
    # gaps by the host ranges around each gap's middle: 0-300 ms (in
    # build-set), 450-950 ms (in correct's host engine), 960-1000 ms (in
    # write, after the copy's operator ended)
    got = trace.idle_gaps(EVENTS)
    assert [g[0] for g in got] == ["correct > portbench.host_engine",
                                   "build-set", "write"]
    assert [g[1] for g in got] == pytest.approx([0.5, 0.3, 0.04])
