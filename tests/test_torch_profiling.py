"""The port's stage registry and trace (``br_tpu_torch.profiling``)
against ``br_tpu.profiling``, and ``--trace DIR`` on the CPU."""

import json
import logging
import re

import pytest
import torch

from br_tpu import correct as j_correct
from br_tpu import profiling as j_profiling
from br_tpu_torch import cli, profiling
from br_tpu_torch import correct as t_correct
from br_tpu_torch.set import HashSet, KmerSet, SolidSet

#: the stage calls both registries get, in order
CALLS = ["build-set", "correct", "write", "correct", "write", "correct"]


def _run_stages(mod):
    mod.reset_stages()
    for name in CALLS:
        with mod.stage(name):
            pass


def _lines(caplog, logger):
    """The messages ``logger`` logged, seconds masked."""
    return [re.sub(r"\d+\.\d{3}s", "<s>", r.getMessage())
            for r in caplog.records if r.name == logger]


@pytest.fixture
def clean_stages():
    profiling.reset_stages()
    j_profiling.reset_stages()
    yield
    profiling.reset_stages()
    j_profiling.reset_stages()


def test_stage_registry_matches_br_tpu(caplog, clean_stages):
    """The same stage calls give the same names and call counts, the same
    debug breadcrumbs and the same report lines, each on its package's
    logger."""
    caplog.set_level(logging.DEBUG)
    _run_stages(j_profiling)
    _run_stages(profiling)
    mine, theirs = profiling.stage_totals(), j_profiling.stage_totals()
    assert {k: v[0] for k, v in mine.items()} == \
        {k: v[0] for k, v in theirs.items()} == \
        {"build-set": 1, "correct": 3, "write": 2}
    assert all(v[1] >= 0 for v in mine.values())
    assert _lines(caplog, "br_tpu_torch") == _lines(caplog, "br_tpu")
    caplog.clear()
    profiling.report()
    j_profiling.report()
    got = _lines(caplog, "br_tpu_torch")
    assert len(got) == 3 and got[0].startswith("stage ")
    # the report sorts by seconds, which differ: compare as sets
    assert sorted(got) == sorted(_lines(caplog, "br_tpu"))
    assert all(r.levelno == logging.INFO for r in caplog.records)
    profiling.reset_stages()
    assert profiling.stage_totals() == {}


@pytest.mark.parametrize("initialised", [False, True])
def test_stage_synchronises_once_cuda_is_initialised(monkeypatch,
                                                     clean_stages,
                                                     initialised):
    """A stage ends with a synchronise once CUDA is initialised (the
    host clock then times the device's work), and never before."""
    synced = []
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: initialised)
    monkeypatch.setattr(torch.cuda, "synchronize",
                        lambda *a: synced.append(a))
    with profiling.stage("correct"):
        assert synced == []
    assert len(synced) == int(initialised)
    assert profiling.stage_totals()["correct"][0] == 1


def test_device_trace_without_a_directory_does_nothing(tmp_path,
                                                       monkeypatch):
    def no_profile(*a, **kw):
        raise AssertionError("a profiler was started")

    monkeypatch.setattr(torch.profiler, "profile", no_profile)
    for off in (None, ""):
        with profiling.device_trace(off):
            pass
    assert list(tmp_path.iterdir()) == []


def test_trace_on_the_cpu(tmp_path, clean_stages):
    """``--trace DIR --device cpu`` writes one Chrome trace JSON, named
    ``TRACE_FILE``, with the build-set, correct and write ranges and no
    CUDA activity."""
    fa = tmp_path / "r.fa"
    fa.write_bytes(b">r\nACGTTGCAAGGCTTACGGATCCATGACGTTGCAAGGCTTAC\n"
                   b">s\nACGTTGCAAGGCTTACGGATCCATGACGTTGCAAGG\n")
    out, trace = tmp_path / "o.fa", tmp_path / "trace"
    assert cli.main(["-i", str(fa), "-o", str(out), "--device", "cpu",
                     "--trace", str(trace), "-c", "one", "fasta", "-i",
                     str(fa), "-k", "11", "-a", "1"]) == 0
    assert [p.name for p in trace.iterdir()] == [profiling.TRACE_FILE]
    events = json.loads((trace / profiling.TRACE_FILE).read_text())[
        "traceEvents"]
    ranges = [e["name"] for e in events
              if e.get("cat") == "user_annotation"]
    assert sorted(ranges) == ["build-set", "correct", "write"]
    cats = {e.get("cat") for e in events}
    assert "cpu_op" in cats
    assert not [c for c in cats if c and ("cuda" in c.lower()
                                          or c.startswith(("gpu", "kernel")))]
    assert out.read_bytes().startswith(b">r\n")


def test_port_modules_match_br_tpu():
    """``br_tpu_torch.correct`` exports what ``br_tpu.correct`` does, and
    the port's sets satisfy the ``KmerSet`` protocol."""
    names = ("One", "Two", "Graph", "Greedy", "GapSize", "build_methods",
             "correct_read")
    for name in names:
        assert getattr(t_correct, name).__name__ == \
            getattr(j_correct, name).__name__
    solid = SolidSet.from_sequences([b"ACGTTGCAAGGCTTAC"], 11)
    hset = HashSet.from_sequences([b"ACGTTGCAAGGCTTACGGATCCATGAC"], 21)
    for s, k in ((solid, 11), (hset, 21)):
        member: KmerSet = s
        assert member.k == k and callable(member.get)
