"""The port's native host engine (``br_tpu_torch.native``) against
``br_tpu``'s native engine and ``br_tpu``'s oracle, and the batch
corrector's host reads going through it.

Each engine builds with g++ at first use (a few seconds, once per
process and source); every test runs them on two threads, since test
workers share the host."""

import fcntl

import numpy as np
import pytest

import torch_cases as tc
from br_tpu.correct import build_methods as j_build_methods
from br_tpu.correct import correct_read as j_correct_read
from br_tpu.native import NativeCorrector as JNativeCorrector
from br_tpu.set.solid import SolidSet as JSolidSet
from br_tpu_torch import native
from br_tpu_torch.correct.engine3 import Torch3Corrector
from br_tpu_torch.native import NativeCorrector, build
from br_tpu_torch.set.solid import SolidSet
from catalog import (CASES, NO_REFE_CHECK, build_case_set,
                     build_oracle_corrector, filt)

FULL = ["one", "two", "graph", "greedy", "gap-size"]


@pytest.fixture(scope="module", autouse=True)
def _engines_built():
    """Both libraries built before any test, one test worker at a time:
    br_tpu's build writes its library in place, so a worker could load
    another's half-written file."""
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(build.BUILD_DIR / "tests.lock", "w") as fh:
        fcntl.flock(fh, fcntl.LOCK_EX)
        from br_tpu.native import get_lib

        get_lib()
        native.get_lib()


def _engines(jset, chain, c, ms):
    """(the port's engine, br_tpu's engine) on the same bitfield."""
    mine = NativeCorrector(SolidSet(jset.k, jset.bits.copy()), chain, c, ms,
                           threads=2)
    return mine, JNativeCorrector(jset, chain, c, ms, threads=2)


def _agree(jset, chain, c, ms, reads, two_side, methods=None):
    """Both engines give br_tpu's oracle's bytes; returns them."""
    mine, theirs = _engines(jset, chain, c, ms)
    methods = methods or j_build_methods(chain, jset, c, ms)
    want = [j_correct_read(r, methods, two_side) for r in reads]
    assert mine.correct_batch(reads, two_side) == want
    assert theirs.correct_batch(reads, two_side) == want
    return want


@pytest.mark.parametrize("two_side", [True, False])
@pytest.mark.parametrize(
    "name,method,kwargs,k,refe,read,extra,expect", CASES,
    ids=[c[0] for c in CASES])
def test_native_catalog(name, method, kwargs, k, refe, read, extra, expect,
                        two_side):
    """The reference's planted-error catalog (tests/catalog.py), one
    method a chain, both directions."""
    refe_f, read_f = filt(refe), filt(read)
    jset = build_case_set(k, refe_f, extra)
    c = kwargs.get("c", kwargs.get("nb_validate", 2))
    ms = kwargs.get("max_search", 7)
    inputs = [read_f] + ([] if name in NO_REFE_CHECK else [refe_f])
    oracle = build_oracle_corrector(method, kwargs, jset)
    got = _agree(jset, [method], c, ms, inputs, two_side, methods=[oracle])
    if two_side:   # a single forward chain == Corrector::correct
        assert got[0] == (refe_f if expect == "refe" else read_f)


@pytest.mark.parametrize("two_side", [False, True])
@pytest.mark.parametrize("seed", [11, 12])
def test_native_fuzz_default_chain(seed, two_side):
    """Seeded fuzz reads on a repeat-rich genome, uniform and clustered
    errors, through the default chain."""
    rng = np.random.default_rng(seed)
    genome = tc.repeat_rich_genome(rng)
    reads = (tc.fuzz_reads(rng, genome, 24, 5)
             + tc.fuzz_reads(rng, genome, 8, 2, cluster_gap=tc.K + 1))
    jset = JSolidSet.from_sequences([genome], tc.K)
    want = _agree(jset, FULL, tc.C, tc.MS, reads, two_side)
    assert sum(a != b for a, b in zip(reads, want)) >= 10


def test_native_impure_reads():
    """Reads with N, lowercase and other bytes (the device never takes
    them) through the default chain, both directions."""
    rng = np.random.default_rng(8)
    genome = rng.choice(tc.BASES, size=3000).tobytes()
    reads = []
    for r in tc.fuzz_reads(rng, genome, 12, 3):
        r = bytearray(r)
        for _ in range(3):
            r[int(rng.integers(0, len(r)))] = int(rng.choice(
                np.frombuffer(b"Nnacgt-*", np.uint8)))
        reads.append(bytes(r))
    reads += [b"", b"N" * 40, genome[:200].lower()]
    jset = JSolidSet.from_sequences([genome], tc.K)
    for two_side in (False, True):
        _agree(jset, FULL, tc.C, tc.MS, reads, two_side)


@pytest.mark.parametrize("k", [21, 31])
def test_native_hash_set_matches_br_tpu(k):
    """A HashSet goes into the engine by br_create_hash: the port's
    engine on the port's HashSet, and br_tpu's on its own, give br_tpu's
    oracle's bytes at large k."""
    from br_tpu.set.hash import HashSet as JHashSet
    from br_tpu_torch.set.hash import HashSet

    g, reads = tc.hash_cases(k)
    reads = reads[:-1]   # the long read: covered at k = 21 elsewhere
    jset = JHashSet.from_sequences([g], k)
    mine = NativeCorrector(HashSet.from_sequences([g], k), FULL, tc.C,
                           tc.MS, threads=2)
    theirs = JNativeCorrector(jset, FULL, tc.C, tc.MS, threads=2)
    methods = j_build_methods(FULL, jset, tc.C, tc.MS)
    for two_side in (False, True):
        want = [j_correct_read(r, methods, two_side) for r in reads]
        assert mine.correct_batch(reads, two_side) == want
        assert theirs.correct_batch(reads, two_side) == want
    assert sum(a != b for a, b in zip(want, reads)) >= 8


def test_native_takes_only_the_ports_solid_set():
    jset = JSolidSet.from_sequences([b"ACGTTGCAAGGCTTAC" * 4], 13)
    with pytest.raises(TypeError, match="SolidSet"):
        NativeCorrector(jset, ["one"], 5, 7, threads=1)


def _host_route_reads():
    """(genome, reads): fuzz reads the device finishes; reads with nested
    substitutions 8 bases apart, whose site overflows SLOTS records on
    both profiles (capped after the wide retry); an impure read; a read
    too long for a 2^14 chunk."""
    rng = np.random.default_rng(21)
    genome = rng.choice(tc.BASES, size=20000).tobytes()
    reads = tc.fuzz_reads(rng, genome, 12, 4)
    for j in range(4):
        lo = int(rng.integers(0, 3400))
        r = bytearray(genome[lo : lo + 400])
        for t in range(10 + j):
            p = 60 + 8 * t
            r[p] = ord("ACTG"[("ACTG".index(chr(r[p])) + 1) % 4])
        reads.append(bytes(r))
    r = bytearray(reads[0])
    r[len(r) // 2] = ord("N")
    reads.append(bytes(r))
    long_read = bytearray(genome[:15000])
    for p in range(500, 15000, 700):
        long_read[p] = ord("ACTG"[("ACTG".index(chr(long_read[p])) + 1) % 4])
    reads.append(bytes(long_read))
    return genome, reads


def test_host_reads_go_to_the_native_engine(monkeypatch):
    """Torch3Corrector on the CPU (plain versions, 2^14 chunks): impure,
    too-long and capped-again reads are corrected by the native engine,
    which the wide sibling shares; the output is br_tpu's oracle's."""
    genome, reads = _host_route_reads()
    seen = []
    real = NativeCorrector.correct_batch

    def spy(self, seqs, two_side):
        seen.append((id(self), list(seqs)))
        return real(self, seqs, two_side)

    monkeypatch.setattr(NativeCorrector, "correct_batch", spy)
    tcor = Torch3Corrector(SolidSet.from_sequences([genome], tc.K), ["one"],
                           tc.C, tc.MS, chunk=tc.CHUNK, nreads=tc.R,
                           device="cpu", threads=2)
    got = tcor.correct_batch(reads, two_side=False)
    methods = j_build_methods(["one"], JSolidSet.from_sequences([genome],
                                                                tc.K),
                              tc.C, tc.MS)
    assert got == [j_correct_read(r, methods, False) for r in reads]
    st = tcor.last_stats
    assert st["impure"] == 1 and st["too_long"] == 1, st
    assert st["capped"] >= 1 and st["wide_retried"] >= st["capped"], st
    assert tcor._get_wide().native_engine() is tcor.native_engine()
    assert {i for i, _ in seen} == {id(tcor.native_engine())}
    host = [s for _, batch in seen for s in batch]
    assert sorted(host) == sorted(reads[i] for i in tcor.last_host)
    assert len(host) == st["fallback"]


def test_engine_that_cannot_build_raises(monkeypatch, tmp_path):
    """No g++ and an empty build directory: the corrector's engine raises,
    and a batch with a host read raises too; nothing falls back to the
    Python oracle.  A source g++ refuses raises with its log."""
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "native")
    monkeypatch.setattr(build.shutil, "which", lambda name: None)
    solid = SolidSet.from_sequences([b"ACGTTGCAAGGCTTACGGATC" * 4], 13)
    tcor = Torch3Corrector(solid, ["one"], 5, 7, device="cpu")
    with pytest.raises(RuntimeError, match="g[+][+] not found"):
        tcor.native_engine()
    with pytest.raises(RuntimeError, match="g[+][+] not found"):
        tcor.correct_batch([b"ACGTNACGT" * 5], two_side=False)
    assert not (tmp_path / "native").exists()

    monkeypatch.undo()
    bad = tmp_path / "broken.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "native")
    monkeypatch.setattr(build, "SRC", bad)
    monkeypatch.setattr(native, "_LIBS", {})
    with pytest.raises(RuntimeError, match="g[+][+] failed.*broken.cpp"):
        NativeCorrector(solid, ["one"], 5, 7, threads=1)
    assert list((tmp_path / "native").iterdir()) == []
