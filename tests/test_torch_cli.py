"""The port's CLI refuses a solid bitfield above k = 17 (``large-kmer``
takes larger k) with one error line and a non-zero exit code: for
``fasta`` before anything is counted, for ``solid`` and ``count`` as
soon as the set is loaded; an even k still rounds down to the odd k
below it.  ``fasta -a`` builds the solid set on the corrector's device
(the plain version of K8 on the CPU), k = 17 included, and no host
Counter.  ``large-kmer`` runs (tests/test_torch_hash.py).

The backends give br_tpu's CLI's bytes: ``--backend native`` and
``oracle`` on the host, with no CUDA, ``torch`` (and ``auto``) on the
device corrector, which never hands the run to a host backend; ``-T``
stamps every log line as br_tpu's CLI does."""

import fcntl
import logging
import re

import numpy as np
import pytest
import torch

from br_tpu import cli as j_cli
from br_tpu_torch import cli
from br_tpu_torch.corpus import write_corpus


class _NoCounter:
    def __init__(self, k):
        raise AssertionError(f"a Counter was built at k={k}")


def _reads(tmp_path):
    fa = tmp_path / "r.fa"
    fa.write_bytes(b">r\nACGTTGCAAGGCTTACGGATCCATGACGTTGCAAGGCTTAC\n")
    return str(fa)


class _SpyBuilder:
    """Records the k of every device build."""

    built: list = []

    def __init__(self, k, device):
        from br_tpu_torch.set.device_build import SolidBuilder

        self.built.append(k)
        self._b = SolidBuilder(k, device)

    def add(self, seqs):
        self._b.add(seqs)

    def finish(self, a):
        return self._b.finish(a)


@pytest.mark.parametrize("device", [[], ["--device", "cpu"]])
@pytest.mark.parametrize("k", ["19", "20", "31"])
def test_fasta_k_above_17_refused_before_counting(monkeypatch, tmp_path,
                                                  capsys, k, device):
    fa = _reads(tmp_path)
    out = tmp_path / "o.fa"
    monkeypatch.setattr(cli, "Counter", _NoCounter)
    monkeypatch.setattr(cli, "SolidBuilder", _NoCounter)
    rc = cli.main(["-i", fa, "-o", str(out), *device, "fasta", "-i", fa,
                   "-k", k, "-a", "2"])
    err = capsys.readouterr().err
    assert rc != 0
    assert err.count("\n") == 1 and err.startswith("error: k=")
    assert "Traceback" not in err and "large-kmer" in err
    assert not out.exists()


def test_fasta_k16_still_runs_at_k15(monkeypatch, tmp_path, capsys):
    fa = _reads(tmp_path)
    monkeypatch.setattr(cli, "Counter", _NoCounter)
    monkeypatch.setattr(_SpyBuilder, "built", [])
    monkeypatch.setattr(cli, "SolidBuilder", _SpyBuilder)
    outs = []
    for k in ("16", "15"):
        out = tmp_path / f"o{k}.fa"
        assert cli.main(["-i", fa, "-o", str(out), "--device", "cpu", "-c",
                         "one", "fasta", "-i", fa, "-k", k, "-a", "0"]) == 0
        outs.append(out.read_bytes())
    assert _SpyBuilder.built == [15, 15]
    assert outs[0] == outs[1] and outs[0].startswith(b">r\n")
    assert capsys.readouterr().err == ""


@pytest.fixture(scope="module")
def k17_genome():
    """A 300-base genome and the port's oracle of ``-c one`` on its
    k = 17 set (the module's one 1 GiB field)."""
    from br_tpu_torch.correct.reference import build_methods
    from br_tpu_torch.set.solid import SolidSet

    rng = np.random.default_rng(17)
    genome = rng.choice(np.frombuffer(b"ACGT", np.uint8), 300).tobytes()
    return genome, build_methods(
        ["one"], SolidSet.from_sequences([genome], 17), 5, 7)


@pytest.mark.parametrize("k", ["17", "18"])
def test_fasta_k17_runs_with_the_device_set(monkeypatch, tmp_path, capsys,
                                            k17_genome, k):
    """``fasta -k 17 -a 2`` (and ``-k 18``, which rounds down to 17)
    corrects on the CPU with the set built by the plain K8, no host
    Counter; a read with one substitution is repaired, as the port's
    oracle repairs it."""
    from br_tpu_torch.correct.reference import correct_read

    genome, methods = k17_genome
    read = bytearray(genome[20:220])
    read[100] = ord("A") if read[100] != ord("A") else ord("C")
    fa = tmp_path / "r.fa"
    fa.write_bytes(b"".join(b">g%d\n%s\n" % (i, genome) for i in range(3))
                   + b">r\n" + bytes(read) + b"\n")
    monkeypatch.setattr(cli, "Counter", _NoCounter)
    monkeypatch.setattr(_SpyBuilder, "built", [])
    monkeypatch.setattr(cli, "SolidBuilder", _SpyBuilder)
    out = tmp_path / "o.fa"
    assert cli.main(["-i", str(fa), "-o", str(out), "--device", "cpu",
                     "--line-width", "0", "-c", "one", "fasta", "-i",
                     str(fa), "-k", k, "-a", "2"]) == 0
    assert _SpyBuilder.built == [17]
    got = out.read_bytes().split(b"\n")
    assert got[7] == correct_read(bytes(read), methods, False)
    assert got[7] == genome[20:220] and got[1] == got[5] == genome
    assert capsys.readouterr().err == ""


@pytest.mark.parametrize("sub", [["solid", "-f", "solid"], ["count"]])
def test_loaded_set_above_17_refused_before_correcting(monkeypatch, tmp_path,
                                                       capsys, sub):
    """k is known only once the set is loaded: refused right after
    build_set, before a corrector is made."""
    class K19:
        k = 19

    def no_run(*a, **kw):
        raise AssertionError("run_correction was called")

    fa = _reads(tmp_path)
    monkeypatch.setattr(cli, "build_set", lambda args: K19())
    monkeypatch.setattr(cli, "run_correction", no_run)
    rc = cli.main(["-i", fa, "-o", str(tmp_path / "o.fa"), "--device", "cpu",
                   sub[0], "-i", str(tmp_path / "set"), *sub[1:]])
    err = capsys.readouterr().err
    assert rc != 0 and err.count("\n") == 1 and err.startswith("error: k=19")


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """A seeded corpus of 30 reads (~400 bases, 4x of a 3 kb genome) with
    both native engines built, one test worker at a time (br_tpu's build
    writes its library in place)."""
    from br_tpu.native import get_lib
    from br_tpu_torch.native import build, get_lib as t_get_lib

    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(build.BUILD_DIR / "tests.lock", "w") as fh:
        fcntl.flock(fh, fcntl.LOCK_EX)
        get_lib()
        t_get_lib()
    fa = tmp_path_factory.mktemp("backends") / "r.fa"
    write_corpus(str(fa), 30, 3000, 400, 900, 7)
    return str(fa)


#: the chains the backends are compared on: -c one and the default one
CHAINS = {"one": ["-c", "one"], "default": []}
_BR_TPU: dict = {}


def _set_args(fa):
    return ["fasta", "-i", fa, "-k", "11", "-a", "1"]


def br_tpu_bytes(fa, chain, tmp_path):
    """br_tpu's CLI's output on ``fa`` for ``chain``: its native and its
    oracle backend, which must agree."""
    if (fa, chain) not in _BR_TPU:
        outs = []
        for backend in ("native", "oracle"):
            out = tmp_path / f"br_tpu_{backend}.fa"
            assert j_cli.main(["-i", fa, "-o", str(out), "-t", "2",
                               *CHAINS[chain], "--backend", backend,
                               *_set_args(fa)]) == 0
            outs.append(out.read_bytes())
        assert outs[0] == outs[1]
        _BR_TPU[fa, chain] = outs[0]
    return _BR_TPU[fa, chain]


@pytest.mark.parametrize("backend", [["--backend", "native"],
                                     ["--backend", "oracle"],
                                     ["--backend", "torch", "--device",
                                      "cpu"]])
@pytest.mark.parametrize("chain", list(CHAINS))
def test_backends_match_br_tpu(corpus, tmp_path, capsys, chain, backend):
    out = tmp_path / "o.fa"
    assert cli.main(["-i", corpus, "-o", str(out), "-t", "2",
                     *CHAINS[chain], *backend, *_set_args(corpus)]) == 0
    want = br_tpu_bytes(corpus, chain, tmp_path)
    assert out.read_bytes() == want
    assert want != open(corpus, "rb").read()
    assert capsys.readouterr().err == ""


@pytest.mark.parametrize("backend", ["native", "oracle"])
def test_host_backend_needs_no_cuda(monkeypatch, corpus, tmp_path, capsys,
                                    backend):
    """A host backend with the default --device: no CUDA check, no device
    and no device set build (the host Counter, as br_tpu's CLI)."""
    from br_tpu_torch.correct import engine3

    def no_device(device):
        raise AssertionError("a device was resolved")

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(engine3, "resolve_device", no_device)
    monkeypatch.setattr(cli, "SolidBuilder", _NoCounter)
    out = tmp_path / "o.fa"
    assert cli.main(["-i", corpus, "-o", str(out), "-t", "2", "-c", "one",
                     "--backend", backend, *_set_args(corpus)]) == 0
    assert out.read_bytes() == br_tpu_bytes(corpus, "one", tmp_path)
    assert capsys.readouterr().err == ""


@pytest.mark.parametrize("backend", [[], ["--backend", "auto"],
                                     ["--backend", "torch"]])
def test_device_backend_without_cuda_exits_1(monkeypatch, tmp_path, capsys,
                                             backend):
    """auto and torch never run a host backend in place of the device."""
    import br_tpu_torch.native as native

    def no_host(*a, **kw):
        raise AssertionError("a host backend was made")

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(native, "NativeCorrector", no_host)
    monkeypatch.setattr(cli, "build_set", no_host)
    fa = _reads(tmp_path)
    out = tmp_path / "o.fa"
    assert cli.main(["-i", fa, "-o", str(out), *backend, "fasta", "-i", fa,
                     "-k", "13", "-a", "2"]) == 1
    err = capsys.readouterr().err
    assert err.count("\n") == 1 and "CUDA is not available" in err
    assert not out.exists()


@pytest.mark.parametrize("unit", ["sec", "ms", "ns"])
def test_timestamp_format_matches_br_tpu(unit):
    record = logging.LogRecord("br_tpu_torch", logging.INFO, __file__, 1,
                               "stage %s", ("correct",), None)
    record.created = 1_700_000_000.123456789
    record.msecs = 123.456789
    mine = cli._TimestampFormatter(unit).format(record)
    theirs = j_cli._TimestampFormatter(unit).format(record)
    assert mine == theirs
    assert mine.endswith(" INFO br_tpu_torch: stage correct")


def test_timestamp_ms_stamps_every_line(tmp_path, capsys):
    """``-v -T ms``: every stderr line starts with a millisecond stamp;
    the run ends with one report line a stage."""
    from br_tpu_torch import profiling

    profiling.reset_stages()
    fa = _reads(tmp_path)
    assert cli.main(["-v", "-T", "ms", "-i", fa, "-o",
                     str(tmp_path / "o.fa"), "--device", "cpu", "-c", "one",
                     "fasta", "-i", fa, "-k", "11", "-a", "0"]) == 0
    logging.getLogger().handlers[:] = []
    lines = capsys.readouterr().err.splitlines()
    stamp = r"\d{4}-\d\d-\d\dT\d\d:\d\d:\d\d\.\d{3} INFO br_tpu_torch: "
    assert lines and all(re.match(stamp, ln) for ln in lines), lines
    stages = [m.group(1) for ln in lines
              if (m := re.match(stamp + r"stage (\S+) +\d+\.\d{3}s +1 calls$",
                                ln))]
    assert sorted(stages) == ["build-set", "correct", "write"]
