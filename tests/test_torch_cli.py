"""The port's CLI refuses a solid bitfield above k = 17 (``large-kmer``
takes larger k) with one error line and a non-zero exit code: for
``fasta`` before anything is counted, for ``solid`` and ``count`` as
soon as the set is loaded; an even k still rounds down to the odd k
below it.  ``fasta -a`` builds the solid set on the corrector's device
(the plain version of K8 on the CPU), k = 17 included, and no host
Counter.  ``large-kmer`` runs (tests/test_torch_hash.py)."""

import numpy as np
import pytest

from br_tpu_torch import cli


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
