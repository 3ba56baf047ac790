"""The port's CLI refuses a k its device path cannot take (above 15)
with one error line and a non-zero exit code: for ``fasta`` before the
host builds a Counter (2^33 bytes at k = 17), for ``solid`` and ``count``
as soon as the set is loaded; an even k still rounds down to the odd k
below it."""

import pytest

from br_tpu_torch import cli
from br_tpu_torch.count import Counter


class _NoCounter:
    def __init__(self, k):
        raise AssertionError(f"a Counter was built at k={k}")


def _reads(tmp_path):
    fa = tmp_path / "r.fa"
    fa.write_bytes(b">r\nACGTTGCAAGGCTTACGGATCCATGACGTTGCAAGGCTTAC\n")
    return str(fa)


@pytest.mark.parametrize("device", [[], ["--device", "cpu"]])
@pytest.mark.parametrize("k", ["17", "18", "31"])
def test_fasta_k_above_15_refused_before_counting(monkeypatch, tmp_path,
                                                  capsys, k, device):
    fa = _reads(tmp_path)
    out = tmp_path / "o.fa"
    monkeypatch.setattr(cli, "Counter", _NoCounter)
    rc = cli.main(["-i", fa, "-o", str(out), *device, "fasta", "-i", fa,
                   "-k", k, "-a", "2"])
    err = capsys.readouterr().err
    assert rc != 0
    assert err.count("\n") == 1 and err.startswith("error: k=")
    assert "Traceback" not in err and "ROADMAP A4" in err
    assert not out.exists()


def test_fasta_k16_still_runs_at_k15(monkeypatch, tmp_path, capsys):
    fa = _reads(tmp_path)
    built = []

    class Spy(Counter):
        def __init__(self, k):
            built.append(k)
            super().__init__(k)

    monkeypatch.setattr(cli, "Counter", Spy)
    outs = []
    for k in ("16", "15"):
        out = tmp_path / f"o{k}.fa"
        assert cli.main(["-i", fa, "-o", str(out), "--device", "cpu", "-c",
                         "one", "fasta", "-i", fa, "-k", k, "-a", "0"]) == 0
        outs.append(out.read_bytes())
    assert built == [15, 15]
    assert outs[0] == outs[1] and outs[0].startswith(b">r\n")
    assert capsys.readouterr().err == ""


@pytest.mark.parametrize("sub", [["solid", "-f", "solid"], ["count"]])
def test_loaded_set_above_15_refused_before_correcting(monkeypatch, tmp_path,
                                                       capsys, sub):
    """k is known only once the set is loaded: refused right after
    build_set, before a corrector is made."""
    class K17:
        k = 17

    def no_run(*a, **kw):
        raise AssertionError("run_correction was called")

    fa = _reads(tmp_path)
    monkeypatch.setattr(cli, "build_set", lambda args: K17())
    monkeypatch.setattr(cli, "run_correction", no_run)
    rc = cli.main(["-i", fa, "-o", str(tmp_path / "o.fa"), "--device", "cpu",
                   sub[0], "-i", str(tmp_path / "set"), *sub[1:]])
    err = capsys.readouterr().err
    assert rc != 0 and err.count("\n") == 1 and err.startswith("error: k=17")
