"""The port's batch corrector and CLI (on the CPU) against the JAX
package's oracle and CLI, and the port's corpus generator against
scripts/make_corpus.py.

``Torch3Corrector(..., device="cpu")`` runs the kernels' plain versions;
``br_tpu``'s ``correct_read`` is the reference semantics.  The live
comparison with ``Tpu3Corrector`` is in the slow tier: its pass compiles
for about 12 minutes on the CPU."""

import os
import subprocess
import sys

import numpy as np
import pytest

import torch_cases as tc
from br_tpu.correct import build_methods as j_build_methods
from br_tpu.correct import correct_read as j_correct_read
from br_tpu.set.solid import SolidSet as JSolidSet
from br_tpu_torch.correct.engine3 import Torch3Corrector
from br_tpu_torch.set.solid import SolidSet

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _reads(seed, n=24, err=6, genome=None, cluster_gap=None):
    rng = np.random.default_rng(seed)
    if genome is None:
        genome = rng.choice(tc.BASES, size=4000).tobytes()
    reads = tc.fuzz_reads(rng, genome, n, err, cluster_gap=cluster_gap)
    return genome, reads


def _want(genome, reads, two_side, k=tc.K):
    solid = JSolidSet.from_sequences([genome], k)
    methods = j_build_methods(["one"], solid, tc.C, tc.MS)
    return [j_correct_read(r, methods, two_side) for r in reads]


@pytest.mark.parametrize("two_side", [False, True])
@pytest.mark.parametrize("family", ["uniform", "repeat_rich", "clustered"])
def test_corrector_matches_oracle(family, two_side):
    seed = {"uniform": 9, "repeat_rich": 123, "clustered": 321}[family]
    g = None
    if family != "uniform":
        g = tc.repeat_rich_genome(np.random.default_rng(seed))
    genome, reads = _reads(seed, genome=g,
                           cluster_gap=tc.K + 1 if family == "clustered"
                           else None,
                           err=2 if family == "clustered" else 6)
    solid = SolidSet.from_sequences([genome], tc.K)
    tcor = Torch3Corrector(solid, ["one"], tc.C, tc.MS, chunk=tc.CHUNK,
                           nreads=tc.R, device="cpu")
    got = tcor.correct_batch(reads, two_side)
    want = _want(genome, reads, two_side)
    assert got == want
    assert sum(a != b for a, b in zip(reads, want)) >= 10
    assert tcor.last_stats["fallback"] == 0, tcor.last_stats


def test_corrector_host_routes_are_counted():
    """Impure reads (lowercase, N) and a read too long for a chunk go to
    the host oracle, and last_stats counts every one of them."""
    rng = np.random.default_rng(5)
    genome = rng.choice(tc.BASES, size=20000).tobytes()
    reads = tc.fuzz_reads(rng, genome, 40, 4)
    r = bytearray(reads[0])
    r[len(r) // 2] = ord("n")
    r[len(r) // 3] = ord("a")
    reads[0] = bytes(r)
    long_read = bytearray(genome[:15000])
    for p in range(500, 15000, 700):
        long_read[p] = ord("ACTG"[("ACTG".index(chr(long_read[p])) + 1) % 4])
    reads.append(bytes(long_read))
    solid = SolidSet.from_sequences([genome], tc.K)
    tcor = Torch3Corrector(solid, ["one"], tc.C, tc.MS, chunk=tc.CHUNK,
                           nreads=tc.R, device="cpu")
    got = tcor.correct_batch(reads, two_side=False)
    assert got == _want(genome, reads, False)
    st = tcor.last_stats
    assert st["impure"] == 1 and st["too_long"] == 1
    assert st["fallback"] == st["impure"] + st["too_long"] + st["capped"]
    assert st["total"] == len(reads) and st["chunks"] == 2


def test_capped_reads_retry_on_the_device():
    """With 30 % of the k-mer space solid, random reads make a transition
    at ~1 position in 5, so each chunk's sites overflow NS and cap its
    later reads.  Those retry once on the sibling with the wide slot
    headroom (fewer reads per chunk, engine3.py:2235-2250) and stay on the
    device; the output is still the oracle's."""
    k = 11
    rng = np.random.default_rng(12)
    bits = np.packbits(rng.random(1 << (2 * k - 1)) < 0.3,
                       bitorder="little")
    reads = [rng.choice(tc.BASES, size=int(rng.integers(300, 500))).tobytes()
             for _ in range(40)]
    tcor = Torch3Corrector(SolidSet(k, bits.copy()), ["one"], tc.C, tc.MS,
                           chunk=tc.CHUNK, nreads=tc.R, device="cpu")
    got = tcor.correct_batch(reads, two_side=False)
    methods = j_build_methods(["one"], JSolidSet(k, bits.copy()), tc.C,
                              tc.MS)
    assert got == [j_correct_read(r, methods, False) for r in reads]
    st = tcor.last_stats
    assert st["wide_retried"] >= 5, st
    assert st["fallback"] == st["capped"] < st["wide_retried"]
    assert tcor.last_host == [] or st["capped"] == len(tcor.last_host)


def test_corrector_rejects_unported_strategies():
    """Every strategy of br is ported; a name outside them is refused."""
    solid = SolidSet.from_sequences([b"ACGT" * 10], tc.K)
    Torch3Corrector(solid, ["one", "two", "graph", "greedy", "gap_size"], 5,
                    7, chunk=1 << 12, nreads=8, device="cpu")
    with pytest.raises(ValueError, match="unknown correction strategy"):
        Torch3Corrector(solid, ["one", "three"], 5, 7, device="cpu")


def test_cli_matches_br_tpu_cli(tmp_path):
    """The port's CLI and br_tpu's CLI (oracle backend) write the same
    bytes for `-c one ... fasta -k 13 -a 2`, with and without -s."""
    from br_tpu.cli import main as j_main
    from br_tpu_torch.cli import main as t_main
    from br_tpu_torch.corpus import write_corpus

    fa = str(tmp_path / "reads.fa")
    write_corpus(fa, reads=60, genome_size=8000, mean_len=900,
                 max_len=3000, seed=7)
    for extra in ([], ["-s"]):
        a, b = str(tmp_path / "port.fa"), str(tmp_path / "jax.fa")
        common = ["-i", fa, "-c", "one", *extra]
        assert t_main([*common, "-o", a, "--device", "cpu", "fasta", "-i",
                       fa, "-k", "13", "-a", "2"]) == 0
        assert j_main([*common, "-o", b, "--backend", "oracle", "fasta",
                       "-i", fa, "-k", "13", "-a", "2"]) == 0
        with open(a, "rb") as fa_, open(b, "rb") as fb_:
            pa, pb = fa_.read(), fb_.read()
        assert pa == pb and pa.count(b">") == 60


def test_cli_refuses_unported_chain(tmp_path, capsys):
    """A -c outside br's five strategies is refused before anything
    runs (argparse's usage error)."""
    from br_tpu_torch.cli import main as t_main

    fa = tmp_path / "r.fa"
    fa.write_bytes(b">r\nACGTACGTACGTACGTACGT\n")
    with pytest.raises(SystemExit) as e:
        t_main(["-i", str(fa), "-o", str(tmp_path / "o.fa"), "-c", "three",
                "--device", "cpu", "fasta", "-i", str(fa), "-k", "13", "-a",
                "2"])
    assert e.value.code == 2
    assert "invalid choice: 'three'" in capsys.readouterr().err
    assert not (tmp_path / "o.fa").exists()


def test_corpus_matches_script(tmp_path):
    from br_tpu_torch.corpus import write_corpus

    a, b = str(tmp_path / "a.fa"), str(tmp_path / "b.fa")
    write_corpus(a, reads=30, genome_size=50000, mean_len=2000,
                 max_len=9000, seed=3)
    subprocess.run([sys.executable, os.path.join(REPO, "scripts",
                                                 "make_corpus.py"),
                    "-o", b, "--reads", "30", "--genome-size", "50000",
                    "--mean-len", "2000", "--max-len", "9000", "--seed",
                    "3"], check=True, capture_output=True)
    with open(a, "rb") as fa_, open(b, "rb") as fb_:
        assert fa_.read() == fb_.read()


@pytest.mark.slow
@pytest.mark.parametrize("two_side", [False, True])
def test_corrector_matches_tpu3_corrector(two_side):
    """The same reads through br_tpu's Tpu3Corrector (about 12 minutes of
    XLA compile on the CPU) and the port."""
    from br_tpu.correct.engine3 import Tpu3Corrector

    genome, reads = _reads(9)
    got = Torch3Corrector(SolidSet.from_sequences([genome], tc.K), ["one"],
                          tc.C, tc.MS, chunk=tc.CHUNK, nreads=tc.R,
                          device="cpu").correct_batch(reads, two_side)
    jc = Tpu3Corrector(JSolidSet.from_sequences([genome], tc.K), ["one"],
                       tc.C, tc.MS, chunk=tc.CHUNK, nreads=tc.R)
    assert got == jc.correct_batch(reads, two_side)
