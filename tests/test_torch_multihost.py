"""The port's several-process path (``br_tpu_torch.parallel.multihost``)
against the JAX package, on the CPU.

Two processes join a ``gloo`` group over local TCP, each with the CPU
asked for as its device, and run the port only (no JAX in them).  The
parent holds their results against br_tpu's:

* ``count_stripe_merged`` equals br_tpu's host ``Counter(k, uint32)``;
* the striped and the ranged corrections, merged by process 0, are byte
  for byte br_tpu's single-process ``run_correction(..., backend=
  "native")``;
* the ranged path refuses FASTQ and compressed input.

Every child runs under its own time limit (``CHILD_TIMEOUT``); a child
that fails or is cut fails the test.
"""

import gzip
import os
import socket
import subprocess
import sys

import numpy as np
import pytest

from br_tpu.count import Counter as JCounter
from br_tpu.runtime import run_correction
from br_tpu.set.solid import SolidSet as JSolidSet
from br_tpu_torch.parallel.multihost import fasta_range_bounds
from br_tpu_torch.set.solid import SolidSet

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: seconds a child process may take
CHILD_TIMEOUT = 120
K = 11
CHAIN = ["one", "two"]


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _launch(code: str, n: int = 2):
    """Run ``code`` in n processes (argv: rank, n, port), each under
    CHILD_TIMEOUT; every one must exit 0."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    port = str(_free_port())
    procs = [subprocess.Popen([sys.executable, "-c", code, str(r), str(n),
                               port], cwd=REPO, env=env,
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(n)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=CHILD_TIMEOUT)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, o in zip(procs, outs):
        assert p.returncode == 0, o
    return outs


def _corpus(tmp_path):
    """13 reads (an odd count: uneven stripes) of a seeded genome with
    substitutions, written as FASTA wrapped at 60 columns; the genome's
    k-mers as the set, saved for the children."""
    rng = np.random.default_rng(11)
    bases = np.frombuffer(b"ACTG", np.uint8)
    genome = rng.choice(bases, 3000).tobytes()
    recs = []
    for i in range(13):
        st = int(rng.integers(0, 2500))
        read = bytearray(genome[st:st + int(rng.integers(80, 500))])
        for pos in rng.integers(0, len(read), 2):
            read[pos] = int(rng.choice(bases))
        seq = bytes(read)
        recs.append(b">r%d desc\n" % i + b"\n".join(
            seq[j:j + 60] for j in range(0, len(seq), 60)) + b"\n")
    fa = tmp_path / "in.fa"
    fa.write_bytes(b"".join(recs))
    SolidSet.from_sequences([genome], K).save(str(tmp_path / "set.solid"))
    return fa, JSolidSet.from_sequences([genome], K)


_CORRECT = """
import sys
rank, n, port = map(int, sys.argv[1:])
from br_tpu_torch.correct.engine3 import Torch3Corrector
Torch3Corrector.CHUNK = 1 << 12   # small chunks: the plain passes
Torch3Corrector.R = 8
from br_tpu_torch.parallel import multihost
from br_tpu_torch.set.solid import SolidSet
multihost.initialize(f"localhost:{port}", n, rank, local_device_ids=["cpu"],
                     timeout_s=60)
solid = SolidSet.load(%(set)r)
chain = %(chain)r
got = multihost.run_correction_striped(
    %(fa)r, %(striped)r, solid, chain, 5, 7, False, rank, n)
print("striped", rank, got)
got = multihost.run_correction_ranged(
    %(fa)r, %(ranged)r, solid, chain, 5, 7, False, rank, n)
print("ranged", rank, got)
multihost.shutdown()
"""


def test_striped_and_ranged_match_br_tpu(tmp_path):
    fa, jsolid = _corpus(tmp_path)
    striped, ranged = tmp_path / "striped.fa", tmp_path / "ranged.fa"
    outs = _launch(_CORRECT % {
        "set": str(tmp_path / "set.solid"), "chain": CHAIN, "fa": str(fa),
        "striped": str(striped), "ranged": str(ranged)})
    assert "striped 0 13" in outs[0] and "ranged 0 13" in outs[0], outs
    single = tmp_path / "single.fa"
    run_correction([str(fa)], [str(single)], jsolid, CHAIN, 5, 7, False,
                   backend="native")
    want = single.read_bytes()
    assert striped.read_bytes() == want
    assert ranged.read_bytes() == want
    assert want != fa.read_bytes()   # reads were corrected
    assert not list(tmp_path.glob("*.part*"))   # parts cleaned up


_COUNT = """
import sys
rank, n, port = map(int, sys.argv[1:])
import numpy as np
from br_tpu_torch.io.fasta import read_records
from br_tpu_torch.parallel import multihost
multihost.initialize(f"localhost:{port}", n, rank, local_device_ids=["cpu"],
                     timeout_s=60)
seqs = [s for _d, s, _q in read_records(%(fa)r)]
merged = multihost.count_stripe_merged(seqs, %(k)d, rank, n)
assert merged.dtype == np.uint32
np.save(%(out)r + str(rank) + ".npy", merged)
mesh = multihost.global_mesh()
assert mesh.size == n and str(mesh[rank]) == "cpu", mesh
multihost.shutdown()
print("count", rank, "ok")
"""


def test_count_stripe_merged_matches_br_tpu(tmp_path):
    fa, _ = _corpus(tmp_path)
    out = str(tmp_path / "merged")
    _launch(_COUNT % {"fa": str(fa), "k": K, "out": out})
    from br_tpu.io.fasta import read_records

    host = JCounter(K, count_dtype=np.uint32)
    host.count_sequences(s for _d, s, _q in read_records(str(fa)))
    for r in range(2):
        assert np.array_equal(np.load(f"{out}{r}.npy"), host.counts)
    assert host.counts.max() > 1


def test_ranged_rejects_fastq_and_compressed(tmp_path):
    fq = tmp_path / "in.fastq"
    fq.write_bytes(b"@r1\nACGT\n+\n>>>>\n@r2\nTTTT\n+\n!!!!\n")
    with pytest.raises(ValueError, match="FASTA"):
        fasta_range_bounds(str(fq), 0, 2)
    gz = tmp_path / "in.fa.gz"
    gz.write_bytes(gzip.compress(b">r\nACGT\n"))
    with pytest.raises(ValueError, match="uncompressed"):
        fasta_range_bounds(str(gz), 0, 2)
    fa = tmp_path / "in.fa"
    fa.write_bytes(b">a\nACGT\n>b\nTTTT\nGG\n>c\nA\n")
    bounds = [fasta_range_bounds(str(fa), p, 3) for p in range(3)]
    assert bounds[0][0] == 0 and bounds[-1][1] == fa.stat().st_size
    assert all(b[1] == c[0] for b, c in zip(bounds, bounds[1:]))
