"""The reference's solid set and oracle: hand-worked cases, and the
port's own host set and oracle on a small corpus (tests may import the
port; the reference may not)."""

import numpy as np
import pytest

from portbench import corpus
from portbench.reference import codec, correct, kmers, oracle
from portbench.tests.test_portbench_corpus import MODEL

ACG = 0b000111  # A=0 C=1 G=3: odd popcount
CGT = 0b011110  # its reverse complement: even popcount, the canonical


def test_codec_hand_worked():
    assert codec.seq2bit(b"ACG") == ACG
    assert codec.kmer2seq(CGT, 3) == b"CGT"
    arr = np.array([ACG, CGT], np.uint64)
    assert codec.revcomp_np(arr, 3).tolist() == [CGT, ACG]
    # the canonical k-mer of a read's window is the even-popcount one
    assert kmers._block_kmers([b"ACG", b"CGT"], 3).tolist() == [CGT, CGT]


@pytest.mark.parametrize("reads,a,want", [
    ([b"ACGT"], 1, [CGT]),           # ACG and CGT: one k-mer seen twice
    ([b"ACGT"], 2, []),              # solid only above the abundance
    ([b"ACG", b"CGT", b"CG"], 1, [CGT]),  # a read shorter than k adds none
    ([b"AC", b"GT"], 0, []),         # no k-mer across two reads
    ([b"AAAAA"], 2, [0]),            # AAA x3: popcount 0, itself canonical
])
def test_solid_set_hand_worked(reads, a, want):
    assert kmers.solid_canonical(reads, 3, a).tolist() == want


def test_forward_set_holds_both_orientations():
    fs = kmers.ForwardSet(3, np.array([CGT], np.uint64))
    assert fs.get(ACG) and fs.get(CGT) and not fs.get(0)
    assert len(fs) == 2


def test_oracle_repairs_a_planted_substitution():
    rng = np.random.default_rng(3)
    genome = bytes(np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, 400)])
    k = 11
    canon = kmers.solid_canonical([genome] * 3, k, 2)
    valid = kmers.ForwardSet(k, canon)
    read = bytearray(genome)
    read[200] = b"A"[0] if read[200] != b"A"[0] else b"C"[0]
    methods = oracle.build_methods(["one"], valid, 5, 7)
    assert oracle.correct_read(bytes(read), methods, False) == genome


def _corpus(n=40):
    recs = corpus.make_corpus(n, 30_000, dict(
        MODEL, length=dict(MODEL["length"], mean=700, max=2000)), 11)
    return [s for _d, s in recs]


@pytest.mark.parametrize("k", [3, 5, 11, 13, 15, 17, 21, 31])
def test_kmers_equal_the_ports_canonical_kmers(k):
    from br_tpu_torch import codec as port

    seqs = _corpus(6) + [b"ACG"[: k - 1]]
    want = [port.canonical_np(port.rolling_kmers_np(
        port.encode_ascii_np(np.frombuffer(s, np.uint8)), k), k)
        for s in seqs if len(s) >= k]
    assert np.array_equal(kmers._block_kmers(seqs, k), np.concatenate(want))


def test_reference_matches_the_ports_host_set_and_oracle():
    from br_tpu_torch.correct import build_methods, correct_read
    from br_tpu_torch.count.counter import Counter

    k, seqs = 13, _corpus()
    canon = kmers.solid_canonical(seqs, k, 2)
    port = Counter(k).count_sequences(seqs).to_solid(2)
    idx = np.flatnonzero(np.unpackbits(port.bits, bitorder="little"))
    assert np.array_equal(idx.astype(np.uint64), canon >> np.uint64(1))
    chosen = list(range(0, 40, 5))
    got, names = correct.correct_reads(seqs, chosen, k, 2,
                                       oracle.METHOD_NAMES, 5, 7, False, 2)
    assert not names & {"torch", "br_tpu_torch", "br_tpu", "jax"}
    methods = build_methods(list(oracle.METHOD_NAMES), port, 5, 7)
    assert sorted(got) == chosen
    for i in chosen:
        assert got[i] == correct_read(seqs[i], methods, False)
