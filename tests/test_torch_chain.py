"""The port's default correction chain (one, two, graph, greedy,
gap-size) end to end on the CPU: ``Torch3Corrector`` and the CLI against
the port's oracle and ``br_tpu``'s, the single-strategy chains, the wide
walk profile's retries, and the reference catalog through the passes.

The slow tier recomputes the JAX recordings the pass tests read."""

import numpy as np
import pytest

import torch_cases as tc
from br_tpu.correct import build_methods as j_build_methods
from br_tpu.correct import correct_read as j_correct_read
from br_tpu.set.solid import SolidSet as JSolidSet
from br_tpu_torch.correct.engine3 import Torch3Corrector
from br_tpu_torch.correct.reference import build_methods, correct_read
from br_tpu_torch.set.solid import SolidSet

FULL = ["one", "two", "graph", "greedy", "gap-size"]


def _check(chain, genome, reads, two_side, chunk=tc.CHUNK, nreads=tc.R,
           c=tc.C, ms=tc.MS, solid=None):
    """The port's corrector (plain versions) against both oracles;
    returns its last_stats."""
    solid = solid or SolidSet.from_sequences([genome], tc.K)
    tcor = Torch3Corrector(solid, chain, c, ms, chunk=chunk, nreads=nreads,
                           device="cpu")
    got = tcor.correct_batch(reads, two_side)
    mine = build_methods(chain, solid, c, ms)
    assert got == [correct_read(r, mine, two_side) for r in reads]
    if genome is not None:
        theirs = j_build_methods(chain, JSolidSet.from_sequences([genome],
                                                                 tc.K), c, ms)
        assert got == [j_correct_read(r, theirs, two_side) for r in reads]
    return tcor.last_stats


@pytest.mark.parametrize("two_side", [False, True])
def test_default_chain_matches_oracles(two_side):
    """The production chain, forward and (without -s) reversed, on a
    repeat-rich genome with uniform and clustered errors: every read
    finished on the device."""
    rng = np.random.default_rng(9)
    genome = tc.repeat_rich_genome(rng)
    reads = (tc.fuzz_reads(rng, genome, 16, 6)
             + tc.fuzz_reads(rng, genome, 8, 2, cluster_gap=tc.K + 1))
    st = _check(FULL, genome, reads, two_side)
    assert st["fallback"] == 0, st


@pytest.mark.parametrize("strategy", FULL)
def test_single_strategy_chains(strategy):
    """Each strategy alone (tests/test_engine3.py:116-119)."""
    rng = np.random.default_rng(42)
    genome = rng.choice(tc.BASES, size=4000).tobytes()
    st = _check([strategy], genome, tc.fuzz_reads(rng, genome, 16, 3), True)
    assert st["fallback"] == 0, st


def test_long_walk_accept_via_wide_retry():
    """A 400-base deletion: graph walks ~400 unique steps to
    first_correct, which caps at the default walk_max; the wide sibling
    (walk_max 2040) finishes the read on the device
    (tests/test_engine3.py:267)."""
    rng = np.random.default_rng(1234)
    gA = rng.choice(tc.BASES, size=2400).tobytes()
    reads = [gA[:500] + gA[900:1500]]
    st = _check(["graph"], gA, reads, True, nreads=8)
    assert st["wide_retried"] > 0 and st["capped"] == 0, st
    assert st["fallback"] == 0, st


def test_long_gap_fill_via_wide_retry():
    """A 400-base invalid stretch: gap-size fills more than walk_max
    bases, which caps at the default profile; the wide sibling fills it on
    the device (tests/test_engine3.py:289)."""
    rng = np.random.default_rng(4321)
    gA = rng.choice(tc.BASES, size=3000).tobytes()
    garbage = rng.choice(tc.BASES, size=400).tobytes()
    reads = [gA[:600] + garbage + gA[600 + 400:1800]]
    st = _check(["gap-size"], gA, reads, True, nreads=8)
    assert st["wide_retried"] > 0 and st["capped"] == 0, st
    assert st["fallback"] == 0, st


@pytest.mark.parametrize("method", FULL)
def test_catalog_through_passes(method):
    """The reference's planted-error catalog (tests/catalog.py), including
    DCI's zero-emit record, through the port's passes: the oracle's
    answer, every read finished on the device
    (tests/test_engine3.py:307)."""
    from catalog import CASES, filt

    from br_tpu_torch import codec

    seen = 0
    for (name, m, kwargs, k, refe, read, extra, expect) in CASES:
        if m != method:
            continue
        refe, read = filt(refe), filt(read)
        s = SolidSet(k)
        for seq in [refe, *extra]:
            for kmer in codec.tokenize(seq, k):
                s.set(kmer, True)
        c = kwargs.get("c", kwargs.get("nb_validate", 2))
        ms = kwargs.get("max_search", 7)
        st = _check([method], None, [read, refe], True, chunk=1 << 12,
                    nreads=8, c=c, ms=ms, solid=s)
        assert st["fallback"] == 0, (name, st)
        seen += 1
    assert seen >= 3


@pytest.mark.parametrize("two_side", [False, True])
def test_cli_default_chain_matches_br_tpu_cli(tmp_path, two_side):
    """The port's CLI with no -c (the default chain) and br_tpu's CLI
    (oracle backend) write the same bytes for `fasta -k 13 -a 2`."""
    from br_tpu.cli import main as j_main
    from br_tpu_torch.cli import main as t_main
    from br_tpu_torch.corpus import write_corpus

    fa = str(tmp_path / "reads.fa")
    write_corpus(fa, reads=40, genome_size=6000, mean_len=700, max_len=2000,
                 seed=7)
    a, b = str(tmp_path / "port.fa"), str(tmp_path / "jax.fa")
    extra = ["-s"] if two_side else []
    assert t_main(["-i", fa, "-o", a, *extra, "--device", "cpu", "fasta",
                   "-i", fa, "-k", "13", "-a", "2"]) == 0
    assert j_main(["-i", fa, "-o", b, *extra, "--backend", "oracle",
                   "fasta", "-i", fa, "-k", "13", "-a", "2"]) == 0
    with open(a, "rb") as fa_, open(b, "rb") as fb_, open(fa, "rb") as fi:
        pa, pb, pi = fa_.read(), fb_.read(), fi.read()
    assert pa == pb and pa.count(b">") == 40 and pa != pi


@pytest.mark.slow
@pytest.mark.parametrize("strategy", ["two", "graph", "gap-size", "greedy"])
def test_recording_is_jax_pass_output(strategy):
    """Recompute a strategy's recording with br_tpu's pass."""
    fresh = tc.record(strategy)
    golden = tc.load_golden(tc.golden_path(strategy))
    assert sorted(fresh) == sorted(golden)
    for name, arrs in fresh.items():
        for a, b in zip(arrs, golden[name]):
            assert np.array_equal(a, b), (strategy, name)
