"""The port's ``greedy`` pass (K1, K7 and K3 plain versions, on the CPU)
against the JAX package's recorded pass; the greedy attempt's alignment
tie-breaks against the oracle; and the port's ``Greedy`` and
``global_align_ops`` against ``br_tpu``'s.

The recordings (golden/torch_greedy_pass_k13.npz) hold br_tpu's pass at
k=13, CHUNK=2^14, R=32, c=5, ms=7 on seven chunk families."""

import numpy as np
import pytest
import torch

import torch_cases as tc
from br_tpu_torch import codec
from br_tpu_torch.correct import device_codec as dc
from br_tpu_torch.correct.greedy import greedy_attempt_plain, greedy_sites
from br_tpu_torch.correct.reference import Greedy
from br_tpu_torch.correct.sites import alt_last, window
from br_tpu_torch.set.solid import SolidSet


@pytest.fixture(scope="module")
def cases():
    return tc.all_cases()


@pytest.fixture(scope="module")
def golden():
    return tc.load_golden(tc.golden_path("greedy"))


@pytest.mark.parametrize("name", tc.FAMILIES)
def test_greedy_pass_matches_jax(cases, golden, name):
    g, codes, rstart, rlen = cases[name]
    got = tc.run_port_pass("greedy", cases[name])
    tc.assert_matches_recording(got, golden[name], rstart, rlen)


def _attempts_vs_oracle(genome: bytes, lanes, ms=tc.MS, nb=tc.C):
    """Each lane (read, i, register): the plain greedy attempt at read
    position i (all lanes in one call, the reads laid end to end) against
    Greedy.correct_error(register, read[i:]).  Returns how many the
    oracle accepted."""
    solid = SolidSet.from_sequences([genome], tc.K)
    probe = dc.make_solid_probe_any(solid.device_words("cpu"), tc.K)
    oracle = Greedy(solid, ms, nb)
    flat = b"".join(read for read, _i, _r in lanes)
    starts = np.cumsum([0] + [len(read) for read, _i, _r in lanes])
    codes = torch.from_numpy((np.frombuffer(flat, np.uint8) >> 1) & 3)
    rg = torch.tensor([reg for _r, _i, reg in lanes])
    n, corr = alt_last(probe, rg)
    a = greedy_attempt_plain(
        probe, window(codes.long(), len(flat)), tc.K, ms, nb,
        torch.tensor([starts[j] + i for j, (_r, i, _g) in enumerate(lanes)]),
        rg, corr, torch.from_numpy(starts[1:]))
    accepted = 0
    for j, (read, i, reg) in enumerate(lanes):
        want = oracle.correct_error(reg, read[i:])
        if int(n[j]) != 1 or not bool(a.ok[j]):
            assert want is None, (j, want)
            continue
        cnt = int(a.cnt[j])
        emit = [(int(a.emit[j, 0]) >> (2 * t)) & 3 for t in range(cnt)]
        bases, offset = want
        assert bases == tc.BASES[emit].tobytes()
        if bool(a.cap[j]):
            assert offset < 0
        else:
            assert offset == int(a.consumed[j])
        accepted += 1
    return accepted


def test_greedy_tie_breaks():
    """The sites of tests/test_engine3.py:229 (random positions and
    registers over a random genome), and the first scan site of reads
    with an error cluster (substitutions, insertions, deletions within
    the search window, which the alignment's tie-breaks decide): the
    plain greedy attempt gives the oracle's bases and offset."""
    rng = np.random.default_rng(11)
    genome = rng.choice(tc.BASES, size=3000).tobytes()
    lanes = [(genome[:2990], int(i), int(km)) for i, km in zip(
        rng.integers(tc.K, 2500, 64), rng.integers(0, 1 << (2 * tc.K), 64))]
    solid = SolidSet.from_sequences([genome], tc.K)
    from br_tpu_torch import codec

    for _ in range(120):
        lo = int(rng.integers(0, 2600))
        r = bytearray(genome[lo : lo + 300])
        p = int(rng.integers(40, 200))
        for q in sorted(rng.choice(np.arange(p, p + 6), 2, replace=False),
                        reverse=True):
            op = int(rng.integers(3))
            if op == 0:
                r[q] = ord("ACTG"[("ACTG".index(chr(r[q])) + 1) % 4])
            elif op == 1:
                del r[q]
            else:
                r.insert(q, ord("ACTG"[int(rng.integers(4))]))
        r = bytes(r)
        prev = True
        for i in range(tc.K - 1, len(r)):
            km = codec.seq2bit(r[i - tc.K + 1 : i + 1])
            v = solid.get(km)
            if prev and not v:
                lanes.append((r, i, km))
                break
            prev = v
    assert _attempts_vs_oracle(genome, lanes) >= 15


def test_greedy_oracle_matches_br_tpu():
    tc.assert_catalog_agrees("greedy")
    tc.assert_oracles_agree("greedy", seed=404)


def test_global_align_ops_matches_br_tpu():
    from br_tpu.correct.alignment import global_align_ops as j_align
    from br_tpu_torch.correct.alignment import global_align_ops

    rng = np.random.default_rng(12)
    for _ in range(300):
        x = rng.choice(tc.BASES, size=int(rng.integers(0, 24))).tobytes()
        y = bytearray(x)
        for _ in range(int(rng.integers(0, 4))):
            if y and rng.random() < 0.5:
                del y[int(rng.integers(len(y)))]
            else:
                y.insert(int(rng.integers(len(y) + 1)),
                         int(rng.choice(tc.BASES)))
        assert global_align_ops(x, bytes(y)) == j_align(x, bytes(y))


def test_greedy_refuses_long_search():
    """JAX refuses ms + 1 > 16 (one emit word, engine3.py:726-727)."""
    from br_tpu_torch.correct.engine3 import make_pass3_fn

    with pytest.raises(ValueError, match="max_search"):
        make_pass3_fn(tc.K, "greedy", 5, 16, 5, 1 << 12, 8)
    z = torch.zeros(1 << 12, dtype=torch.int32)
    with pytest.raises(ValueError, match="max_search"):
        greedy_sites(torch.zeros(1 << 20, dtype=torch.int32),
                     z.to(torch.uint8), z, z[:2048], z[:1], z[:8], z[:8],
                     tc.K, 16, 5)


# A negative consumed count (ROADMAP C2): greedy_rewind_case's attempts
# accept an alignment whose offset rewinds the read by one position; the
# pass caps the site by attempt (CAP_ATTEMPT, aux[2]) and the read, as
# br_tpu's does (engine3.py:700-702), and the batch corrector hands the
# read to the host engine, which rewinds as the reference does.

def _rewind_reads():
    """greedy_rewind_case()'s genome pieces and reads (codes decoded)."""
    pieces, codes, rstart, rlen = tc.greedy_rewind_case()
    return pieces, [tc.BASES[codes[s : s + n]].tobytes()
                    for s, n in zip(rstart, rlen) if n]


def test_greedy_rewind_reaches_a_negative_count():
    pieces, reads = _rewind_reads()
    solid = SolidSet.from_sequences(pieces, tc.K)
    g = Greedy(solid, tc.MS_REWIND, tc.C)
    for read in reads[:3]:
        i = 40 + len(tc.REWIND_B)
        kmer = codec.seq2bit(read[i - tc.K + 1 : i + 1])
        assert not solid.get(kmer)
        assert g.correct_error(kmer, read[i:]) == (tc.REWIND_C, -1)


def test_greedy_rewind_pass_matches_jax():
    """The pass at ms = 8 against br_tpu's recording, every aux entry
    included: three sites capped by attempt, three reads capped."""
    case = tc.greedy_rewind_case()
    got = tc.run_port_pass("greedy", case, ms=tc.MS_REWIND)
    want = tc.load_golden(tc.REWIND_GOLDEN)["greedy_rewind"]
    tc.assert_matches_recording(got, want, *case[2:])
    assert np.array_equal(got[3], want[3])
    assert got[3][2] == 3 and got[2][:3].all() and not got[2][3:].any()


@pytest.mark.parametrize("two_side", [True, False])
def test_greedy_rewind_reads_corrected_on_the_host(two_side):
    """Through Torch3Corrector (plain versions): the three reads cap on
    both profiles and the native engine corrects them as br_tpu's oracle
    does."""
    from br_tpu.correct import build_methods as j_build_methods
    from br_tpu.correct import correct_read as j_correct_read
    from br_tpu.set.solid import SolidSet as JSolidSet
    from br_tpu_torch.correct.engine3 import Torch3Corrector

    pieces, reads = _rewind_reads()
    tcor = Torch3Corrector(SolidSet.from_sequences(pieces, tc.K),
                           ["greedy"], tc.C, tc.MS_REWIND, chunk=tc.CHUNK,
                           nreads=tc.R, device="cpu", threads=1)
    got = tcor.correct_batch(reads, two_side)
    methods = j_build_methods(["greedy"], JSolidSet.from_sequences(pieces,
                                                                   tc.K),
                              tc.C, tc.MS_REWIND)
    assert got == [j_correct_read(r, methods, two_side) for r in reads]
    assert tcor.last_host == [0, 1, 2], tcor.last_stats


@pytest.mark.slow
def test_greedy_rewind_recording_is_jax_pass_output():
    """Record br_tpu's pass on the rewind case again (eager JAX, about
    half a minute on the CPU) and compare with the recording."""
    want = tc.load_golden(tc.REWIND_GOLDEN)["greedy_rewind"]
    for a, b in zip(tc.record_greedy_rewind()["greedy_rewind"], want):
        assert np.array_equal(a, b)
