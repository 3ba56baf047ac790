"""k = 17 on the CPU: the port's five plain passes against br_tpu's
recorded passes, and the k = 17 corrector against the port's oracle and
native engine.

Every case shares one genome (``tests/torch_cases.k17_cases``), so the
module builds its 1 GiB bitfield once, with ``SolidSet.from_sequences``
(a host ``Counter`` at k = 17 would hold 8 GiB).  br_tpu's passes at
k = 17 (u64 registers) are recorded eagerly in
``golden/torch_<strategy>_pass_k17.npz`` (``python tests/torch_cases.py
one_k17 ...``); the ``slow`` test records them again live."""

import numpy as np
import pytest
import torch

import torch_cases as tc
from br_tpu_torch.correct import reference as P
from br_tpu_torch.correct.engine3 import Torch3Corrector
from br_tpu_torch.correct.layout import WIDE_WALK_MAX
from br_tpu_torch.native import NativeCorrector
from br_tpu_torch.set.solid import SolidSet

K = tc.K17
FULL = ["one", "two", "graph", "greedy", "gap-size"]
#: (strategy, recording, case, walk_max, ms)
RUNS = [("one", "mixed", "mixed", None, tc.MS),
        ("two", "mixed", "mixed", None, tc.MS),
        ("greedy", "mixed", "mixed", None, tc.MS),
        ("greedy", "mixed_ms15", "mixed", None, tc.MS17[1])]
# the long-walk family at walk_max 248 is held on the card
# (tests/test_torch_cuda.py), to keep this file's time down
RUNS += [(st, rec, case, wm, tc.MS) for st in tc.WALKERS
         for rec, case, wm in (("mixed", "mixed", None),
                               ("long_walk_wide", "long_walk",
                                WIDE_WALK_MAX))]


@pytest.fixture(scope="module")
def k17():
    """(cases, solid set, its table): the one 1 GiB bitfield, the table a
    view of its bits."""
    cases = tc.k17_cases()
    solid = SolidSet.from_sequences(cases["mixed"][0], K)
    return cases, solid, torch.from_numpy(solid.host_words().view(np.int32))


@pytest.mark.parametrize("strategy,rec,case,walk_max,ms", RUNS)
def test_k17_pass_matches_jax(k17, strategy, rec, case, walk_max, ms):
    """Per read the codes within out_len, out_len and cap, and aux, equal
    br_tpu's pass at k = 17."""
    cases, _solid, table = k17
    golden = tc.load_golden(tc.golden_path_k17(strategy))
    _p, codes, rstart, rlen = cases[case]
    got = tc.run_port_pass(strategy, cases[case], walk_max=walk_max, ms=ms,
                           k=K, table=table)
    tc.assert_matches_recording(got, golden[rec], rstart, rlen)
    assert got[3][0] > 0 and (case == "long_walk" or got[3][5] > 0)
    if rec == "mixed" and strategy == "one":
        assert got[2].any() and got[3][1] > 0   # nested repairs past SLOTS


def test_k17_corrector_matches_oracle_and_native(k17):
    """The default chain at k = 17 on the CPU, forward then reversed:
    fuzz reads, two long-walk reads (retried on the wide sibling), an
    impure read and a read too long for a chunk (both to the native
    engine) equal the port's oracle; the native engine alone gives the
    oracle's bytes too."""
    cases, solid, table = k17
    rng = np.random.default_rng(171)
    g1, g2, gab = cases["mixed"][0]
    reads = tc.fuzz_reads(rng, g2, 12, 4, k=K)
    _p, codes, rstart, rlen = cases["long_walk"]
    # the 400-base deletion and the 400-base stretch: a long accept and a
    # long fill, finished on the wide sibling
    reads += [tc.BASES[codes[a : a + n]].tobytes()
              for a, n in zip(rstart[2:4], rlen[2:4])]
    reads += [g1[:300] + b"N" + g1[301:700], g1 * 4]
    tcor = Torch3Corrector(solid, FULL, tc.C, tc.MS, chunk=tc.CHUNK,
                           nreads=tc.R, device="cpu", table=table, threads=2)
    got = tcor.correct_batch(reads, False)
    methods = P.build_methods(FULL, solid, tc.C, tc.MS)
    want = [P.correct_read(r, methods, False) for r in reads]
    assert got == want
    st = tcor.last_stats
    assert st["wide_retried"] == 2 and st["impure"] == 1, st
    assert st["too_long"] == 1, st
    assert sum(a != b for a, b in zip(got, reads)) >= 10
    native = NativeCorrector(solid, FULL, tc.C, tc.MS, threads=2)
    assert native.correct_batch(reads[:12], True) == [
        P.correct_read(r, methods, True) for r in reads[:12]]


@pytest.mark.slow
@pytest.mark.parametrize("strategy", tc.STRATEGIES)
def test_k17_recording_is_jax_pass_output(strategy):
    """Record br_tpu's k = 17 pass again, eagerly (a minute or two)."""
    fresh = tc.record_k17(strategy)
    golden = tc.load_golden(tc.golden_path_k17(strategy))
    assert sorted(fresh) == sorted(golden)
    for name, arrs in fresh.items():
        for a, b in zip(arrs, golden[name]):
            assert np.array_equal(a, b), name
