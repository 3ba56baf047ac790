"""The port's ``one`` pass (K1-K3 plain versions, on the CPU) against the
JAX package's pass and against the oracle.

* At k=13 (CHUNK=2^14, R=32, c=5): the JAX pass's outputs on the chunks of
  tests/torch_cases.py, recorded in golden/torch_one_pass_k13.npz (its
  CPU compile takes about 12 minutes; the slow tier recomputes it).  Per
  read, the codes within out_len, out_len and cap are equal, and so are
  aux entries 0, 4, 5 and 6 (where JAX's aux[3], CAP_ROUNDS, is 0).
  Codes past out_len and JAX's carried bit 2 are out of scope by design.
* At k=11 and k=15: every uncapped read equals the port's oracle (one
  forward ``One.correct``), and capped reads are counted.
* The reference catalog's ``one`` cases and the exact-fill splice.
"""

import numpy as np
import pytest
import torch

import torch_cases as tc
from br_tpu_torch.correct.engine3 import make_pass3_fn
from br_tpu_torch.correct.layout import BIG, SLOTS
from br_tpu_torch.correct.reference import One
from br_tpu_torch.correct.sites import Sites
from br_tpu_torch.correct.splice import chain_splice
from br_tpu_torch.set.solid import SolidSet

_DECODE = np.frombuffer(b"ACTG", np.uint8)


def _run_port(k, genome, codes, rstart, rlen, c=tc.C, CHUNK=tc.CHUNK,
              R=tc.R):
    solid = SolidSet.from_sequences([genome], k)
    fn = make_pass3_fn(k, "one", c, tc.MS, c, CHUNK, R)
    out, n, cap, aux = fn(solid.device_words("cpu"),
                          torch.from_numpy(codes), torch.from_numpy(rstart),
                          torch.from_numpy(rlen))
    return out.numpy(), n.numpy(), cap.numpy(), aux.numpy(), solid


@pytest.fixture(scope="module")
def cases():
    return tc.build_cases()


@pytest.fixture(scope="module")
def golden():
    return tc.load_golden()


@pytest.mark.parametrize("name", ["uniform", "repeat_rich", "clustered",
                                  "dense", "exact_fill", "slot_overflow"])
def test_one_pass_matches_jax(cases, golden, name):
    g, codes, rstart, rlen = cases[name]
    out, n, cap, aux, _ = _run_port(tc.K, g, codes, rstart, rlen)
    j_out, j_n, j_cap, j_aux = golden[name]
    assert j_aux[3] == 0, "JAX ran out of queue rounds; not comparable"
    assert np.array_equal(n, j_n)
    assert np.array_equal(cap, j_cap)
    for b in np.flatnonzero(rlen > 0):
        lo = rstart[b]
        assert np.array_equal(out[lo : lo + n[b]], j_out[lo : lo + n[b]]), b
    assert np.array_equal(aux[[0, 4, 5, 6]], j_aux[[0, 4, 5, 6]])
    assert aux[0] > 0 and aux[5] > 0
    if name == "slot_overflow":
        assert cap.any() and aux[1] > 0
    if name == "exact_fill":
        rcap = np.append(rstart[1:], tc.CHUNK) - rstart
        full = (rlen > 0) & (n == rcap) & ~cap
        assert full.sum() >= 10


def _check_vs_oracle(k, genome, codes, rstart, rlen, c=tc.C, **kw):
    out, n, cap, aux, solid = _run_port(k, genome, codes, rstart, rlen,
                                        c=c, **kw)
    one = One(solid, c)
    changed = 0
    for b in np.flatnonzero(rlen > 0):
        lo = rstart[b]
        read = _DECODE[codes[lo : lo + rlen[b]]].tobytes()
        if cap[b]:
            continue
        want = one.correct(read)
        got = _DECODE[out[lo : lo + n[b]]].tobytes()
        assert got == want, b
        changed += want != read
    assert aux[6] == cap.sum()
    return changed, int(cap.sum())


@pytest.mark.parametrize("k", [11, 15])
def test_one_pass_other_k_matches_oracle(k):
    rng = np.random.default_rng(k)
    g = tc.repeat_rich_genome(rng, k=k) if k == 11 else \
        rng.choice(tc.BASES, size=4000).tobytes()
    reads = tc.fuzz_reads(rng, g, 28, 5, k=k)
    changed, capped = _check_vs_oracle(k, g, *tc.pack(reads, rng=rng))
    assert changed >= 10 and capped <= 2


def test_one_pass_cases_match_oracle(cases):
    for name, (g, codes, rstart, rlen) in cases.items():
        changed, capped = _check_vs_oracle(tc.K, g, codes, rstart, rlen)
        assert changed > 0, name


def test_reference_catalog_one_cases():
    """The reference's planted-error catalog (one.rs:89-277), c=2 at
    k=5/7, through the pass: corrected as the oracle says."""
    from catalog import CASES, filt

    from br_tpu_torch import codec

    for (name, method, kwargs, k, refe, read, extra, expect) in CASES:
        if method != "one":
            continue
        refe, read = filt(refe), filt(read)
        s = SolidSet(k)
        for seq in [refe, *extra]:
            for kmer in codec.tokenize(seq, k):
                s.set(kmer, True)
        CHUNK, R = 1 << 12, 8
        codes = np.zeros(CHUNK, np.uint8)
        rstart = np.full(R, CHUNK, np.int32)
        rlen = np.zeros(R, np.int32)
        for b, x in enumerate((read, refe)):
            arr = np.frombuffer(x, np.uint8)
            codes[64 * b : 64 * b + len(arr)] = (arr >> 1) & 3
            rstart[b], rlen[b] = 64 * b, len(arr)
        fn = make_pass3_fn(k, "one", kwargs["c"], 7, kwargs["c"], CHUNK, R)
        out, n, cap, _aux = fn(s.device_words("cpu"),
                               torch.from_numpy(codes),
                               torch.from_numpy(rstart),
                               torch.from_numpy(rlen))
        out, n = out.numpy(), n.numpy()
        got = [_DECODE[out[64 * b : 64 * b + n[b]]].tobytes()
               for b in range(2)]
        one = One(s, kwargs["c"])
        assert not cap[:2].any(), name
        assert got == [one.correct(read), one.correct(refe)], name
        assert got[0] == (refe if expect == "refe" else read), name
        assert got[1] == refe, name


def test_exact_fill_keeps_last_emitted_base():
    """A record whose repair ends exactly at the read end, in a slot the
    output fills exactly (out_len == rcap, tail_len == 0).

    The JAX pass clips its splice deltas to rstart+rcap-1
    (engine3.py:1822-1827), so there the last output base would come from
    the input (codes[rend-1]) instead of the record's emitted base: a
    silent corruption (ROADMAP C).  ``one`` never produces this record
    (its scenarios keep c >= 0 bases after the repair and tie at the read
    end), so the splice is driven directly with it; the port emits the
    record's base."""
    CHUNK, R, NS = 64, 2, 2048
    codes = torch.zeros(CHUNK, dtype=torch.uint8)
    codes[:20] = torch.arange(20) % 4
    rstart = torch.tensor([0, 20], dtype=torch.int32)
    rlen = torch.tensor([20, 10], dtype=torch.int32)
    s_pos = torch.full((NS,), BIG, dtype=torch.int32)
    s_pos[0] = 19
    rec = torch.zeros((4, NS * SLOTS), dtype=torch.int32)
    rec[0].fill_(BIG)
    rec[:, 0] = torch.tensor([19, 1, 1, 2])   # p, count, consumed, base
    sites = Sites(torch.full((NS,), NS, dtype=torch.int32),
                  torch.zeros(NS, dtype=torch.int32), rec[0], rec[1],
                  rec[2], rec[3][:, None].contiguous())
    sp = chain_splice(codes, rstart, rlen, s_pos,
                      torch.tensor([1], dtype=torch.int32), sites,
                      torch.zeros(R, dtype=torch.bool))
    assert sp.out_len.tolist()[0] == 20 and not sp.cap[0]
    want = codes[:20].clone()
    want[19] = 2
    assert torch.equal(sp.out[:20], want)
    assert codes[19] != 2     # where the JAX clip would have read from


@pytest.mark.slow
def test_golden_is_jax_pass_output(cases, golden):
    """Recompute the recording with br_tpu's pass (about 12 minutes of
    XLA compile on the CPU)."""
    fresh = tc.jax_pass_outputs(cases)
    for name, arrs in fresh.items():
        for a, b in zip(arrs, golden[name]):
            assert np.array_equal(a, b), name
