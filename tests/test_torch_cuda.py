"""The port's CUDA kernels on the card, against their plain versions and
the JAX package's recorded pass outputs.  Marked ``cuda``: they skip
where there is no CUDA device (a CUDA kernel has no CPU mode).  Run them
on a machine with the GPU:

    python -m pytest tests/test_torch_cuda.py -q

Nothing here imports JAX or br_tpu: that machine has neither."""

import numpy as np
import pytest
import torch

import torch_cases as tc
from br_tpu_torch import kernels
from br_tpu_torch.correct import device_codec as dc
from br_tpu_torch.correct import greedy, probe, reverse, sites, splice, two
from br_tpu_torch.correct import walk
from br_tpu_torch.correct.engine3 import Torch3Corrector, make_pass3_fn
from br_tpu_torch.correct.layout import WIDE_WALK_MAX, site_capacity
from br_tpu_torch.correct.reference import build_methods, correct_read
from br_tpu_torch.set.solid import SolidSet

pytestmark = pytest.mark.cuda

CASES = ["uniform", "repeat_rich", "clustered", "dense", "exact_fill",
         "slot_overflow"]
FULL = ["one", "two", "graph", "greedy", "gap-size"]
ONE_KERNELS = ("dense_probe", "one_sites", "chain_splice", "reverse_slots")


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    kernels.build_all()
    return torch.device("cuda")


@pytest.fixture(scope="module")
def cases():
    return tc.all_cases()


def _same(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


@pytest.mark.parametrize("name", CASES)
def test_kernels_match_plain(dev, cases, name):
    g, codes, rstart, rlen = cases[name]
    table = SolidSet.from_sequences([g], tc.K).device_words(dev)
    codes = torch.from_numpy(codes).to(dev)
    rs = torch.from_numpy(rstart).to(dev)
    rl = torch.from_numpy(rlen).to(dev)
    NS = site_capacity(tc.CHUNK)
    before = dict(kernels.LAUNCHES)
    for ns in (NS, 40):   # 40: the site list overflows and caps reads
        d = probe.dense_probe(table, codes, rs, rl, tc.K, ns)
        dp = probe.dense_probe_plain(table, codes, rs, rl, tc.K, ns)
        _same(d, dp)
        s_args = (table, codes, dp.kmers, dp.s_pos, dp.n_sites, rs, rl,
                  tc.K, tc.C)
        s, sp = sites.one_sites(*s_args), sites.one_sites_plain(*s_args)
        _same(sites.defined(s), sites.defined(sp))
        x_args = (codes, rs, rl, dp.s_pos, dp.n_sites, sp, dp.cap_read)
        x = splice.chain_splice(*x_args)
        xp = splice.chain_splice_plain(*x_args)
        _same(x, xp)
        # K3 reads none of the entries K2 leaves unwritten
        _same(splice.chain_splice(*x_args[:5], s, dp.cap_read), xp)
        assert torch.equal(reverse.reverse_slots(xp.out, rs, xp.out_len),
                           reverse.reverse_slots_plain(xp.out, rs,
                                                       xp.out_len))
    torch.cuda.synchronize()
    for name_k in ONE_KERNELS:
        assert kernels.LAUNCHES[name_k] == before[name_k] + (
            4 if name_k == "chain_splice" else 2)


@pytest.mark.parametrize("name", tc.FAMILIES)
@pytest.mark.parametrize("strategy", ["two", "graph", "gap-size", "greedy",
                                      "graph-wide", "gap-size-wide"])
def test_site_kernels_match_plain(dev, cases, strategy, name):
    """K5, K6 (both modes, both walk profiles) and K7 against their plain
    versions, and K3 on their records (multi-word emits for the walks)."""
    g, codes, rstart, rlen = cases[name]
    table = SolidSet.from_sequences([g], tc.K).device_words(dev)
    codes = torch.from_numpy(codes).to(dev)
    rs = torch.from_numpy(rstart).to(dev)
    rl = torch.from_numpy(rlen).to(dev)
    d = probe.dense_probe_plain(table, codes, rs, rl, tc.K,
                                site_capacity(tc.CHUNK))
    args = (table, codes, d.kmers, d.s_pos, d.n_sites, rs, rl, tc.K)
    if strategy == "two":
        kname, fns, extra = "two_sites", (two.two_sites,
                                          two.two_sites_plain), (tc.C,)
    elif strategy == "greedy":
        kname, fns, extra = "greedy_sites", (
            greedy.greedy_sites, greedy.greedy_sites_plain), (tc.MS, tc.C)
    else:
        wm = WIDE_WALK_MAX if strategy.endswith("-wide") else 248
        kname, fns = "walk_sites", (walk.walk_sites, walk.walk_sites_plain)
        args = (table, codes, d.kmers, d.V, *args[3:])
        extra = (tc.C, strategy.replace("-wide", ""), wm)
    before = kernels.LAUNCHES[kname]
    s, sp = (f(*args, *extra) for f in fns)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES[kname] == before + 1
    _same(sites.defined(s), sites.defined(sp))
    x_args = (codes, rs, rl, d.s_pos, d.n_sites, sp, d.cap_read)
    xp = splice.chain_splice_plain(*x_args)
    _same(splice.chain_splice(*x_args), xp)
    _same(splice.chain_splice(*x_args[:5], s, d.cap_read), xp)


@pytest.mark.parametrize("name", CASES)
def test_pass_on_card_matches_jax_recording(dev, cases, name):
    g, codes, rstart, rlen = cases[name]
    got = tc.run_port_pass("one", cases[name], device=dev)
    tc.assert_matches_recording(got, tc.load_golden()[name], rstart, rlen)


@pytest.mark.parametrize("name", tc.FAMILIES)
@pytest.mark.parametrize("strategy", ["two", "graph", "gap-size", "greedy"])
def test_strategy_pass_on_card_matches_jax_recording(dev, cases, strategy,
                                                     name):
    g, codes, rstart, rlen = cases[name]
    golden = tc.load_golden(tc.golden_path(strategy))
    got = tc.run_port_pass(strategy, cases[name], device=dev)
    tc.assert_matches_recording(got, golden[name], rstart, rlen)
    if strategy in tc.WALKERS and name == "long_walk":
        got = tc.run_port_pass(strategy, cases[name],
                               walk_max=WIDE_WALK_MAX, device=dev)
        tc.assert_matches_recording(got, golden["long_walk_wide"], rstart,
                                    rlen)


@pytest.mark.parametrize("chain", [["one"], FULL])
@pytest.mark.parametrize("two_side", [False, True])
def test_corrector_on_card_matches_oracle(dev, two_side, chain):
    rng = np.random.default_rng(11)
    genome = tc.repeat_rich_genome(rng)
    reads = tc.fuzz_reads(rng, genome, 60, 6)
    solid = SolidSet.from_sequences([genome], tc.K)
    tcor = Torch3Corrector(solid, chain, tc.C, tc.MS, chunk=tc.CHUNK,
                           nreads=tc.R)
    assert tcor.device.type == "cuda"
    got = tcor.correct_batch(reads, two_side)
    methods = build_methods(chain, solid, tc.C, tc.MS)
    assert got == [correct_read(r, methods, two_side) for r in reads]
    assert tcor.last_stats["fallback"] == 0


@pytest.mark.parametrize("strategy", ["graph", "gap-size"])
def test_wide_retry_on_card(dev, strategy):
    """The long accept and the long fill finish on the card's wide
    sibling (tests/test_engine3.py:267, :289)."""
    g, codes, rstart, rlen = tc.long_walk_case()
    reads = [tc.BASES[codes[a : a + n]].tobytes()
             for a, n in zip(rstart, rlen) if n]
    solid = SolidSet.from_sequences([g], tc.K)
    tcor = Torch3Corrector(solid, [strategy], tc.C, tc.MS, chunk=tc.CHUNK,
                           nreads=8)
    got = tcor.correct_batch(reads, True)
    methods = build_methods([strategy], solid, tc.C, tc.MS)
    assert got == [correct_read(r, methods, True) for r in reads]
    st = tcor.last_stats
    assert st["wide_retried"] > 0 and st["capped"] == 0, st


def test_unpack_pack_on_card(dev):
    rng = np.random.default_rng(1)
    codes = torch.from_numpy(rng.integers(0, 4, 4096).astype(np.uint8))
    packed = dc.pack_codes(codes.to(dev))
    assert torch.equal(packed.cpu(), dc.pack_codes(codes))
    assert torch.equal(dc.unpack_codes(packed, 4096).cpu(), codes)
