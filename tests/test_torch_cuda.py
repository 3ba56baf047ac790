"""The port's CUDA kernels on the card, against their plain versions and
the JAX package's recorded pass outputs.  Marked ``cuda``: they skip
where there is no CUDA device (a CUDA kernel has no CPU mode).  Run them
on a machine with the GPU:

    python -m pytest tests/test_torch_cuda.py -q

Nothing here imports JAX or br_tpu: that machine has neither."""

import functools
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import torch_cases as tc
from br_tpu_torch import codec, kernels
from br_tpu_torch.correct import device_codec as dc
from br_tpu_torch.correct import greedy, probe, reverse, sites, splice, two
from br_tpu_torch.correct import walk
from br_tpu_torch.correct.engine3 import Torch3Corrector, make_pass3_fn
from br_tpu_torch.correct.layout import (
    BIG, CAP_ATTEMPT, CAP_OVERFLOW, WIDE_WALK_MAX, site_capacity)
from br_tpu_torch.correct.reference import build_methods, correct_read
from br_tpu_torch.correct.sites import Sites
from br_tpu_torch.set.hash import HashSet
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
            8 if name_k == "chain_splice" else 2)   # K3: two kernels a call


@pytest.mark.parametrize("name", tc.FAMILIES)
@pytest.mark.parametrize("strategy", ["one", "two", "graph", "gap-size",
                                      "greedy", "graph-wide",
                                      "gap-size-wide"])
def test_site_kernels_match_plain(dev, cases, strategy, name):
    """K2, K5, K6 (both modes, both walk profiles) and K7 against their
    plain versions, and K3 on their records (multi-word emits for the
    walks)."""
    g, codes, rstart, rlen = cases[name]
    table = SolidSet.from_sequences([g], tc.K).device_words(dev)
    codes = torch.from_numpy(codes).to(dev)
    rs = torch.from_numpy(rstart).to(dev)
    rl = torch.from_numpy(rlen).to(dev)
    d = probe.dense_probe_plain(table, codes, rs, rl, tc.K,
                                site_capacity(tc.CHUNK))
    args = (table, codes, d.kmers, d.s_pos, d.n_sites, rs, rl, tc.K)
    if strategy == "one":
        kname, fns, extra = "one_sites", (sites.one_sites,
                                          sites.one_sites_plain), (tc.C,)
    elif strategy == "two":
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


# Adversarial inputs (tests/torch_cases.py): K1 on seeded random 2^20
# chunks, K3 on synthetic site tables; exact against the plain versions.

@pytest.mark.parametrize("k", [11, 13, 15])
@pytest.mark.parametrize("ns", ["above", "cut"])
def test_dense_probe_stress(dev, k, ns):
    """A 2^20 chunk of random codes and a ~30 % solid bitfield (sites in
    every tile), unaligned slots, reads across tiles; NS above the site
    count, or cut in the middle of a tile (the cap_read path)."""
    codes, words, rstart, rlen = tc.dense_stress_case(k, seed=k)
    args = [torch.from_numpy(a).to(dev) for a in (words, codes, rstart,
                                                  rlen)]
    NS = 1 << 18
    if ns == "cut":
        full = probe.dense_probe_plain(*args, k, NS)
        NS = int(full.T[: 100 * probe.TILE + probe.TILE // 2].sum())
    before = kernels.LAUNCHES["dense_probe"]
    d = probe.dense_probe(*args, k, NS)
    dp = probe.dense_probe_plain(*args, k, NS)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["dense_probe"] == before + 1
    _same(d, dp)
    n = int(dp.n_sites[0])
    assert (n > NS and bool(dp.cap_read.any())) == (ns == "cut")
    assert n > 1 << 17


def test_dense_probe_without_sites(dev):
    codes, words, rstart, rlen = tc.dense_stress_case(13, seed=5,
                                                      solid=False)
    args = [torch.from_numpy(a).to(dev) for a in (words, codes, rstart,
                                                  rlen)]
    d = probe.dense_probe(*args, 13, 1 << 15)
    _same(d, probe.dense_probe_plain(*args, 13, 1 << 15))
    assert int(d.n_sites[0]) == 0


SPLICE_CASES = {
    "windows": dict(seed=1, ew=1),
    "full": dict(seed=2, ew=1, R=16, full=True),
    "walk": dict(seed=3, ew=16),
    "wide": dict(seed=4, ew=128, chunk=1 << 18, R=32),
}


@functools.lru_cache(maxsize=None)
def _splice_case(name):
    return tc.splice_stress_case(**SPLICE_CASES[name])


@pytest.mark.parametrize("case", list(SPLICE_CASES))
def test_chain_splice_stress(dev, case):
    """K3 on synthetic site tables: reads of up to NS sites (many
    windows), chains that break mid-window or jump over windows,
    successors past the read, empty reads and unused slots, a read that
    fills its slot exactly, capped sites off the chain, emits of up to
    2041 bases in 128 words; in ``full``, the read past NS capped as K1
    caps it."""
    (codes, rstart, rlen, s_pos, n_sites, sites,
     cap_dense) = _splice_case(case)
    args = [torch.from_numpy(a).to(dev) for a in (codes, rstart, rlen,
                                                  s_pos, n_sites)]
    st = Sites(*(torch.from_numpy(a).to(dev) for a in sites))
    cd = torch.from_numpy(cap_dense).to(dev)
    before = kernels.LAUNCHES["chain_splice"]
    x = splice.chain_splice(*args, st, cd)
    xp = splice.chain_splice_plain(*args, st, cd)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["chain_splice"] == before + 2   # two kernels
    _same(x, xp)
    assert int(xp.aux[4]) > splice.WINDOW and bool(xp.cap.any())
    if case == "full":
        assert bool(xp.cap[1]) and int(xp.aux[7]) > int(xp.aux[0])


def test_unpack_pack_on_card(dev):
    rng = np.random.default_rng(1)
    codes = torch.from_numpy(rng.integers(0, 4, 4096).astype(np.uint8))
    packed = dc.pack_codes(codes.to(dev))
    assert torch.equal(packed.cpu(), dc.pack_codes(codes))
    assert torch.equal(dc.unpack_codes(packed, 4096).cpu(), codes)


# Adversarial inputs of K6 and K7 (tests/torch_cases.py): walks past
# walk_max, revisits at and around it, Brent cycles, fills, V scans to the
# read end, nested repairs past SLOTS; greedy attempts decided at every
# step, walks failing at step 0, reads ending inside the walk.

WALK_STRESS = {
    "default": dict(seed=1, walk_max=248, chunk=1 << 16, nreads=64,
                    long_period=600),
    "wide": dict(seed=2, walk_max=WIDE_WALK_MAX, chunk=1 << 17, nreads=48,
                 wide_slots=True, deletions=(2000, 2600), long_period=2600),
}


@functools.lru_cache(maxsize=None)
def _walk_stress(name):
    return tc.walk_stress_case(**WALK_STRESS[name])


def _on_card(dev, pieces, codes, rstart, rlen):
    table = SolidSet.from_sequences(pieces, tc.K).device_words(dev)
    c, rs, rl = (torch.from_numpy(x).to(dev) for x in (codes, rstart, rlen))
    d = probe.dense_probe_plain(table, c, rs, rl, tc.K,
                                site_capacity(len(codes)))
    return table, c, rs, rl, d


@pytest.mark.parametrize("strategy", ["graph", "gap-size"])
@pytest.mark.parametrize("case", list(WALK_STRESS))
def test_walk_sites_stress(dev, case, strategy):
    """K6 against its plain version where walks run long: to and past
    walk_max, revisits one step before, at and after it, Brent past it,
    fills, the V scan to the read end, a site past SLOTS records; and K3
    on the kernel's records."""
    table, c, rs, rl, d = _on_card(dev, *_walk_stress(case))
    wm = WALK_STRESS[case]["walk_max"]
    args = (table, c, d.kmers, d.V, d.s_pos, d.n_sites, rs, rl, tc.K, tc.C,
            strategy, wm)
    before = kernels.LAUNCHES["walk_sites"]
    s = walk.walk_sites(*args)
    sp = walk.walk_sites_plain(*args)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["walk_sites"] == before + 1
    _same(sites.defined(s), sites.defined(sp))
    used = sp.rec_p < BIG
    assert bool((sp.s_cap == CAP_ATTEMPT).any())
    assert bool((sp.s_cap == CAP_OVERFLOW).any())
    assert int(sp.rec_c[used].max()) >= wm - 16
    x_args = (c, rs, rl, d.s_pos, d.n_sites, sp, d.cap_read)
    _same(splice.chain_splice(*x_args[:5], s, d.cap_read),
          splice.chain_splice_plain(*x_args))


def test_walk_stress_case_revisits_at_walk_max(dev):
    """The plain walk on the card: the tandem repeats of the wide case
    with periods walk_max - 1 and walk_max make the walk revisit one step
    before walk_max and at it, and both decline (the CPU tests check the
    same at a small walk_max)."""
    pieces = _walk_stress("wide")[0]
    table = SolidSet.from_sequences(pieces, tc.K).device_words(dev)
    probe_ = dc.make_solid_probe_any(table, tc.K)
    units = [p for p in pieces
             if len(p) - (tc.K - 1) in (WIDE_WALK_MAX - 1, WIDE_WALK_MAX)]
    assert len(units) == 2
    corr = torch.tensor([codec.seq2bit(p[:tc.K]) for p in units],
                        device=dev)
    ok, cap, _buf, n, _wk = walk.walk_plain(
        probe_, tc.K, corr, torch.full_like(corr, -1),
        torch.ones(2, dtype=torch.bool, device=dev), torch.zeros_like(corr),
        WIDE_WALK_MAX)
    assert not bool((ok | cap).any())
    assert sorted((n - 1).tolist()) == [WIDE_WALK_MAX - 1, WIDE_WALK_MAX]


@pytest.mark.parametrize("seed", [3, 4])
def test_greedy_sites_stress(dev, seed):
    """K7 against its plain version on reads with error clusters: every
    step decides somewhere, walks fail at step 0 and branch, reads end
    inside the walk; and K3 on the kernel's records."""
    table, c, rs, rl, d = _on_card(dev, *tc.greedy_stress_case(
        seed, chunk=1 << 18, nreads=256))
    args = (table, c, d.kmers, d.s_pos, d.n_sites, rs, rl, tc.K, tc.MS,
            tc.C)
    before = kernels.LAUNCHES["greedy_sites"]
    s = greedy.greedy_sites(*args)
    sp = greedy.greedy_sites_plain(*args)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["greedy_sites"] == before + 1
    _same(sites.defined(s), sites.defined(sp))
    used = sp.rec_p < BIG
    cnt = sp.rec_c[used]
    assert set(range(2, tc.MS + 2)) <= set(cnt.tolist())   # every it
    x_args = (c, rs, rl, d.s_pos, d.n_sites, sp, d.cap_read)
    _same(splice.chain_splice(*x_args[:5], s, d.cap_read),
          splice.chain_splice_plain(*x_args))


def test_greedy_sites_rewind(dev):
    """K7's negative consumed count (ROADMAP C2): at ms = 8 the rewind
    case's three attempts cap by attempt on the card as in the plain
    version."""
    table, c, rs, rl, d = _on_card(dev, *tc.greedy_rewind_case())
    args = (table, c, d.kmers, d.s_pos, d.n_sites, rs, rl, tc.K,
            tc.MS_REWIND, tc.C)
    s = greedy.greedy_sites(*args)
    sp = greedy.greedy_sites_plain(*args)
    _same(sites.defined(s), sites.defined(sp))
    assert int((sp.s_cap == CAP_ATTEMPT).sum()) == 3


# Adversarial inputs of K2 and K5 (tests/torch_cases.two_stress_case):
# every two-error scenario planted and selected, ties broken by one
# one_more or left unbroken, reads ending 0-5 bases after an error, the
# last read ending at the chunk's last position, nested repairs past
# SLOTS.

@functools.lru_cache(maxsize=None)
def _two_stress(seed):
    return tc.two_stress_case(seed, chunk=1 << 18, nreads=512)


@pytest.mark.parametrize("seed", [1, 2])
@pytest.mark.parametrize("strategy", ["one", "two"])
def test_one_two_sites_stress(dev, strategy, seed):
    """K2 and K5 against their plain versions on the two-error stress
    family at 2^18, and K3 on the kernel's records."""
    table, c, rs, rl, d = _on_card(dev, *_two_stress(seed))
    args = (table, c, d.kmers, d.s_pos, d.n_sites, rs, rl, tc.K, tc.C)
    kname, fns = {"one": ("one_sites", (sites.one_sites,
                                        sites.one_sites_plain)),
                  "two": ("two_sites", (two.two_sites,
                                        two.two_sites_plain))}[strategy]
    before = kernels.LAUNCHES[kname]
    s = fns[0](*args)
    sp = fns[1](*args)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES[kname] == before + 1
    _same(sites.defined(s), sites.defined(sp))
    assert bool((sp.s_cap == CAP_OVERFLOW).any())
    assert int((sp.rec_p < BIG).sum()) > 1000
    x_args = (c, rs, rl, d.s_pos, d.n_sites, sp, d.cap_read)
    _same(splice.chain_splice(*x_args[:5], s, d.cap_read),
          splice.chain_splice_plain(*x_args))


@pytest.mark.parametrize("confirm", [0, 1, 12, 61])
@pytest.mark.parametrize("strategy", ["one", "two"])
def test_one_two_sites_any_confirm(dev, strategy, confirm):
    """K2 and K5 at other confirm counts than the default 5: c = 0 and 1,
    12 (more than one round of 32 probes), 61 (a code window past 64
    codes, read from memory)."""
    table, c, rs, rl, d = _on_card(dev, *_two_stress(1))
    args = (table, c, d.kmers, d.s_pos, d.n_sites, rs, rl, tc.K, confirm)
    fns = {"one": (sites.one_sites, sites.one_sites_plain),
           "two": (two.two_sites, two.two_sites_plain)}[strategy]
    s, sp = (f(*args) for f in fns)
    _same(sites.defined(s), sites.defined(sp))
    if confirm <= 12:
        assert int((sp.rec_p < BIG).sum()) > 100


# K4 on every chunk family and on slot tables the planner never makes:
# unaligned starts, many short slots in one warp's span, reads that fill
# their slot, a last slot that runs to CHUNK, reads past their slot, unused
# slots, codes with bit 2 set; each also from a misaligned view of the
# codes and on a chunk cut to a length that is no multiple of 16 (the byte
# path).

REVERSE_LAYOUTS = tc.reverse_layouts(1)


def _reverse_on_card(dev, codes, rstart, rlen, variant):
    c = torch.from_numpy(codes)
    if variant == "cut":
        c = c[:-4].contiguous()
    c = c.to(dev)
    if variant == "misaligned":
        buf = torch.empty(c.shape[0] + 1, dtype=torch.uint8, device=dev)
        buf[1:] = c
        c = buf[1:]
        assert c.data_ptr() % 16
    rs, rl = (torch.from_numpy(x).to(dev) for x in (rstart, rlen))
    before = kernels.LAUNCHES["reverse_slots"]
    got = reverse.reverse_slots(c, rs, rl)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["reverse_slots"] == before + 1
    assert torch.equal(got, reverse.reverse_slots_plain(c, rs, rl))


@pytest.mark.parametrize("name", tc.FAMILIES)
def test_reverse_slots_families(dev, cases, name):
    _g, codes, rstart, rlen = cases[name]
    rng = np.random.default_rng(len(name))
    bit2 = (rng.integers(0, 2, codes.shape[0]) << 2).astype(np.uint8)
    for c in (codes, codes | bit2):
        _reverse_on_card(dev, c, rstart, rlen, "aligned")


@pytest.mark.parametrize("variant", ["aligned", "misaligned", "cut"])
@pytest.mark.parametrize("layout", list(REVERSE_LAYOUTS))
def test_reverse_slots_layouts(dev, layout, variant):
    _reverse_on_card(dev, *REVERSE_LAYOUTS[layout], variant)


# k = 17: the kernels' 64-bit instantiations, on the k = 17 families of
# tests/torch_cases.py (one genome, one 1 GiB bitfield for the module).

@pytest.fixture(scope="module")
def k17(dev):
    cases = tc.k17_cases()
    pieces = cases["mixed"][0]
    return cases, SolidSet.from_sequences(pieces, tc.K17).device_words(dev)


K17_SITES = ["one", "two", "graph", "gap-size", "graph-wide",
             "gap-size-wide", "greedy", "greedy-ms14", "greedy-ms15"]


@pytest.mark.parametrize("name", ["mixed", "long_walk"])
@pytest.mark.parametrize("strategy", K17_SITES)
def test_k17_kernels_match_plain(dev, k17, strategy, name):
    """K1 (int64 k-mers), K2, K5, K6 (both modes, walk_max 248 and 2040)
    and K7 (ms 7, 14 and 15: 33 DP columns) at k = 17 against their plain
    versions, and K3 on their records."""
    cases, table = k17
    _pieces, codes, rstart, rlen = cases[name]
    codes = torch.from_numpy(codes).to(dev)
    rs = torch.from_numpy(rstart).to(dev)
    rl = torch.from_numpy(rlen).to(dev)
    k, NS = tc.K17, site_capacity(tc.CHUNK)
    before = dict(kernels.LAUNCHES)
    d = probe.dense_probe(table, codes, rs, rl, k, NS)
    dp = probe.dense_probe_plain(table, codes, rs, rl, k, NS)
    _same(d, dp)
    assert dp.kmers.dtype == torch.int64 and int(dp.n_sites[0]) > 0
    args = (table, codes, dp.kmers, dp.s_pos, dp.n_sites, rs, rl, k)
    if strategy == "one":
        kname, fns, extra = "one_sites64", (sites.one_sites,
                                            sites.one_sites_plain), (tc.C,)
    elif strategy == "two":
        kname, fns, extra = "two_sites64", (two.two_sites,
                                            two.two_sites_plain), (tc.C,)
    elif strategy.startswith("greedy"):
        ms = int(strategy[9:]) if "-ms" in strategy else tc.MS
        kname, fns, extra = "greedy_sites64", (
            greedy.greedy_sites, greedy.greedy_sites_plain), (ms, tc.C)
    else:
        wm = WIDE_WALK_MAX if strategy.endswith("-wide") else 248
        kname, fns = "walk_sites64", (walk.walk_sites,
                                      walk.walk_sites_plain)
        args = (table, codes, dp.kmers, dp.V, *args[3:])
        extra = (tc.C, strategy.replace("-wide", ""), wm)
    s, sp = (f(*args, *extra) for f in fns)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES[kname] == before[kname] + 1
    assert kernels.LAUNCHES["dense_probe64"] == before["dense_probe64"] + 1
    _same(sites.defined(s), sites.defined(sp))
    assert name != "mixed" or bool((sp.rec_p < BIG).any())
    x_args = (codes, rs, rl, dp.s_pos, dp.n_sites, sp, dp.cap_read)
    xp = splice.chain_splice_plain(*x_args)
    _same(splice.chain_splice(*x_args), xp)
    _same(splice.chain_splice(*x_args[:5], s, dp.cap_read), xp)


@pytest.mark.parametrize("strategy", ["one", "two", "graph", "gap-size",
                                      "greedy"])
def test_k17_pass_on_card_matches_jax_recording(dev, k17, strategy):
    cases, table = k17
    golden = tc.load_golden(tc.golden_path_k17(strategy))
    runs = [("mixed", None, tc.MS)]
    if strategy in tc.WALKERS:
        runs += [("long_walk", None, tc.MS),
                 ("long_walk_wide", WIDE_WALK_MAX, tc.MS)]
    if strategy == "greedy":
        runs += [("mixed_ms15", None, tc.MS17[1])]
    for rec, wm, ms in runs:
        case = cases[rec.replace("_wide", "").replace("_ms15", "")]
        got = tc.run_port_pass(strategy, case, walk_max=wm, device=dev,
                               ms=ms, k=tc.K17, table=table)
        tc.assert_matches_recording(got, golden[rec], case[2], case[3])


def test_k17_dense_probe_stress(dev):
    """K1 at k = 17 on a 2^20 chunk of random codes and a random 1 GiB
    bitfield with about 30 % of its bits set, drawn on the card: sites in
    every tile, reads across tiles, k-mers with bit 33 set."""
    codes, _w, rstart, rlen = tc.dense_stress_case(11, seed=17)
    g = torch.Generator(device=dev).manual_seed(17)

    def word():
        return torch.randint(-(1 << 31), 1 << 31, (1 << 28,), device=dev,
                             dtype=torch.int32, generator=g)

    words = (word() & word()) | (word() & word() & word() & word())
    args = [words] + [torch.from_numpy(a).to(dev)
                      for a in (codes, rstart, rlen)]
    d = probe.dense_probe(*args, tc.K17, 1 << 18)
    dp = probe.dense_probe_plain(*args, tc.K17, 1 << 18)
    _same(d, dp)
    assert int(dp.n_sites[0]) > 1 << 17
    assert bool((dp.kmers >> 33).any())


#: abundances that cross every K8 counter width (1, 2, 4, 8 bits) and
#: both ends, where nothing is counted
SOLID_ABUNDANCES = (-1, 0, 1, 2, 3, 6, 7, 14, 15, 254, 255, 256)


def _solid_launches(db, k, a, nparts, nbatches):
    """K8's launches in a build: K8a once a batch a partition, K8b once a
    partition (none at w = 1, where the counters are the bitfield); none
    of either at a < 0 or a >= 255."""
    if not 0 <= a <= 254:
        return 0, 0
    return nbatches * nparts, nparts if db.counter_bits(a) > 1 else 0


@pytest.mark.parametrize("a", SOLID_ABUNDANCES)
@pytest.mark.parametrize("k", [11, 13, 15, 17])
def test_solid_build_matches_plain(dev, k, a):
    """K8 (count and pack) against the plain build, across two batches,
    in one partition of the half-space (under the default cap: every k
    but 17 at a >= 15, two there) and in 32 (a cap of 1/32 of the
    counters' bytes); k-mers seen 300 times."""
    from br_tpu_torch.set import device_build as db

    rng = np.random.default_rng(k)
    g = rng.choice(tc.BASES, size=6000).tobytes()
    reads = tc.fuzz_reads(rng, g, 80, 4, k=k) + [g[100:400]] * 300
    batches = [db.pack_reads(reads[:50], k, dev),
               db.pack_reads(reads[50:], k, dev)]
    want = db.solid_words_plain(batches, k, a)
    name = kernels.variant("solid_count", k)
    half = 1 << (2 * k - 1)
    w = db.counter_bits(a) if 0 <= a <= 254 else 1
    for cap in (db.DEFAULT_MAX_COUNT_BYTES, half * w // 8 // 32):
        before = dict(kernels.LAUNCHES)
        got = db.build_words([batches], k, a, max_count_bytes=cap)
        torch.cuda.synchronize()
        assert torch.equal(got, want)
        nparts = -(-half // db.partition_size(k, w, cap))
        assert (kernels.LAUNCHES[name] - before[name],
                kernels.LAUNCHES["solid_pack"] - before["solid_pack"]) == \
            _solid_launches(db, k, a, nparts, 2)
        assert nparts == (2 if k == 17 and w == 8 else 1) or \
            cap != db.DEFAULT_MAX_COUNT_BYTES
    assert nparts == 32
    assert (db.popcount_words(want) > 0) == (a < 255)
    assert (db.popcount_words(want) == half) == (a < 0)


@pytest.mark.parametrize("a", [2, 254])
def test_solid_count_contention(dev, a):
    """One k-mer seen 10^5 times in one batch, in two layouts: 10^5
    copies of a k-base read (one position each, neighbouring threads on
    one counter) and a homopolymer read (every position the same k-mer,
    each thread's 16 updates on one counter): the counter reads a + 1,
    the rest of its word 0, and the bit is the plain build's."""
    from br_tpu_torch.set import device_build as db

    k = tc.K
    one = np.random.default_rng(a).choice(tc.BASES, size=k).tobytes()
    w = db.counter_bits(a)
    half = 1 << (2 * k - 1)
    for reads in ([one] * 100_000, [b"A" * (100_000 + k - 1)]):
        p = db.pack_reads(reads, k, dev)
        counts = torch.zeros(half * w // 32, dtype=torch.int32, device=dev)
        db.count_kmers(p, k, 0, a, counts)
        want = torch.zeros_like(counts)
        db.count_kmers_plain(p, k, 0, a, want)
        torch.cuda.synchronize()
        assert torch.equal(counts, want)
        fields = db.counter_fields(counts, w)
        (idx,) = torch.nonzero(fields, as_tuple=True)
        assert idx.numel() == 1 and int(fields[idx]) == a + 1
        got = db.build_words([[p]], k, a)
        assert torch.equal(got, db.solid_words_plain([p], k, a))
        assert db.popcount_words(got) == 1


@pytest.mark.parametrize("a", [0, 1, 2, 3, 14, 15, 254])
@pytest.mark.parametrize("k", [13, 17])
def test_solid_kernels_match_plain(dev, k, a):
    """K8a and K8b each against its plain version at every counter width
    (K8b from 2 bits: at a = 0 the 1-bit counters are the bitfield, and
    K8b refuses them): K8a counting two batches into the second of four
    partitions, on counters left from a first count of one batch, K8b
    on random counter words (fields above a + 1 among them) and on
    K8a's."""
    from br_tpu_torch.set import device_build as db

    rng = np.random.default_rng(a)
    g = rng.choice(tc.BASES, size=6000).tobytes()
    reads = tc.fuzz_reads(rng, g, 80, 4, k=k) + [g[200:500]] * (a + 3)
    batches = [db.pack_reads(reads[:40], k, dev),
               db.pack_reads(reads[40:], k, dev)]
    w = db.counter_bits(a)
    psize = (1 << (2 * k - 1)) // 4
    counts = torch.zeros(psize * w // 32, dtype=torch.int32, device=dev)
    db.count_kmers(batches[0], k, psize, a, counts)
    want = counts.clone()
    name = kernels.variant("solid_count", k)
    before = kernels.LAUNCHES[name]
    for p in batches:
        db.count_kmers(p, k, psize, a, counts)
        db.count_kmers_plain(p, k, psize, a, want)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES[name] == before + 2
    assert torch.equal(counts, want)
    assert int(db.counter_fields(counts, w).max()) == a + 1
    if w == 1:   # the counters are the bitfield: K8b takes w >= 2
        with pytest.raises(ValueError):
            db.threshold_pack(counts, a, counts[:counts.shape[0] // 2])
        return
    g2 = torch.Generator().manual_seed(a)
    noise = torch.randint(-(1 << 31), 1 << 31, (1 << 16,), generator=g2,
                          dtype=torch.int32).to(dev)
    for c in (noise, counts):
        words = torch.empty(c.shape[0] // w, dtype=torch.int32, device=dev)
        plain = torch.empty_like(words)
        db.threshold_pack(c, a, words, clear=False)
        db.threshold_pack_plain(c, a, plain, clear=False)
        torch.cuda.synchronize()
        assert torch.equal(words, plain)
    assert db.popcount_words(words) > 0


@pytest.mark.parametrize("clear", [False, True])
def test_solid_pack_clear(dev, clear):
    """K8b leaves the counters as they are, or zeroes them behind its
    read (the build clears every partition but the last, where there
    are several); the words are the plain version's either way."""
    from br_tpu_torch.set import device_build as db

    g = torch.Generator().manual_seed(8)
    counts = torch.randint(-(1 << 31), 1 << 31, (1 << 16,), generator=g,
                           dtype=torch.int32).to(dev)
    kept = counts.clone()
    words = torch.empty(counts.shape[0] // 2, dtype=torch.int32,
                        device=dev)
    want = torch.empty_like(words)
    db.threshold_pack_plain(kept.clone(), 2, want, clear=False)
    before = kernels.LAUNCHES["solid_pack"]
    db.threshold_pack(counts, 2, words, clear=clear)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["solid_pack"] == before + 1
    assert torch.equal(words, want)
    assert torch.equal(counts, torch.zeros_like(counts) if clear else kept)


def test_checked_build_traps_nothing_in_greedy(dev):
    """Every greedy card test here (K7 at k <= 15, and at k = 17 with ms
    7, 14 and 15, beside K1 and K3) and every sorted-table card test (K9
    and the _h kernels through the bucket index, one-bucket indexes
    among them), run again in a process whose kernels are the checked
    build (BR_BOUNDS_CHECK=1: each traceback-table index, each bitfield
    word, each bucket-index and sorted-table read checked, a trap at the
    first out of range)."""
    root = Path(__file__).resolve().parent.parent
    r = subprocess.run(
        [sys.executable, "-m", "pytest", __file__, "-q", "-p",
         "no:cacheprovider", "-k", "(greedy or hash) and not checked"],
        env=dict(os.environ, BR_BOUNDS_CHECK="1"), cwd=root,
        capture_output=True, text=True, timeout=900)
    out = r.stdout[-3000:] + r.stderr[-2000:]
    assert r.returncode == 0, out
    assert "bounds check failed" not in r.stdout, out
    assert " passed" in r.stdout and "skipped" not in r.stdout, out


def test_k17_corrector_on_card_matches_oracle(dev):
    """The default chain at k = 17 on the card, with the set built on the
    card (K8), equals the oracle."""
    from br_tpu_torch.set import device_build as db

    rng = np.random.default_rng(17)
    genome = tc.repeat_rich_genome(rng, k=tc.K17)
    reads = tc.fuzz_reads(rng, genome, 40, 5, k=tc.K17)
    solid = db.DeviceSolidSet(tc.K17, db.build_solid_words(
        [genome] * 3, tc.K17, 2, dev))
    tcor = Torch3Corrector(solid, FULL, tc.C, tc.MS, chunk=tc.CHUNK,
                           nreads=tc.R)
    got = tcor.correct_batch(reads, False)
    methods = build_methods(FULL, solid.host(), tc.C, tc.MS)
    assert got == [correct_read(r, methods, False) for r in reads]
    assert sum(a != b for a, b in zip(got, reads)) >= 10


# ---------------------------------------------------------------------------
# The sorted-table instantiations (<name>_h) and K9, with a HashSet.
# ---------------------------------------------------------------------------

HASH_KS = [13, 21, 31]
H_SITES = ["one", "two", "graph", "gap-size", "graph-wide", "gap-size-wide",
           "greedy", "greedy-ms15"]


@functools.lru_cache(maxsize=None)
def _hash_case(k):
    """kmer_cases at k and their genome's padded sorted table (numpy)."""
    cases = tc.kmer_cases(k, 1700 + k)
    table = HashSet.from_sequences(cases["mixed"][0], k).device_table()
    return cases, table


def _sorted(dev, k, bits=None):
    """The case genome's SortedTable on the card: the default index, or
    one of ``bits`` bits (0: every entry in one bucket, the worst
    skew)."""
    _cases, table_np = _hash_case(k)
    table = torch.from_numpy(table_np.view(np.int64)).to(dev)
    return dc.sorted_table(table, k, bits)


@pytest.mark.parametrize("name", ["mixed", "long_walk"])
@pytest.mark.parametrize("strategy", H_SITES)
@pytest.mark.parametrize("k", HASH_KS)
def test_hash_kernels_match_plain(dev, k, strategy, name):
    """The _h kernels (K1, K2, K5, K6 in both modes at walk_max 248 and
    2040, K7 at ms 7 and 15: 40 and 47 DP columns at k = 31) against
    their plain versions through the sorted table, and K3 on their
    records."""
    _check_hash_kernels(dev, k, strategy, name, _sorted(dev, k))


@pytest.mark.parametrize("name", ["mixed", "long_walk"])
@pytest.mark.parametrize("strategy", H_SITES)
def test_hash_kernels_one_bucket(dev, strategy, name):
    """The _h kernels at k = 21 against their plain versions through an
    index of one bucket (every entry in it, bucket_levels the table's
    levels + 1: the worst skew, every probe a search of the whole
    table)."""
    table = _sorted(dev, 21, bits=0)
    assert table.buckets == 1
    assert table.bucket_levels == int(table.starts[1]).bit_length()
    _check_hash_kernels(dev, 21, strategy, name, table)


def _check_hash_kernels(dev, k, strategy, name, table):
    cases, _table_np = _hash_case(k)
    _pieces, codes, rstart, rlen = cases[name]
    codes = torch.from_numpy(codes).to(dev)
    rs = torch.from_numpy(rstart).to(dev)
    rl = torch.from_numpy(rlen).to(dev)
    NS = site_capacity(tc.CHUNK)
    before = dict(kernels.LAUNCHES)
    d = probe.dense_probe(table, codes, rs, rl, k, NS)
    dp = probe.dense_probe_plain(table, codes, rs, rl, k, NS)
    _same(d, dp)
    assert dp.kmers.dtype == torch.int64 and int(dp.n_sites[0]) > 0
    args = (table, codes, dp.kmers, dp.s_pos, dp.n_sites, rs, rl, k)
    if strategy == "one":
        kname, fns, extra = "one_sites_h", (sites.one_sites,
                                            sites.one_sites_plain), (tc.C,)
    elif strategy == "two":
        kname, fns, extra = "two_sites_h", (two.two_sites,
                                            two.two_sites_plain), (tc.C,)
    elif strategy.startswith("greedy"):
        ms = int(strategy[9:]) if "-ms" in strategy else tc.MS
        kname, fns, extra = "greedy_sites_h", (
            greedy.greedy_sites, greedy.greedy_sites_plain), (ms, tc.C)
    else:
        wm = WIDE_WALK_MAX if strategy.endswith("-wide") else 248
        kname, fns = "walk_sites_h", (walk.walk_sites,
                                      walk.walk_sites_plain)
        args = (table, codes, dp.kmers, dp.V, *args[3:])
        extra = (tc.C, strategy.replace("-wide", ""), wm)
    s, sp = (f(*args, *extra) for f in fns)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES[kname] == before[kname] + 1
    assert kernels.LAUNCHES["dense_probe_h"] == before["dense_probe_h"] + 1
    _same(sites.defined(s), sites.defined(sp))
    # greedy at ms 7 applies no repair to these reads at k = 21 (nor does
    # the oracle's greedy): its records are held at ms 15
    assert (name != "mixed" or strategy == "greedy"
            or bool((sp.rec_p < BIG).any()))
    x_args = (codes, rs, rl, dp.s_pos, dp.n_sites, sp, dp.cap_read)
    xp = splice.chain_splice_plain(*x_args)
    _same(splice.chain_splice(*x_args), xp)
    _same(splice.chain_splice(*x_args[:5], s, dp.cap_read), xp)


@pytest.mark.parametrize("any_c", [0, 12, 61])
@pytest.mark.parametrize("strategy", ["one", "two"])
def test_hash_one_two_any_confirm(dev, strategy, any_c):
    """K2 and K5 at k = 31 with confirm counts whose rounds pass the
    first code window (two words wide for the sorted table)."""
    cases, _table_np = _hash_case(31)
    table = _sorted(dev, 31)
    _p, codes, rstart, rlen = cases["mixed"]
    codes = torch.from_numpy(codes).to(dev)
    rs = torch.from_numpy(rstart).to(dev)
    rl = torch.from_numpy(rlen).to(dev)
    dp = probe.dense_probe_plain(table, codes, rs, rl, 31,
                                 site_capacity(tc.CHUNK))
    args = (table, codes, dp.kmers, dp.s_pos, dp.n_sites, rs, rl, 31, any_c)
    fns = ((sites.one_sites, sites.one_sites_plain) if strategy == "one"
           else (two.two_sites, two.two_sites_plain))
    _same(sites.defined(fns[0](*args)), sites.defined(fns[1](*args)))


def _random_sorted_table(dev, k, n, seed):
    """(table, its k-mers): a sorted table of at most n - n // 8 distinct
    random canonical k-mers and at least n // 8 sentinels (1 << min(2k+1,
    63)), int64 bits, drawn on the card."""
    g = torch.Generator(device=dev).manual_seed(seed)
    hi = 1 << (2 * k)
    vals = torch.randint(0, hi, (n - n // 8,), device=dev, generator=g,
                         dtype=torch.int64)
    vals = torch.unique(dc.canonical_any(vals, k))
    sentinel = (1 << min(2 * k + 1, 63))
    pad = torch.full((n - vals.numel(),), sentinel - (1 << 64 if sentinel
                                                      >= 1 << 63 else 0),
                     dtype=torch.int64, device=dev)
    return torch.cat([vals, pad]), vals


@pytest.mark.parametrize("bits", [None, 0])
@pytest.mark.parametrize("k", [19, 21, 31])
def test_hash_probe_matches_plain_and_searchsorted(dev, k, bits):
    """K9 against its plain version and torch.searchsorted on a 2^20
    table, through its default index and through one of one bucket (the
    worst skew): k-mers of the table (canonical and not), below its first
    and above its last entry, random ones; at k = 31 with bits 60-61 set,
    against the sentinel 1 << 63, and the sentinel itself."""
    from br_tpu_torch.correct.hash_probe import hash_probe

    table, vals = _random_sorted_table(dev, k, 1 << 20, k)
    st = dc.sorted_table(table, k, bits)
    assert st.buckets == (1 << 19 if bits is None else 1)
    real = vals[: 1 << 16]
    rc = dc.revcomp64(real, k)
    g = torch.Generator(device=dev).manual_seed(100 + k)
    rnd = torch.randint(0, 1 << (2 * k), (1 << 16,), device=dev,
                        generator=g, dtype=torch.int64)
    edge = torch.tensor([0, int(real.min()), int(real.max()),
                         (1 << (2 * k)) - 1, 3 << (2 * k - 2), -(1 << 63),
                         1 << (2 * k)], device=dev, dtype=torch.int64)
    kmers = torch.cat([real, rc, rnd, edge])
    before = kernels.LAUNCHES["hash_probe"]
    got = hash_probe(st, kmers, k)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["hash_probe"] == before + 1
    want = dc.make_hash_probe(st, k)(kmers)
    assert torch.equal(got, want)
    # the library: searchsorted on the table with the sentinel mapped to
    # INT64_MAX (torch compares int64 as signed)
    mapped = torch.where(table < 0, torch.iinfo(torch.int64).max, table)
    cano = dc.canonical_any(kmers, k)
    pos = torch.searchsorted(mapped, cano).clamp(max=table.numel() - 1)
    assert torch.equal(got, mapped[pos] == cano)
    assert bool(got[: real.numel()].all())


@pytest.mark.parametrize("two_side", [False, True])
def test_hash_corrector_k21_on_card_matches_oracle(dev, two_side):
    """The default chain at k = 21 on the card with a HashSet, the host
    reads through the native engine, equals the oracle."""
    g, reads = tc.hash_cases(21)
    hset = HashSet.from_sequences([g], 21)
    tcor = Torch3Corrector(hset, FULL, tc.C, tc.MS, chunk=tc.CHUNK,
                           nreads=tc.R)
    got = tcor.correct_batch(reads, two_side)
    methods = build_methods(FULL, hset, tc.C, tc.MS)
    assert got == [correct_read(r, methods, two_side) for r in reads]
    assert tcor.last_stats["fallback"] >= 2


# ---------------------------------------------------------------------------
# Several shards and processes: K10 merge_counts, K11 pack/unpack, the
# mesh and the striped and ranged paths.  One card holds every shard where
# the machine has one.
# ---------------------------------------------------------------------------


def _card_mesh(d=4):
    from br_tpu_torch.parallel import mesh as pm

    n = torch.cuda.device_count()
    return pm.data_parallel_mesh([i % n for i in range(d)])


@pytest.mark.parametrize("w", [1, 2, 4, 8])
def test_merge_counts_matches_plain(dev, w):
    """K10 against its plain version for D = 1 to 4 shards, every cap of
    the width's ends and middle, fields at and near the cap and at the
    field's top, on rows whose length is a multiple of 4 (the vector
    path) and not (the word path), into a new tensor and into a given
    one."""
    from br_tpu_torch.parallel import mesh as pm

    rng = np.random.default_rng(w)
    top = (1 << w) - 1
    for d in (1, 2, 3, 4):
        for n in (4096, 1027):
            for cap in sorted({1, max(1, top // 2), top}):
                f = rng.integers(max(0, cap - 2), top + 1, (d, n, 32 // w))
                f[:, :64] = rng.integers(0, top + 1, (d, 64, 32 // w))
                rows = sum(f[..., j].astype(np.uint64) << (w * j)
                           for j in range(32 // w)).astype(np.uint32)
                t = torch.from_numpy(rows.view(np.int32))
                want = pm.merge_counts_plain(t, w, cap)
                before = kernels.LAUNCHES["merge_counts"]
                got = pm.merge_counts(t.to(dev), w, cap)
                assert torch.equal(got.cpu(), want)
                out = torch.full((n,), -1, dtype=torch.int32, device=dev)
                pm.merge_counts(t.to(dev), w, cap, out)
                torch.cuda.synchronize()
                assert torch.equal(out.cpu(), want)
                assert kernels.LAUNCHES["merge_counts"] == before + 2


@pytest.mark.parametrize("n", [1 << 20, 1 << 18, 4100, 4099])
def test_pack_codes_kernels_match_plain(dev, n):
    """K11a and K11b against their plain versions on codes of every byte
    value (bits above the 2-bit code stripped by the pack): at the chunk
    sizes, at a length that is no multiple of 16, on buffers one byte off
    alignment (the byte path), and on rows of a batch."""
    n -= n % 4
    rng = np.random.default_rng(n)
    codes = torch.from_numpy(rng.integers(0, 256, n + 4, dtype=np.uint8))
    packed = torch.from_numpy(rng.integers(0, 256, n // 4 + 4,
                                           dtype=np.uint8))
    cd, pd = codes.to(dev), packed.to(dev)
    for lo in (0, 1):
        c, p = codes[lo:lo + n], packed[lo:lo + n // 4]
        before = (kernels.LAUNCHES["pack_codes"],
                  kernels.LAUNCHES["unpack_codes"])
        got_p = dc.pack_codes(cd[lo:lo + n])
        got_c = dc.unpack_codes(pd[lo:lo + n // 4], n)
        torch.cuda.synchronize()
        assert torch.equal(got_p.cpu(), dc.pack_codes_plain(c))
        assert torch.equal(got_c.cpu(), dc.unpack_codes_plain(p, n))
        assert (kernels.LAUNCHES["pack_codes"],
                kernels.LAUNCHES["unpack_codes"]) == (before[0] + 1,
                                                      before[1] + 1)
    rows = cd[:n].reshape(-1, 4)
    assert torch.equal(dc.pack_codes(rows).reshape(-1).cpu(),
                       dc.pack_codes_plain(codes[:n]))


def test_count_sharded_on_card_matches_plain(dev):
    """count_sharded on 4 shards (all on this card, or spread over the
    cards) equals the same on 4 CPU shards (the plain K8a and K10), one
    k-mer past 255 across the shards."""
    from br_tpu_torch.parallel import mesh as pm

    rng = np.random.default_rng(5)
    batch = rng.choice(tc.BASES, (16, 3000)).astype(np.uint8)
    batch[:, :200] = ord("A")
    lens = rng.integers(0, 3000, 16).astype(np.int32)
    before = kernels.LAUNCHES["merge_counts"]
    got = pm.count_sharded(_card_mesh(), batch, lens, 11)
    want = pm.count_sharded(pm.data_parallel_mesh(["cpu"] * 4), batch,
                            lens, 11)
    assert torch.equal(got.cpu(), want) and int(want.max()) == 255
    assert kernels.LAUNCHES["merge_counts"] == before + 1


@pytest.mark.parametrize("a", [-1, 0, 2, 3, 15, 254, 255])
@pytest.mark.parametrize("k", [13, 17])
def test_solid_sharded_on_card_matches_single(dev, k, a):
    """solid_sharded on 4 shards equals the one-device K8 build (the set
    bits compared on the card), in one partition and, at k = 13, in 8."""
    from br_tpu_torch.parallel import mesh as pm
    from br_tpu_torch.set import device_build as db

    rng = np.random.default_rng(k)
    g = rng.choice(tc.BASES, size=6000).tobytes()
    reads = tc.fuzz_reads(rng, g, 80, 4, k=k) + [g[100:400]] * 300
    want = db.build_solid_words(reads, k, a, dev)
    caps = [db.DEFAULT_MAX_COUNT_BYTES]
    if k == 13 and 0 <= a <= 254:
        caps.append(4 * (1 << (2 * k - 1)) * db.counter_bits(a) // 64)
    for cap in caps:
        got = pm.solid_sharded(_card_mesh(), reads, k, a, cap)
        torch.cuda.synchronize()
        assert torch.equal(got.words, want)
    del got, want
    torch.cuda.empty_cache()


def test_sharded_corrector_on_card_matches_single(dev):
    """The default chain through a corrector with a mesh of 3 shards
    (a chunk count 3 does not divide) equals the one-device corrector and
    the oracle, with equal last_stats, and launches K11 every group of a
    shard's chunks."""
    rng = np.random.default_rng(3)
    genome = tc.repeat_rich_genome(rng)
    reads = tc.fuzz_reads(rng, genome, 60, 5)
    solid = SolidSet.from_sequences([genome], tc.K)
    # 8 chunks of 8 slots
    single = Torch3Corrector(solid, FULL, tc.C, tc.MS, chunk=1 << 12,
                             nreads=8)
    want = single.correct_batch(reads, False)
    sharded = Torch3Corrector(solid, FULL, tc.C, tc.MS, chunk=1 << 12,
                              nreads=8)
    sharded.mesh = _card_mesh(3)
    kernels.reset_launches()
    got = sharded.correct_batch(reads, False)
    assert got == want and sharded.last_stats == single.last_stats
    chunks = sharded.last_stats["chunks"]
    # a group of at most NC_MAX chunks a shard: K11a once a group
    groups = sum(-(-len(range(d, chunks, 3)) // sharded.NC_MAX)
                 for d in range(3))
    assert chunks % 3 and kernels.LAUNCHES["unpack_codes"] >= groups
    methods = build_methods(FULL, solid, tc.C, tc.MS)
    assert got == [correct_read(r, methods, False) for r in reads]


_TWO = """
import sys
rank, n, port = map(int, sys.argv[1:4])
from br_tpu_torch.correct.engine3 import Torch3Corrector
Torch3Corrector.CHUNK, Torch3Corrector.R = %(chunk)d, %(r)d
from br_tpu_torch.parallel import multihost
from br_tpu_torch.set.solid import SolidSet
multihost.initialize(f"localhost:{port}", n, rank, timeout_s=120)
solid = SolidSet.load(%(set)r)
for fn, out in ((multihost.run_correction_striped, %(striped)r),
                (multihost.run_correction_ranged, %(ranged)r)):
    fn(%(fa)r, out, solid, %(chain)r, 5, 7, False, rank, n)
multihost.shutdown()
"""


def test_two_processes_on_card_match_one(dev, tmp_path):
    """Two processes (gloo, each on a card: both on this one where it is
    the only one), striped then ranged, merge to the one-process output
    of the default chain; each child under a time limit."""
    import socket

    from br_tpu_torch.runtime import run_correction

    rng = np.random.default_rng(4)
    genome = tc.repeat_rich_genome(rng)
    reads = tc.fuzz_reads(rng, genome, 41, 5)
    fa = tmp_path / "in.fa"
    fa.write_bytes(b"".join(b">r%d\n%s\n" % (i, r)
                            for i, r in enumerate(reads)))
    solid = SolidSet.from_sequences([genome], tc.K)
    solid.save(str(tmp_path / "set.solid"))
    single = tmp_path / "single.fa"
    run_correction([str(fa)], [str(single)], solid, FULL, tc.C, tc.MS,
                   False, corrector=Torch3Corrector(
                       solid, FULL, tc.C, tc.MS, chunk=tc.CHUNK,
                       nreads=tc.R))
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    code = _TWO % {"chunk": tc.CHUNK, "r": tc.R,
                   "set": str(tmp_path / "set.solid"), "fa": str(fa),
                   "striped": str(tmp_path / "striped.fa"),
                   "ranged": str(tmp_path / "ranged.fa"), "chain": FULL}
    root = str(Path(__file__).resolve().parent.parent)
    procs = [subprocess.Popen([sys.executable, "-c", code, str(r), "2",
                               str(port)], cwd=root,
                              env={**os.environ, "PYTHONPATH": root},
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(2)]
    try:
        outs = [p.communicate(timeout=240)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    assert [p.returncode for p in procs] == [0, 0], outs
    want = single.read_bytes()
    assert (tmp_path / "striped.fa").read_bytes() == want
    assert (tmp_path / "ranged.fa").read_bytes() == want


# ---------------------------------------------------------------------------
# The chunk-batched chain: every chain kernel on a group of NC chunks in one
# launch (chunk blockIdx.y), against its plain version on each chunk.
# ---------------------------------------------------------------------------

BATCH_SITES = ["one", "two", "graph", "gap-size", "graph-wide",
               "gap-size-wide", "greedy"]
#: the chunks of a group of NC, by family name ("empty": no reads)
BATCH_GROUPS = {1: ["long_walk"], 2: ["mixed", "empty"],
                3: ["long_walk", "empty", "mixed"]}


def _batch_instance(dev, inst):
    """(k, kmer_cases families, device table) of an instantiation: the
    bitfield at k = 13 (32-bit), at k = 17 (64-bit), a HashSet's sorted
    table at k = 21 (_h)."""
    if inst == "h":
        cases, _ = _hash_case(21)
        return 21, cases, _sorted(dev, 21)
    k = {"32": 13, "64": tc.K17}[inst]
    cases = tc.kmer_cases(k, 1300) if k == 13 else tc.k17_cases()
    return k, cases, SolidSet.from_sequences(cases["mixed"][0],
                                             k).device_words(dev)


@functools.lru_cache(maxsize=None)
def _batch_cached(inst):
    return _batch_instance(torch.device("cuda"), inst)


def _group_on(dev, cases, names):
    rng = np.random.default_rng(len(names))
    chunks = []
    for n in names:
        if n == "empty":   # every slot unused, stale codes
            chunks.append((rng.integers(0, 4, tc.CHUNK, dtype=np.uint8),
                           np.full(tc.R, tc.CHUNK, np.int32),
                           np.zeros(tc.R, np.int32)))
        else:
            chunks.append(cases[n][1:])
    return [torch.from_numpy(np.stack([ch[j] for ch in chunks])).to(dev)
            for j in range(3)]


@pytest.mark.parametrize("strategy", BATCH_SITES)
@pytest.mark.parametrize("nc", [1, 2, 3])
@pytest.mark.parametrize("inst", ["32", "64", "h"])
def test_batched_kernels_match_plain(dev, inst, nc, strategy):
    """K1, the strategy's site kernel, K3 on its records and K4 on K3's
    output, each launched once on a group of NC chunks (one empty at
    NC >= 2), against the plain version on each chunk; the batched pass
    against the one-chunk pass on each chunk."""
    k, cases, table = _batch_cached(inst)
    codes, rs, rl = _group_on(dev, cases, BATCH_GROUPS[nc])
    NS = site_capacity(tc.CHUNK)
    sfx = {"32": "", "64": "64", "h": "_h"}[inst]
    before = dict(kernels.LAUNCHES)
    d = probe.dense_probe(table, codes, rs, rl, k, NS)
    dp = kernels.each_chunk(probe.dense_probe_plain, (table,),
                            (codes, rs, rl), (k, NS))
    _same(d, dp)
    assert d.kmers.shape == (nc, tc.CHUNK) and d.n_sites.shape == (nc, 1)
    args = (table, codes, dp.kmers, dp.s_pos, dp.n_sites, rs, rl, k)
    st = strategy.replace("-wide", "")
    if st in ("one", "two"):
        kname = f"{st}_sites"
        fns = ((sites.one_sites, sites.one_sites_plain) if st == "one"
               else (two.two_sites, two.two_sites_plain))
        extra = (tc.C,)
    elif st == "greedy":
        kname, fns, extra = "greedy_sites", (
            greedy.greedy_sites, greedy.greedy_sites_plain), (tc.MS, tc.C)
    else:
        wm = WIDE_WALK_MAX if strategy.endswith("-wide") else 248
        kname, fns = "walk_sites", (walk.walk_sites, walk.walk_sites_plain)
        args = (table, codes, dp.kmers, dp.V, *args[3:])
        extra = (tc.C, st, wm)
    s = fns[0](*args, *extra)
    sp = kernels.each_chunk(fns[1], args[:1], args[1:-1], (k, *extra))
    _same(sites.defined(s), sites.defined(sp))
    x_args = (codes, rs, rl, dp.s_pos, dp.n_sites, sp, dp.cap_read)
    x = splice.chain_splice(*x_args)
    xp = kernels.each_chunk(splice.chain_splice_plain, (), x_args)
    _same(x, xp)
    _same(splice.chain_splice(*x_args[:5], s, dp.cap_read), xp)
    r = reverse.reverse_slots(xp.out, rs, xp.out_len)
    _same((r,), (kernels.each_chunk(reverse.reverse_slots_plain, (),
                                    (xp.out, rs, xp.out_len)),))
    torch.cuda.synchronize()
    for name, n in ((f"dense_probe{sfx}", 1), (f"{kname}{sfx}", 1),
                    ("chain_splice", 4), ("reverse_slots", 1)):
        assert kernels.LAUNCHES[name] == before[name] + n, name
    if nc > 1:   # the empty chunk: no sites, zeros out
        e = BATCH_GROUPS[nc].index("empty")
        assert int(d.n_sites[e, 0]) == 0 and not bool(x.out[e].any())
        assert not bool(x.aux[e].any())
    wm = WIDE_WALK_MAX if strategy.endswith("-wide") else 248
    fn = make_pass3_fn(k, st, tc.C, tc.MS, tc.C, tc.CHUNK, tc.R,
                       walk_max=wm, batch=True)
    one = make_pass3_fn(k, st, tc.C, tc.MS, tc.C, tc.CHUNK, tc.R,
                        walk_max=wm)
    got = fn(table, codes, rs, rl)
    for c in range(nc):
        _same([t[c] for t in got], one(table, codes[c], rs[c], rl[c]))


def test_pack_codes_on_a_group(dev):
    """K11a and K11b once on a group of 3 x 2^20 codes (every byte value,
    bits above the code stripped by the pack), against their plain
    versions and against one launch a chunk."""
    n = 1 << 20
    rng = np.random.default_rng(3)
    codes = torch.from_numpy(rng.integers(0, 256, (3, n), dtype=np.uint8))
    packed = torch.from_numpy(rng.integers(0, 256, (3, n // 4),
                                           dtype=np.uint8))
    cd, pd = codes.to(dev), packed.to(dev)
    before = (kernels.LAUNCHES["pack_codes"],
              kernels.LAUNCHES["unpack_codes"])
    got_p, got_c = dc.pack_codes(cd), dc.unpack_codes(pd, n)
    torch.cuda.synchronize()
    assert (kernels.LAUNCHES["pack_codes"],
            kernels.LAUNCHES["unpack_codes"]) == (before[0] + 1,
                                                  before[1] + 1)
    assert got_p.shape == (3, n // 4) and got_c.shape == (3, n)
    assert torch.equal(got_p.cpu(), dc.pack_codes_plain(codes))
    assert torch.equal(got_c.cpu(), dc.unpack_codes_plain(packed, n))
    for c in range(3):
        assert torch.equal(got_p[c], dc.pack_codes(cd[c]))
        assert torch.equal(got_c[c], dc.unpack_codes(pd[c], n))


def _nc_corrector(solid, nc, chunk=1 << 12, nreads=8):
    cor = Torch3Corrector(solid, FULL, tc.C, tc.MS, chunk=chunk,
                          nreads=nreads)
    cor.NC_MAX = nc
    return cor


def _groups(chunks, nc):
    return -(-chunks // nc)


@pytest.mark.parametrize("k", [13, 17, 21])
def test_batched_corrector_on_card_matches_nc1(dev, k):
    """The default chain at NC_MAX = 3 (groups of 3 chunks, the last
    short) on the card equals NC_MAX = 1's output and last_stats and the
    oracle, at k = 13 (bitfield), 17 (bitfield, 64-bit) and 21 (HashSet);
    K11a and K3 launch once a group."""
    rng = np.random.default_rng(k)
    genome = tc.repeat_rich_genome(rng, k=k)
    reads = tc.fuzz_reads(rng, genome, 50, 5, k=k)
    solid = (HashSet.from_sequences([genome], k) if k == 21
             else SolidSet.from_sequences([genome], k))
    cor1 = _nc_corrector(solid, 1)
    got1 = cor1.correct_batch(reads, False)
    cor3 = _nc_corrector(solid, 3)
    kernels.reset_launches()
    got3 = cor3.correct_batch(reads, False)
    torch.cuda.synchronize()
    assert got3 == got1
    assert cor3.last_stats == cor1.last_stats
    chunks = cor3.last_stats["chunks"]
    wide = (cor3._wide.last_stats.get("chunks", 0)
            if cor3.last_stats["wide_retried"] else 0)
    groups = _groups(chunks, 3) + _groups(wide, 3)
    assert chunks >= 4 and chunks % 3
    assert kernels.LAUNCHES["unpack_codes"] == groups
    sfx = {13: "", 17: "64", 21: "_h"}[k]
    assert kernels.LAUNCHES["dense_probe" + sfx] == 2 * len(FULL) * groups
    assert kernels.LAUNCHES["chain_splice"] == 4 * len(FULL) * groups
    methods = build_methods(FULL, solid, tc.C, tc.MS)
    assert got3 == [correct_read(r, methods, False) for r in reads]


def test_warmup_on_card(dev):
    """``warmup`` loads every library of the corrector's instantiation
    and the native engine; the next batch's output is unchanged."""
    rng = np.random.default_rng(5)
    genome = tc.repeat_rich_genome(rng)
    reads = tc.fuzz_reads(rng, genome, 40, 5)
    solid = SolidSet.from_sequences([genome], tc.K)
    want = _nc_corrector(solid, 1).correct_batch(reads, False)
    cor = _nc_corrector(solid, 4)
    cor.warmup(False, nc=4)
    assert cor._engine is not None
    for name in ("dense_probe", "walk_sites", "chain_splice",
                 "unpack_codes"):
        assert kernels.KERNELS[name][0] in kernels._LIBS
    assert cor.correct_batch(reads, False) == want
