"""The port's ``graph`` and ``gap-size`` passes (K1, K6 and K3 plain
versions, on the CPU) against the JAX package's recorded passes, at the
default walk profile (walk_max = 248) and the wide one (2040); the error
length against the oracle's; and the port's ``Graph``, ``GapSize`` and
``error_len`` oracles against ``br_tpu``'s.

The recordings (golden/torch_<strategy>_pass_k13.npz) hold br_tpu's pass
at k=13, CHUNK=2^14, R=32, c=5 on seven chunk families, and on the
long-walk family at the wide profile too."""

import numpy as np
import pytest
import torch

import torch_cases as tc
from br_tpu_torch.correct.layout import WIDE_WALK_MAX

WALKERS = ("graph", "gap-size")


@pytest.fixture(scope="module")
def cases():
    return tc.all_cases()


@pytest.fixture(scope="module")
def golden():
    return {st: tc.load_golden(tc.golden_path(st)) for st in WALKERS}


@pytest.mark.parametrize("name", tc.FAMILIES)
@pytest.mark.parametrize("strategy", WALKERS)
def test_walk_pass_matches_jax(cases, golden, strategy, name):
    g, codes, rstart, rlen = cases[name]
    got = tc.run_port_pass(strategy, cases[name])
    tc.assert_matches_recording(got, golden[strategy][name], rstart, rlen)
    if name == "long_walk":
        # the 400-base accept and fill out-run walk_max and cap; the
        # chimeras' ~1500-step walks decline past it, uncapped
        assert got[2].sum() == 2 and got[3][2] == 2


@pytest.mark.parametrize("strategy", WALKERS)
def test_walk_pass_wide_matches_jax(cases, golden, strategy):
    """The long-walk family at walk_max = 2040: the long accept and the
    long fill now apply on the device."""
    g, codes, rstart, rlen = cases["long_walk"]
    got = tc.run_port_pass(strategy, cases["long_walk"],
                           walk_max=WIDE_WALK_MAX)
    tc.assert_matches_recording(got, golden[strategy]["long_walk_wide"],
                                rstart, rlen)
    assert not got[2].any() and got[3][5] == 2
    # the accepted walk emitted far more than the default 249 bases
    assert (got[1] - rlen)[2] >= 300


def test_error_len_matches_oracle(cases):
    """The plain version's error length (K6's err_fn: k explicit absorbs,
    then the next valid position) at every site of every family equals
    the oracle's error_len on the read."""
    from br_tpu_torch.correct import device_codec as dc
    from br_tpu_torch.correct import walk
    from br_tpu_torch.correct.probe import dense_probe_plain
    from br_tpu_torch.correct.reference import error_len
    from br_tpu_torch.correct.sites import window
    from br_tpu_torch.set.solid import SolidSet

    seen = 0
    for name, (g, codes, rstart, rlen) in cases.items():
        solid = SolidSet.from_sequences([g], tc.K)
        table = solid.device_words("cpu")
        c, rs, rl = (torch.from_numpy(x) for x in (codes, rstart, rlen))
        d = dense_probe_plain(table, c, rs, rl, tc.K, 2048)
        sites = d.s_pos[: int(d.n_sites[0])].long()
        rid = torch.searchsorted(rs.long(), sites, right=True) - 1
        lf = rs.long()[rid] + rl.long()[rid]
        err, fc = walk.err_len_plain(
            dc.make_solid_probe_any(table, tc.K),
            window((c & 3).long(), c.shape[0]), tc.K,
            walk.next_valid(d.V), d.kmers, sites, d.kmers[sites].long(), lf)
        for q, p in enumerate(sites.tolist()):
            b = int(rid[q])
            read = tc.BASES[codes[rstart[b] : rstart[b] + rlen[b]]].tobytes()
            want = error_len(read[p - rstart[b]:], int(d.kmers[p]), solid)
            assert (int(err[q]), int(fc[q])) == want, (name, p)
            seen += 1
    assert seen > 300


def test_error_len_oracle_matches_br_tpu():
    from br_tpu import codec
    from br_tpu.correct.reference import error_len as j_error_len
    from br_tpu.set.solid import SolidSet as JSolidSet
    from br_tpu_torch.correct.reference import error_len
    from br_tpu_torch.set.solid import SolidSet

    rng = np.random.default_rng(31)
    genome = tc.repeat_rich_genome(rng)
    mine = SolidSet.from_sequences([genome], tc.K)
    theirs = JSolidSet.from_sequences([genome], tc.K)
    for r in tc.fuzz_reads(rng, genome, 50, 6):
        for p in rng.integers(tc.K, len(r), 8):
            km = codec.seq2bit(r[p - tc.K + 1 : p + 1])
            assert error_len(r[p:], km, mine) == \
                j_error_len(r[p:], km, theirs)


@pytest.mark.parametrize("strategy", WALKERS)
def test_walk_oracles_match_br_tpu(strategy):
    tc.assert_catalog_agrees(strategy)
    tc.assert_oracles_agree(strategy, seed=303)


@pytest.mark.parametrize("walk_max,name", [(248, "dense"),
                                           (WIDE_WALK_MAX, "long_walk")])
@pytest.mark.parametrize("strategy", WALKERS)
def test_splice_reads_only_defined_site_entries(cases, strategy, walk_max,
                                                name):
    """The site kernels write only what ``sites.defined`` keeps (rec_p
    of every slot; count, consumed and ceil(cnt/16) emit words of each
    record).  With every other entry of the walk records scrambled, the
    splice gives the same result; the plain version writes them as 0."""
    from br_tpu_torch.correct import sites, splice, walk
    from br_tpu_torch.correct.probe import dense_probe_plain
    from br_tpu_torch.set.solid import SolidSet

    g, codes, rstart, rlen = cases[name]
    table = SolidSet.from_sequences([g], tc.K).device_words("cpu")
    c, rs, rl = (torch.from_numpy(x) for x in (codes, rstart, rlen))
    d = dense_probe_plain(table, c, rs, rl, tc.K, 2048)
    s = walk.walk_sites_plain(table, c, d.kmers, d.V, d.s_pos, d.n_sites,
                              rs, rl, tc.K, tc.C, strategy, walk_max)
    kept = sites.defined(s)
    for x, y in zip(kept, s):
        assert torch.equal(x, y)
    gen = torch.Generator().manual_seed(5)

    def junk(x, keep):
        noise = torch.randint(-2**31, 2**31 - 1, x.shape, generator=gen,
                              dtype=torch.int64).int()
        return torch.where(keep, x, noise)

    used = s.rec_p < 2**30
    assert int((s.rec_c[used] > 16).sum()) > 0   # multi-word records
    words = torch.arange(s.rec_e.shape[1])
    live = used[:, None] & (words[None, :] * 16 < s.rec_c[:, None])
    noisy = sites.Sites(s.succ, s.s_cap, s.rec_p, junk(s.rec_c, used),
                        junk(s.rec_s, used), junk(s.rec_e, live))
    x_args = (c, rs, rl, d.s_pos, d.n_sites)
    want = splice.chain_splice_plain(*x_args, s, d.cap_read)
    got = splice.chain_splice_plain(*x_args, noisy, d.cap_read)
    for x, y in zip(got, want):
        assert torch.equal(x, y)
