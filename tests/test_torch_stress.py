"""The adversarial inputs of K1, K2, K3, K5, K6 and K7
(``torch_cases.dense_stress_case``, ``splice_stress_case``,
``walk_stress_case``, ``greedy_stress_case`` and ``two_stress_case``)
hold what the card's
tests rely on: checked here, at a small size, through the kernels' plain
versions on the CPU.  The kernels themselves meet these inputs in
tests/test_torch_cuda.py."""

import numpy as np
import pytest
import torch

import torch_cases as tc
from br_tpu_torch.correct import device_codec as dc
from br_tpu_torch.correct import greedy, probe, sites, splice, two, walk
from br_tpu_torch.correct.layout import BIG, CAP_OVERFLOW, site_capacity
from br_tpu_torch.correct.sites import Sites
from br_tpu_torch.set.solid import SolidSet

CHUNK = 1 << 15


@pytest.mark.parametrize("k", [11, 13])
def test_dense_stress_case_has_sites_in_every_tile(k):
    codes, words, rstart, rlen = tc.dense_stress_case(k, seed=k, chunk=CHUNK,
                                                      R=64)
    args = [torch.from_numpy(a) for a in (words, codes, rstart, rlen)]
    d = probe.dense_probe_plain(*args, k, CHUNK)
    n = int(d.n_sites[0])
    tiles = np.flatnonzero(d.T.numpy()) // probe.TILE
    assert set(tiles) == set(range(CHUNK // probe.TILE))
    assert rstart[0] % 16 and (rlen[rstart < CHUNK] == 0).any()
    used = rstart < CHUNK
    ends = rstart[used] + rlen[used]
    assert (rstart[used] // probe.TILE != (ends - 1) // probe.TILE).any()
    # NS cut in the middle of a tile: the sites past it cap their reads
    cut = int(d.T[: 3 * probe.TILE + probe.TILE // 2].sum())
    c = probe.dense_probe_plain(*args, k, cut)
    assert 0 < cut < n and int(c.n_sites[0]) == n
    assert torch.equal(c.s_pos, d.s_pos[:cut]) and c.cap_read.any()


def test_dense_stress_case_without_solid_kmers_has_no_site():
    codes, words, rstart, rlen = tc.dense_stress_case(13, 1, chunk=CHUNK,
                                                      R=64, solid=False)
    d = probe.dense_probe_plain(*(torch.from_numpy(a) for a in (
        words, codes, rstart, rlen)), 13, 2048)
    assert int(d.n_sites[0]) == 0 and not d.vraw.any()
    assert bool((d.s_pos == BIG).all())


def _visited(s_pos, n_sites, rstart, rlen, succ, chunk):
    """Per read (listed sites, visited sites), and the visited mask."""
    n_eff = min(int(n_sites[0]), len(s_pos))
    sp = s_pos[:n_eff]
    vis = np.zeros(len(s_pos), bool)
    counts = []
    for rs, n in zip(rstart, rlen):
        lo = int(np.searchsorted(sp, rs))
        hi = int(np.searchsorted(sp, rs + n)) if n and rs < chunk else lo
        x = lo
        while x < hi:
            vis[x] = True
            if succ[x] <= x:
                break
            x = int(succ[x])
        counts.append((hi - lo, int(vis[lo:hi].sum())))
    return np.array(counts), vis


@pytest.mark.parametrize("ew,full", [(1, False), (16, False), (128, False),
                                     (1, True)])
def test_splice_stress_case_covers_its_patterns(ew, full):
    chunk = 1 << 18
    (codes, rstart, rlen, s_pos, n_sites, sites,
     cap_dense) = tc.splice_stress_case(7, ew, chunk=chunk, R=32, full=full)
    succ, s_cap, rec_p, rec_c, rec_s, _rec_e = sites
    x = splice.chain_splice_plain(
        torch.from_numpy(codes), torch.from_numpy(rstart),
        torch.from_numpy(rlen), torch.from_numpy(s_pos),
        torch.from_numpy(n_sites), Sites(*map(torch.from_numpy, sites)),
        torch.from_numpy(cap_dense))
    out_len, cap = x.out_len.numpy(), x.cap.numpy()
    counts, vis = _visited(s_pos, n_sites, rstart, rlen, succ, chunk)
    used = rstart < chunk
    assert (~used).any() and ((rlen == 0) & used).any()
    # more sites than one window, chains that end early
    assert counts[:, 1].max() > splice.WINDOW
    assert (counts[:, 1] < counts[:, 0]).any()
    n_eff = min(int(n_sites[0]), len(s_pos))
    ids = np.arange(n_eff)
    rec_ok = (rec_p.reshape(-1, tc.SLOTS)[:n_eff] < BIG).any(1)
    assert (vis[:n_eff] & rec_ok).sum() > 100
    if full:
        assert int(n_sites[0]) > len(s_pos) and counts[1, 0] == len(s_pos)
        assert cap[1] and cap_dense[1]   # capped as K1 caps it
        return
    # jumps over whole windows, successors past the read's last site
    assert (succ[:n_eff] - ids > splice.WINDOW).any()
    assert int(x.aux[1] + x.aux[2] + x.aux[3]) > 0
    assert (~vis[:n_eff] & (s_cap[:n_eff] > 0)).any()
    rcap = np.diff(np.append(rstart, chunk))
    assert out_len[3] == rcap[3] > 0 and not cap[3] and cap[5]
    assert rec_c[rec_p < BIG].max() > 16 * ew - 10   # the longest emits
    # the generator's length model agrees with the splice where uncapped
    sp = s_pos[:n_eff]
    for b in np.flatnonzero(used & ~cap & (rlen > 0)):
        lo, hi = np.searchsorted(sp, [rstart[b], rstart[b] + rlen[b]])
        assert out_len[b] == tc.splice_len(
            rstart[b], rstart[b] + rlen[b], lo, hi, succ, rec_p, rec_c,
            rec_s, chunk)
    assert (used & ~cap & (rlen > 0)).sum() > 1


@pytest.mark.parametrize("R", [0, 1025])
def test_chain_splice_refuses_slot_tables_the_kernel_cannot_stage(R):
    """K3's copy kernel stages the slot table in shared memory (1024
    slots), so the wrapper refuses more, as K1, K2 and K4 do."""
    CHUNK, NS = 1 << 12, 2048
    i32 = dict(dtype=torch.int32)
    sites = Sites(torch.full((NS,), NS, **i32), torch.zeros(NS, **i32),
                  torch.full((NS * tc.SLOTS,), BIG, **i32),
                  torch.zeros(NS * tc.SLOTS, **i32),
                  torch.zeros(NS * tc.SLOTS, **i32),
                  torch.zeros((NS * tc.SLOTS, 1), **i32))
    with pytest.raises(ValueError, match="read slots per chunk"):
        splice.chain_splice(
            torch.zeros(CHUNK, dtype=torch.uint8),
            torch.full((R,), CHUNK, **i32), torch.zeros(R, **i32),
            torch.full((NS,), BIG, **i32), torch.zeros(1, **i32), sites,
            torch.zeros(R, dtype=torch.bool))


def _reverse_ref(codes, rstart, rlen):
    """In-slot reversal position by position (the slot of p: the last
    with rstart <= p), sources clamped to the chunk, 2-bit codes."""
    out = codes.copy()
    n = len(codes)
    for p in range(n):
        r = np.searchsorted(rstart, p, side="right") - 1
        o = p - rstart[r] if r >= 0 else n
        if r >= 0 and o < rlen[r]:
            out[p] = codes[min(max(rstart[r] + rlen[r] - 1 - o, 0), n - 1)]
    return out & 3


def test_reverse_layouts_cover_their_patterns():
    """K4's card layouts (tests/test_torch_cuda.py) hold their patterns,
    and the plain reversal equals a position-by-position reference on
    them."""
    from br_tpu_torch.correct.reverse import reverse_slots_plain

    lay = tc.reverse_layouts(1)
    for name, (codes, rstart, rlen) in lay.items():
        got = reverse_slots_plain(*(torch.from_numpy(x)
                                    for x in (codes, rstart, rlen)))
        assert np.array_equal(got.numpy(), _reverse_ref(codes, rstart, rlen))
        assert (codes & 4).any() and np.all(np.diff(rstart) >= 0), name
    n = tc.CHUNK
    rs, rl = lay["unaligned"][1:]
    cap = np.diff(np.append(rs, n))
    used = rs < n
    assert rs[0] % 16 and (rl[used] == 0).any() and (~used).any()
    assert ((rl == cap) & used & (rl > 0)).any()
    rs = lay["short_slots"][1]
    assert max(np.searchsorted(rs, w + 512) - np.searchsorted(rs, w)
               for w in range(0, n, 512)) > 32
    rs, rl = lay["exact_fill"][1:]
    used = rs < n
    assert np.array_equal(rl[used], np.diff(np.append(rs[used], n)))
    rs, rl = lay["past_slot"][1:]
    assert (rl[:3] > np.diff(rs[:4])).any() and rs[3] + rl[3] > n
    assert lay["before_first"][1][0] == 1000


# K6 and K7: the adversarial inputs of tests/test_torch_cuda.py hold their
# patterns through the plain walk and greedy attempts (recorded with
# torch_cases.record_attempts).  The walk patterns are checked at a small
# walk_max, where the plain walk's step loop is short.

WM = 64


def _sites_inputs(pieces, codes, rstart, rlen):
    table = SolidSet.from_sequences(pieces, tc.K).device_words("cpu")
    c, rs, rl = (torch.from_numpy(x) for x in (codes, rstart, rlen))
    d = probe.dense_probe_plain(table, c, rs, rl, tc.K,
                                site_capacity(len(codes)))
    return table, c, rs, rl, d


@pytest.mark.parametrize("strategy", ["graph", "gap-size"])
def test_walk_stress_case_covers_its_patterns(strategy):
    table, c, rs, rl, d = _sites_inputs(*tc.walk_stress_case(
        5, walk_max=WM, deletions=(40, 120), flanks=(30, 90)))
    with tc.record_attempts(walk, ["walk_plain", "err_len_plain"]) as calls:
        s = walk.walk_sites_plain(table, c, d.kmers, d.V, d.s_pos,
                                  d.n_sites, rs, rl, tc.K, tc.C, strategy,
                                  WM)
    ok, cap, n = (torch.cat([o[j] for _a, o in calls["walk_plain"]])
                  for j in (0, 1, 3))
    fill = ~torch.cat([a[4] for a, _o in calls["walk_plain"]])
    err = torch.cat([o[0] for _a, o in calls["err_len_plain"]])
    rem = torch.cat([a[7] - a[5] for a, _o in calls["err_len_plain"]])
    steps = set((n[~ok & ~cap] - 1).tolist())        # declined at step
    assert {31, 32, 33, WM - 1, WM} <= steps         # revisits, to walk_max
    assert max(steps) > WM + 1                       # Brent past walk_max
    assert bool((cap & (n == WM + 1)).any())         # capped at walk_max
    assert bool((err > 32).any())                    # long error stretches
    assert bool(((err > tc.K) & (err == rem)).any())  # V scan to read end
    assert bool((s.s_cap == CAP_OVERFLOW).any())     # a site past SLOTS
    if strategy == "gap-size":
        assert bool((err == tc.K).any())             # the One attempt
        assert bool((fill & ok).any()) and bool((fill & cap).any())


def _gotoh_ties(x, y):
    """Cells of rust-bio's DP (scores as greedy.align_tables) where the
    Match/Subst score ties Ins or Del at the best."""
    NEG = greedy.NEG
    S = [0] + [-1 - j for j in range(1, len(y) + 1)]
    I = [NEG] * (len(y) + 1)
    ties = 0
    for r in range(1, len(x) + 1):
        Sn, In, D = [-1 - r], [-1 - r], NEG
        for j in range(1, len(y) + 1):
            i_n = max(I[j] - 1, S[j] - 2)
            D = max(D - 1, Sn[j - 1] - 2)
            diag = S[j - 1] + (1 if x[r - 1] == y[j - 1] else -1)
            best = max(diag, i_n, D)
            ties += diag == best and (i_n == best or D == best)
            Sn.append(best)
            In.append(i_n)
        S, I = Sn, In
    return ties


def test_greedy_stress_case_covers_its_patterns():
    table, c, rs, rl, d = _sites_inputs(*tc.greedy_stress_case(
        5, chunk=1 << 15, nreads=64))
    with tc.record_attempts(greedy, ["greedy_attempt_plain"]) as calls:
        greedy.greedy_sites_plain(table, c, d.kmers, d.s_pos, d.n_sites, rs,
                                  rl, tc.K, tc.MS, tc.C)
    ties = walk_fail0 = rem_cut = last_probe = 0
    its = set()
    for (probe_, code_at, k, ms, nb, ii, rg, corr, lf), a in calls[
            "greedy_attempt_plain"]:
        rem = lf - ii
        its |= set((a.cnt[a.ok] - 2).tolist())
        wk, wks = corr, [corr]
        fail = torch.full_like(ii, ms)
        for st in range(ms):
            ns, sa = sites.alt_next(probe_, wk, k)
            nxt = torch.where(ns != 1, wk, dc.add_nuc(wk, sa, k))
            rev = torch.stack([nxt == w for w in wks]).any(0)
            fail = torch.where((fail == ms) & ((ns != 1) | rev), st, fail)
            wks.append(nxt)
            wk = nxt
        walk_fail0 += int((fail == 0).sum())
        # the read ends before a step the walk reached: rem < it decides
        rem_cut += int((~a.ok & (rem + 1 < torch.clamp(fail, max=ms))).sum())
        for it in range(ms):       # validation failing on its last probe
            km, alive = wks[it + 1], rem - it >= nb
            for t in range(nb):
                km = dc.add_nuc(km, code_at(ii + it + t), k)
                v = probe_(km)
                if t == nb - 1:
                    last_probe += int((alive & ~v).sum())
                alive = alive & v
        pre = rg >> 2
        for j in range(min(40, len(ii))):
            before = [int(pre[j] >> (2 * (k - 2 - t))) & 3
                      for t in range(k - 1)]
            read = [int(code_at(ii[j:j + 1] + t)) for t in range(ms - 1)]
            path = [int(corr[j]) & 3] + [int((w[j] & 3)) for w in wks[1:]]
            ties += _gotoh_ties(before + read, before + path) > 0
    assert its == set(range(tc.MS))          # every step decides somewhere
    assert walk_fail0 and rem_cut and last_probe and ties


def test_two_stress_case_covers_its_patterns():
    """Through the plain two attempt (recorded): every one of the 13
    scenarios is selected somewhere; ties between perfect scenarios occur
    broken by a unique one_more (applied) and with none or with several
    (not applied); attempts meet every rem gate (rem 1-4) and windows
    past the read end; a site of each pass caps with CAP_OVERFLOW; the
    last read ends at the chunk's last position."""
    pieces, codes, rstart, rlen = case = tc.two_stress_case(
        tc.TWO_STRESS_SEED)
    assert (rstart + rlen == tc.CHUNK).any()
    table, c, rs, rl, d = _sites_inputs(*case)
    args = (table, c, d.kmers, d.s_pos, d.n_sites, rs, rl, tc.K, tc.C)
    with tc.record_attempts(two, ["two_attempt_plain"]) as calls:
        s = two.two_sites_plain(*args)
    selected, rems = set(), set()
    ties = {"one": 0, "none": 0, "several": 0}
    for (probe_, code_at, k, cc, ii, rg, corr, lf), a in calls[
            "two_attempt_plain"]:
        keep, more, _ = two.two_scores(probe_, code_at, k, cc, ii, corr, lf)
        nk1, nk2 = keep.sum(0), (keep & more).sum(0)
        sel = torch.where(nk1 == 1, keep, keep & more).long().argmax(0)
        selected |= set(sel[a.ok].tolist())
        tie = nk1 > 1
        ties["one"] += int((tie & (nk2 == 1) & a.ok).sum())
        ties["none"] += int((tie & (nk2 == 0) & ~a.ok).sum())
        ties["several"] += int((tie & (nk2 > 1) & ~a.ok).sum())
        rems |= set((lf - ii).tolist())
    assert selected == set(range(len(two.APPLY_OFF)))
    assert all(ties.values()), ties
    assert {1, 2, 3, 4} <= rems
    assert bool((s.s_cap == CAP_OVERFLOW).any())
    assert bool((sites.one_sites_plain(*args).s_cap == CAP_OVERFLOW).any())
