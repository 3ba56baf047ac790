"""The adversarial inputs of K1 and K3 (``torch_cases.dense_stress_case``
and ``splice_stress_case``) hold what the card's tests rely on: checked
here, at a small size, through the kernels' plain versions on the CPU.
The kernels themselves meet these inputs in tests/test_torch_cuda.py."""

import numpy as np
import pytest
import torch

import torch_cases as tc
from br_tpu_torch.correct import probe, splice
from br_tpu_torch.correct.layout import BIG
from br_tpu_torch.correct.sites import Sites

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
