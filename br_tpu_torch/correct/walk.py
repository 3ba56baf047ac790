"""K6 ``walk_sites``: the attempt sites of a ``graph`` or ``gap-size``
pass.

Port of the site-block queue of br_tpu/correct/engine3.py:1592-1708 for
the two walk strategies, with their attempts ``make_graph_attempt32_arr``
(:1179) and ``make_gap_attempt32_arr`` (:1198), the exact error length
``err_fn`` (:1459) and the walk semantics of ``_tiered_walk32`` (:1099),
``_walk_phase32`` (:983) and ``_brent_walk32`` (:1031).

The walk from the gated alternative takes unique-successor steps: a
branch or a revisit (exact, against every k-mer walked up to walk_max)
declines; reaching the error's first correct k-mer accepts (graph mode);
walking max_steps completes a fill (fill mode); the step taken at
walk_max caps, cap outranking accept.  Past walk_max the walk goes on
with Brent's cycle detection: a branch or a cycle declines, and arriving,
completing a fill or passing T3_CAP stays capped (the emit no longer
fits).  ``gap-size`` dispatches on the error length: graph mode below k,
the One attempt at k, a fill of err_len - k steps above.  The site chain
around the attempt is that of ``sites.py``.

``walk_sites`` launches ``csrc/walk_sites.cu`` for CUDA tensors and runs
``walk_sites_plain`` for CPU tensors.
"""

from __future__ import annotations

import torch

from br_tpu_torch import kernels
from br_tpu_torch.correct import device_codec as dc
from br_tpu_torch.correct.layout import (
    ACCEPT, BIG, BPW, CAP, DECLINE, RUN, T3_CAP, WALK_MAX, walk_profile)
from br_tpu_torch.correct.sites import (
    Attempt, Sites, alt_next, check_site_args, launch_sites,
    one_attempt_plain, run_sites_plain)

#: the kernel's mode argument per strategy.
MODES = {"graph": 0, "gap-size": 1}


def walk_sites(table, codes, kmers, V, s_pos, n_sites, rstart, rlen,
               k: int, c: int, strategy: str,
               walk_max: int = WALK_MAX) -> Sites:
    """Run every listed site of a ``graph`` or ``gap-size`` pass, on a
    chunk or a group (``sites.one_sites``); ``V`` is K1's validity mask
    (the error length's jump to the next valid position)."""
    lead = check_site_args(table, codes, kmers, s_pos, n_sites, rstart,
                           rlen, k)
    kernels.check(V, "V", torch.bool, codes.device, codes.shape[-1], lead)
    mode = MODES[strategy]
    wp = walk_profile(walk_max)
    if c < 0:
        raise ValueError(f"confirm must be >= 0, got {c}")
    if kernels.on_cuda(codes):
        # the kernel scans V 16 bytes a lane, every chunk's
        if codes.shape[-1] % 16 or V.data_ptr() % 16:
            raise ValueError("walk_sites needs a chunk of a multiple of 16 "
                             "positions and a 16-byte aligned V")
        return launch_sites("walk_sites", wp.ew, lead, table, codes,
                            (kmers, V, s_pos, n_sites, rstart, rlen), k,
                            (c,), (mode, walk_max, wp.ew))
    return kernels.each_chunk(walk_sites_plain, (table,),
                              (codes, kmers, V, s_pos, n_sites, rstart,
                               rlen), (k, c, strategy, walk_max))


def next_valid(V):
    """nv: the first valid position at or after each position, BIG where
    none (the JAX reverse cummin, engine3.py:1440)."""
    pos = torch.arange(V.shape[0], device=V.device)
    nv = torch.where(V, pos, BIG).flip(0)
    return torch.cummin(nv, 0).values.flip(0)


def err_len_plain(probe, code_at, k: int, nv, kmers, ii, rg, lf):
    """error_len (mod.rs:130-152) over lanes: at most k explicit absorbs,
    then the jump to the next valid position (engine3.py:1459-1499)."""
    CHUNK = nv.shape[0]
    rem = lf - ii
    km = rg
    j = torch.zeros_like(ii)
    done = torch.zeros_like(ii, dtype=torch.bool)
    for j2 in range(1, k + 1):
        at_end = j2 >= rem
        step = ~done
        nk = dc.add_nuc(km, code_at(ii + j2), k)
        adv = step & ~at_end
        f = adv & probe(nk)
        j = torch.where(step, j2, j)
        km = torch.where(adv, nk, km)
        done = done | (step & (at_end | f))
    start = ii + k + 1
    q = nv[start.clamp(max=CHUNK - 1)]
    okq = (start < CHUNK) & (q < lf)
    end_idx = torch.where(okq, q, torch.where(rem >= 2, ii + rem - 1, ii))
    j = torch.where(done, j, torch.where(okq, q - ii, rem))
    km = torch.where(done, km,
                     kmers[end_idx.clamp(0, CHUNK - 1)].long())
    return j, km


def walk_plain(probe, k: int, corr, fc, use_fc, max_steps, walk_max: int):
    """The walk over lanes: (ok, cap, emit words, n, final k-mer)."""
    N, dev = corr.shape[0], corr.device
    ew = walk_profile(walk_max).ew
    wk = corr.clone()
    n = torch.ones(N, dtype=torch.int64, device=dev)
    status = torch.full((N,), RUN, dtype=torch.int64, device=dev)
    buf = torch.zeros((N, ew), dtype=torch.int64, device=dev)
    buf[:, 0] = corr & 3
    hist = torch.full((N, walk_max + 1), -1, dtype=torch.int64, device=dev)
    hist[:, 0] = corr
    # history up to walk_max: exact revisits; the step at walk_max caps
    while True:
        act = ((status == RUN) & (use_fc | (n - 1 < max_steps))
               & (n <= walk_max))
        a = act.nonzero().squeeze(1)
        if not a.numel():
            break
        w, nn = wk[a], n[a]
        ns, sa = alt_next(probe, w, k)
        w2 = dc.add_nuc(w, sa, k)
        dec = (ns != 1) | (hist[a] == w2[:, None]).any(1)
        hist[a, nn] = w2
        wi = nn // BPW
        buf[a, wi] = buf[a, wi] | (sa << (2 * (nn % BPW)))
        acc = use_fc[a] & (w2 == fc[a])
        status[a] = torch.where(
            dec, DECLINE, torch.where(nn >= walk_max, CAP,
                                      torch.where(acc, ACCEPT, RUN)))
        wk[a] = w2
        n[a] = nn + 1
    # past walk_max: Brent's cycle detection (a graph walk that capped on
    # first_correct stays capped)
    t3 = (status == CAP) & ~(use_fc & (wk == fc))
    status[t3] = RUN
    saved = wk.clone()
    lam = torch.zeros_like(n)
    power = torch.ones_like(n)
    while True:
        a = (t3 & (status == RUN)).nonzero().squeeze(1)
        if not a.numel():
            break
        w, nn = wk[a], n[a]
        ns, sa = alt_next(probe, w, k)
        w2 = dc.add_nuc(w, sa, k)
        acc = use_fc[a] & (w2 == fc[a])
        done = ~use_fc[a] & (nn >= max_steps[a])
        dec = (ns != 1) | (w2 == saved[a])
        status[a] = torch.where(
            dec, DECLINE, torch.where(acc | done | (nn + 1 >= T3_CAP), CAP,
                                      RUN))
        wk[a] = w2
        n[a] = nn + 1
        lm = lam[a] + 1
        renew = lm >= power[a]
        saved[a] = torch.where(renew, w2, saved[a])
        power[a] = torch.where(renew, power[a] * 2, power[a])
        lam[a] = torch.where(renew, 0, lm)
    ok = torch.where(use_fc, status == ACCEPT, status == RUN)
    return ok, status == CAP, buf, n, wk


def walk_attempt_plain(probe, code_at, k: int, c: int, nv, kmers,
                       strategy: str, walk_max: int, ii, rg, corr, lf):
    """The graph or gap-size attempt over lanes."""
    err, fc = err_len_plain(probe, code_at, k, nv, kmers, ii, rg, lf)
    if strategy == "graph":
        use_fc = torch.ones_like(ii, dtype=torch.bool)
        max_steps = torch.full_like(ii, walk_max)
        walking = use_fc
    else:
        use_fc = err < k
        max_steps = (err - k).clamp(min=0)
        walking = err != k
    w = walking.nonzero().squeeze(1)
    ok_w, cap_w, buf, n, wk = walk_plain(probe, k, corr[w], fc[w],
                                         use_fc[w], max_steps[w], walk_max)
    ok = torch.zeros_like(walking)
    cap = torch.zeros_like(walking)
    new_kmer = corr.clone()
    cnt = torch.ones_like(ii)
    emit = torch.zeros((ii.shape[0], buf.shape[1]), dtype=torch.int64,
                       device=ii.device)
    ok[w], cap[w], new_kmer[w], cnt[w], emit[w] = ok_w, cap_w, wk, n, buf
    consumed = torch.where(use_fc, err + 1, cnt)
    o = (~walking).nonzero().squeeze(1)
    if o.numel():
        one = one_attempt_plain(probe, code_at, k, c, ii[o], corr[o], lf[o])
        ok[o], consumed[o] = one.ok, one.consumed
        emit[o, 0] = one.emit[:, 0]
    return Attempt(ok, cap, new_kmer, consumed, cnt, emit)


def walk_sites_plain(table, codes, kmers, V, s_pos, n_sites, rstart, rlen,
                     k: int, c: int, strategy: str,
                     walk_max: int = WALK_MAX) -> Sites:
    """The same function as K6 in plain PyTorch ops."""
    nv = next_valid(V)

    def attempt(probe, code_at, ii, rg, corr, lf):
        return walk_attempt_plain(probe, code_at, k, c, nv, kmers,
                                  strategy, walk_max, ii, rg, corr, lf)

    return run_sites_plain(table, codes, kmers, s_pos, n_sites, rstart,
                           rlen, k, walk_profile(walk_max).ew, attempt)
