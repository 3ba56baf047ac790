"""K7 ``greedy_sites``: the attempt sites of a ``greedy`` pass.

Port of the site-block queue of br_tpu/correct/engine3.py:1592-1708 for
strategy ``greedy``, whose attempt is ``make_greedy_attempt32_arr``
(:719-965), and of the global alignment it runs (``global_align_ops``,
br_tpu/correct/alignment.py:32, rust-bio's Gotoh aligner and its
traceback tie-breaks).  The attempt walks ms unique-successor steps from
the gated alternative, aligns before + read against before + path (one DP
over the whole strings; step ``it`` is the traceback from cell
(k-1+it, k-1+it+2)), and takes the first step whose alignment has two
consecutive Matches past the before bases and whose nb validation probes
are solid, unless a step fails or runs out of read first.  The offset rule
is reference.py:524-552; a negative consumed count caps the site.  The
site chain around the attempt is that of ``sites.py``.

``greedy_sites`` launches ``csrc/greedy_sites.cu`` for CUDA tensors and
runs ``greedy_sites_plain`` for CPU tensors.
"""

from __future__ import annotations

import torch

from br_tpu_torch import kernels
from br_tpu_torch.correct import device_codec as dc
from br_tpu_torch.correct.alignment import OP_DEL, OP_INS, OP_MATCH, OP_SUBST
from br_tpu_torch.correct.layout import BPW
from br_tpu_torch.correct.sites import (
    Attempt, Sites, alt_next, check_site_args, launch_sites,
    run_sites_plain)

TB_START = 4
GAP_OPEN = GAP_EXT = -1
NEG = -(1 << 14)


def check_ms(ms: int, nb: int) -> None:
    """JAX refuses ms + 1 > BPW (one emit word, engine3.py:726-727)."""
    if not 1 <= ms or ms + 1 > BPW:
        raise ValueError("greedy max_search too large for one emit word "
                         f"(1 <= ms <= {BPW - 1}), got {ms}")
    if nb < 0:
        raise ValueError(f"greedy validation count must be >= 0, got {nb}")


def greedy_sites(table, codes, kmers, s_pos, n_sites, rstart, rlen, k: int,
                 ms: int, nb: int) -> Sites:
    """Run every listed site of a ``greedy`` pass, on a chunk or a group
    (``sites.one_sites``)."""
    lead = check_site_args(table, codes, kmers, s_pos, n_sites, rstart,
                           rlen, k)
    check_ms(ms, nb)
    if kernels.on_cuda(codes):
        return launch_sites("greedy_sites", 1, lead, table, codes,
                            (kmers, s_pos, n_sites, rstart, rlen), k,
                            (ms, nb))
    return kernels.each_chunk(greedy_sites_plain, (table,),
                              (codes, kmers, s_pos, n_sites, rstart, rlen),
                              (k, ms, nb))


def align_tables(x, y):
    """rust-bio's Gotoh DP of x against y over lanes (lists of (N,)
    int64 codes): the traceback codes of every cell, each (len(x)+1,
    len(y)+1, N), for the S, I and D layers (alignment.py)."""
    Lr, Lc, N, dev = len(x), len(y), x[0].shape[0], x[0].device
    tb = torch.full((3, Lr + 1, Lc + 1, N), TB_START, dtype=torch.int64,
                    device=dev)
    full = lambda v: torch.full((N,), v, dtype=torch.int64, device=dev)
    S = [full(0)] + [full(GAP_OPEN + GAP_EXT * j) for j in range(1, Lc + 1)]
    I = [full(NEG) for _ in range(Lc + 1)]
    tb[0, 0, 1:] = OP_DEL
    tb[2, 0, 2:] = OP_DEL
    for r in range(1, Lr + 1):
        Sn = [full(GAP_OPEN + GAP_EXT * r)]
        In = [Sn[0]]
        tb[0, r, 0] = OP_INS
        if r > 1:
            tb[1, r, 0] = OP_INS
        D = full(NEG)
        for j in range(1, Lc + 1):
            ext, opn = I[j] + GAP_EXT, S[j] + GAP_OPEN + GAP_EXT
            i_n = torch.maximum(ext, opn)
            ib = torch.where(ext > opn, OP_INS, tb[0, r - 1, j])
            ext, opn = D + GAP_EXT, Sn[j - 1] + GAP_OPEN + GAP_EXT
            D = torch.maximum(ext, opn)
            db = torch.where(ext > opn, OP_DEL, tb[0, r, j - 1])
            m = x[r - 1] == y[j - 1]
            best = S[j - 1] + torch.where(m, 1, -1)
            sb = torch.where(m, OP_MATCH, OP_SUBST)
            sb = torch.where(i_n > best, OP_INS, sb)
            best = torch.maximum(best, i_n)
            sb = torch.where(D > best, OP_DEL, sb)
            best = torch.maximum(best, D)
            Sn.append(best)
            In.append(i_n)
            tb[0, r, j], tb[1, r, j], tb[2, r, j] = sb, ib, db
        S, I = Sn, In
    return tb


def traceback_offset(tb, r0, j0, bl: int):
    """The traceback from (r0, j0) over lanes: whether two consecutive
    Matches follow the first ``bl`` ops, and the offset of reference.py:
    534-551 (engine3.py:891-919)."""
    _, Lr1, Lc1, N = tb.shape
    T = Lr1 + Lc1 - 2
    lanes = torch.arange(N, device=tb.device)
    r, j = r0.clone(), j0.clone()
    layer = tb[0, r, j, lanes]
    ops = []
    nops = torch.zeros_like(r)
    for _ in range(T):
        active = layer != TB_START
        ops.append(torch.where(active, layer, TB_START))
        nops = nops + active.long()
        is_ins, is_del = layer == OP_INS, layer == OP_DEL
        rs, js = (r - 1).clamp(min=0), (j - 1).clamp(min=0)
        nxt = torch.where(is_ins, tb[1, r, j, lanes],
                          torch.where(is_del, tb[2, r, j, lanes],
                                      tb[0, rs, js, lanes]))
        r = torch.where(active & ~is_del, r - 1, r)
        j = torch.where(active & ~is_ins, j - 1, j)
        layer = torch.where(active, nxt, layer)
    ops_rev = torch.stack(ops)                           # (T, N)
    w = torch.arange(T, device=tb.device)[:, None]
    ops_f = torch.gather(ops_rev, 0, (nops[None] - 1 - w).clamp(0, T - 1))
    in_ops = w < nops[None]
    is_m = (ops_f == OP_MATCH) & in_ops
    contrib = torch.where(ops_f == OP_INS, 1,
                          torch.where(ops_f == OP_DEL, -1, 0)) * in_ops
    nxt_m = torch.cat([is_m[1:], torch.zeros_like(is_m[:1])])
    pair = is_m & nxt_m & (w >= bl) & (w + 1 <= nops[None] - 1)
    first_w = torch.where(pair, w, T + 1).min(0).values
    offset = (contrib * ((w >= bl) & (w < first_w[None]))).sum(0)
    rev_ind = (ops_rev == OP_INS) | (ops_rev == OP_DEL)
    pref = torch.cumprod((rev_ind | ~in_ops).long(), 0).bool() & in_ops
    rev_c = torch.where(ops_rev == OP_INS, 1,
                        torch.where(ops_rev == OP_DEL, -1, 0))
    return pair.any(0), offset - (rev_c * pref).sum(0)


def greedy_attempt_plain(probe, code_at, k: int, ms: int, nb: int, ii, rg,
                         corr, lf):
    """The greedy attempt over lanes (make_greedy_attempt32_arr)."""
    rem = lf - ii
    wks, path = [corr], [corr & 3]
    fail_step = torch.full_like(ii, ms)
    for s in range(ms):
        ns, sa = alt_next(probe, wks[s], k)
        bf = ns != 1
        nxt = torch.where(bf, wks[s], dc.add_nuc(wks[s], sa, k))
        rev = torch.zeros_like(bf)
        for p in wks:
            rev = rev | (nxt == p)
        fail_step = torch.where((fail_step == ms) & (bf | rev), s, fail_step)
        wks.append(nxt)
        path.append(sa)
    pre = rg >> 2
    before = [(pre >> (2 * (k - 2 - t))) & 3 for t in range(k - 1)]
    x = before + [code_at(ii + t) for t in range(ms - 1)]
    tb = align_tables(x, before + path)

    ok = torch.zeros_like(ii, dtype=torch.bool)
    decided = torch.zeros_like(ok)
    it_sel = torch.zeros_like(ii)
    off = torch.zeros_like(ii)
    for it in range(ms):
        fail = (fail_step == it) | (rem < it)
        r0 = torch.full_like(ii, k - 1 + it)
        exists, o = traceback_offset(tb, r0, r0 + 2, k - 1)
        okc = (rem - it) >= nb
        km = wks[it + 1]
        for t in range(nb):
            km = dc.add_nuc(km, code_at(ii + it + t), k)
            okc = okc & probe(km)
        acc = exists & okc & ~fail
        pick = acc & ~decided
        ok = ok | pick
        it_sel = torch.where(pick, it, it_sel)
        off = torch.where(pick, o, off)
        decided = decided | fail | acc
    cnt = it_sel + 2
    raw = cnt + off
    new_kmer = torch.stack(wks[1:])[it_sel, torch.arange(ii.shape[0])]
    emit = torch.zeros_like(ii)
    for t in range(ms + 1):
        emit = emit | torch.where(t < cnt, path[t] << (2 * t), 0)
    return Attempt(ok, ok & (raw < 0), new_kmer, raw.clamp(min=0), cnt,
                   emit[:, None])


def greedy_sites_plain(table, codes, kmers, s_pos, n_sites, rstart, rlen,
                       k: int, ms: int, nb: int) -> Sites:
    """The same function as K7 in plain PyTorch ops."""

    def attempt(probe, code_at, ii, rg, corr, lf):
        return greedy_attempt_plain(probe, code_at, k, ms, nb, ii, rg, corr,
                                    lf)

    return run_sites_plain(table, codes, kmers, s_pos, n_sites, rstart,
                           rlen, k, 1, attempt)
