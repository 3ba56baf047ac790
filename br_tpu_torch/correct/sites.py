"""The attempt sites of a pass: what the site kernels share, and K2
``one_sites``.

Port of the site-block queue of br_tpu/correct/engine3.py:1592-1708 with
``_alt_info32_arr`` (:966) and ``dirty_sim`` (:1526).  Every listed site
runs its whole chain of nested attempts: the exactly-one-alternative gate,
the strategy's attempt, a repair record per applied attempt (at most
SLOTS, beyond that the site caps with CAP_OVERFLOW; an attempt that hits
an engineered bound caps it with CAP_ATTEMPT), and the scan machine for k
steps past the last repair, which either finds a nested site (attempt
again there), reaches the read end, or hands over to the next listed site
(the successor).  The CUDA side of this is ``csrc/sites_common.cuh``; the
plain side is ``run_sites_plain``, which every site module's plain
version drives with its own attempt.

K2 ``one_sites`` (the One attempt, :300) launches ``csrc/one_sites.cu``
for CUDA tensors and runs ``one_sites_plain`` for CPU tensors.  Every
site kernel's wrapper takes one chunk, or a group of NC chunks as one
launch (every chunk's array with a leading axis of NC, the table
shared), and returns ``Sites`` with the same leading axis.  Every
site kernel takes K1's k-mers (``device_codec.kmer_dtype``) and the
pass's table, a solid bitfield or a sorted ``HashSet`` table, and
launches the instantiation ``kernels.table_kernel`` names for them: the
64-bit one for a bitfield at k = 17, the ``_h`` one for a sorted table.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from br_tpu_torch import kernels
from br_tpu_torch.correct import device_codec as dc
from br_tpu_torch.correct.layout import (
    BIG, CAP_ATTEMPT, CAP_OVERFLOW, DONE_END, DONE_PURE, PENDING, SLOTS,
    check_slots)


class Sites(NamedTuple):
    succ: torch.Tensor   # (NS,) int32 successor site id, NS for none
    s_cap: torch.Tensor  # (NS,) int32 cap reason, 0 for none
    rec_p: torch.Tensor  # (NS*SLOTS,) int32 record position, BIG if unused
    rec_c: torch.Tensor  # (NS*SLOTS,) int32 emitted base count
    rec_s: torch.Tensor  # (NS*SLOTS,) int32 input positions consumed
    rec_e: torch.Tensor  # (NS*SLOTS, EW) int32 emitted bases, 16 per word


class Attempt(NamedTuple):
    """One attempt over a set of lanes (AttemptOut3, engine3.py:220)."""

    ok: torch.Tensor        # bool, the repair applies
    cap: torch.Tensor       # bool, an engineered bound was hit
    new_kmer: torch.Tensor  # int64 register after the emitted bases
    consumed: torch.Tensor  # int64 input positions skipped
    cnt: torch.Tensor       # int64 emitted bases
    emit: torch.Tensor      # (lanes, EW) int64 emit words


def check_site_args(table, codes, kmers, s_pos, n_sites, rstart, rlen,
                    k: int) -> tuple:
    """What every site kernel's wrapper checks, once a call (a group's
    once); returns the leading axes (``kernels.group_lead``)."""
    kind = dc.table_kind(table)
    dc.check_k(k, kind)
    dev = codes.device
    lead = kernels.group_lead(codes)
    CHUNK = codes.shape[-1]
    kernels.check(codes, "codes", torch.uint8, dev, lead=lead)
    kernels.check(kmers, "kmers", dc.kmer_dtype(k, kind), dev, CHUNK, lead)
    kernels.check(s_pos, "s_pos", torch.int32, dev, lead=lead)
    kernels.check(n_sites, "n_sites", torch.int32, dev, 1, lead)
    kernels.check(rstart, "rstart", torch.int32, dev, lead=lead)
    kernels.check(rlen, "rlen", torch.int32, dev, rstart.shape[-1], lead)
    kernels.check_table(table, k, dev)
    check_slots(rstart)
    return lead


def empty_sites(NS: int, EW: int, dev, lead: tuple = ()) -> Sites:
    """Output buffers of a site kernel (it writes the entries that
    ``defined`` keeps, and leaves the rest as they are), each with the
    leading axes ``lead``."""
    rec = torch.empty((3,) + lead + (NS * SLOTS,), dtype=torch.int32,
                      device=dev)
    return Sites(torch.empty(lead + (NS,), dtype=torch.int32, device=dev),
                 torch.empty(lead + (NS,), dtype=torch.int32, device=dev),
                 rec[0], rec[1], rec[2],
                 torch.empty(lead + (NS * SLOTS, EW), dtype=torch.int32,
                             device=dev))


def defined(s: Sites) -> Sites:
    """The entries of a site kernel's output that it writes and K3 reads:
    succ, s_cap, rec_p, and for each used record (rec_p < BIG) its rec_c,
    rec_s and first ceil(rec_c / 16) emit words; every other entry 0.  The
    plain versions write those entries as 0, so a kernel and its plain
    version are compared through this."""
    used = s.rec_p < BIG
    words = torch.arange(s.rec_e.shape[-1], device=s.rec_e.device)
    live = used[..., None] & (words * 16 < s.rec_c[..., None])
    zero = torch.zeros((), dtype=torch.int32, device=s.rec_p.device)
    return Sites(s.succ, s.s_cap, s.rec_p, torch.where(used, s.rec_c, zero),
                 torch.where(used, s.rec_s, zero),
                 torch.where(live, s.rec_e, zero))


def as_i32(x: torch.Tensor) -> torch.Tensor:
    """int64 holding uint32 words -> the same bits as int32."""
    return (((x & 0xFFFFFFFF) ^ 0x80000000) - 0x80000000).int()


def one_sites(table, codes, kmers, s_pos, n_sites, rstart, rlen, k: int,
              c: int) -> Sites:
    """Run every listed site of a ``one`` pass (see the module docstring)."""
    lead = check_site_args(table, codes, kmers, s_pos, n_sites, rstart,
                           rlen, k)
    if c < 0:
        raise ValueError(f"confirm must be >= 0, got {c}")
    if kernels.on_cuda(codes):
        return launch_sites("one_sites", 1, lead, table, codes,
                            (kmers, s_pos, n_sites, rstart, rlen), k, (c,))
    return kernels.each_chunk(one_sites_plain, (table,),
                              (codes, kmers, s_pos, n_sites, rstart, rlen),
                              (k, c))


def launch_sites(kernel: str, EW: int, lead: tuple, table, codes, chunked,
                 k: int, params: tuple, after: tuple = ()) -> Sites:
    """Launch a site kernel's instantiation for ``table`` on a chunk or
    a group (leading axes ``lead``), with the arguments every site kernel
    takes in its order: NC, codes, the table, ``chunked`` (the chunk's
    arrays after the codes, ending in s_pos, n_sites, rstart, rlen),
    CHUNK, R, k, ``params`` (the strategy's), NS, ``after``, the output
    buffers (EW emit words a record) and the table's trailing
    arguments."""
    NS = chunked[-4].shape[-1]
    out = empty_sites(NS, EW, codes.device, lead)
    name, tab, extra = kernels.table_kernel(kernel, k, table)
    kernels.launch(
        name, kernels.group_nc(lead), codes, tab, *chunked, codes.shape[-1],
        chunked[-1].shape[-1], k, *params, NS, *after, *out, *extra)
    return out


def window(codes3, CHUNK: int):
    """code_at over int64 codes: positions clipped into the chunk."""

    def code_at(idx):
        return codes3[idx.clamp(0, CHUNK - 1)]

    return code_at


def _bases(km):
    """The four bases as a (4, 1) column beside km's lanes."""
    return torch.arange(4, dtype=torch.int64, device=km.device)[:, None]


def alt_last(probe, km):
    """(count, replacement) of the alternative last bases of km (the four
    probes in one batch)."""
    base = (km >> 2) << 2
    a = _bases(km)
    oks = probe(base[None] ^ a).long()
    return oks.sum(0), base ^ (a * oks).sum(0)


def alt_next(probe, km, k: int):
    """(count, sum of the bases) of the solid successors of km (the four
    probes in one batch)."""
    a = _bases(km)
    oks = probe(dc.add_nuc(km[None], a, k)).long()
    return oks.sum(0), (a * oks).sum(0)


def one_attempt_plain(probe, code_at, k: int, c: int, ii, corr, lf):
    """The One attempt over lanes (make_one_attempt32_arr, engine3.py:
    300): scenarios D (offset 0), S (1), I (2)."""
    rem = lf - ii
    corr_ok = probe(corr)
    keep, more = [], []
    for off in range(3):
        km, allv, last = corr, corr_ok, None
        for s in range(c + 1):
            km = dc.add_nuc(km, code_at(ii + off + s), k)
            v = probe(km)
            if s < c:
                allv = allv & v
            else:
                last = v
        keep.append((off + c <= rem) & allv)
        more.append((rem > c + off + 1) & last)
    nk = sum(x.long() for x in keep)
    keep2 = [a & b for a, b in zip(keep, more)]
    nk2 = sum(x.long() for x in keep2)
    ok = (nk == 1) | ((nk > 1) & (nk2 == 1))
    sel = [torch.where(nk == 1, a, b) for a, b in zip(keep, keep2)]
    offset = sel[1].long() + 2 * sel[2].long()
    return Attempt(ok, torch.zeros_like(ok), corr, offset,
                   torch.ones_like(offset), (corr & 3)[:, None])


def run_sites_plain(table, codes, kmers, s_pos, n_sites, rstart, rlen,
                    k: int, EW: int, attempt, trace=None) -> Sites:
    """The site chains in plain PyTorch ops: all sites advance together,
    one attempt per round, until no chain is pending.

    ``attempt(probe, code_at, ii, rg, corr, lf)`` runs the strategy over
    the lanes whose gate passed (flat positions ii, registers rg, gated
    alternatives corr, read ends lf) and returns an ``Attempt``.
    ``trace``, when given, is called after every round with the round's
    site ids, its gate mask, the probes each lane's dirty simulation made,
    the lanes that then search for their successor and the rank that
    search finds; it changes nothing (chip_smoke.py counts the chains'
    dependent rounds with it)."""
    CHUNK, NS, dev = codes.shape[0], s_pos.shape[0], codes.device
    probe = dc.make_probe(table, k)
    succ = torch.full((NS,), NS, dtype=torch.int32, device=dev)
    s_cap = torch.zeros(NS, dtype=torch.int32, device=dev)
    rec_p = torch.full((NS * SLOTS,), BIG, dtype=torch.int32, device=dev)
    rec_c = torch.zeros(NS * SLOTS, dtype=torch.int32, device=dev)
    rec_s = torch.zeros(NS * SLOTS, dtype=torch.int32, device=dev)
    rec_e = torch.zeros((NS * SLOTS, EW), dtype=torch.int32, device=dev)
    n_eff = min(int(n_sites[0]), NS)
    if n_eff == 0:
        return Sites(succ, s_cap, rec_p, rec_c, rec_s, rec_e)

    code_at = window((codes & 3).long(), CHUNK)
    sites = s_pos[:n_eff].long()
    rs, rl = rstart.long(), rlen.long()
    rid = torch.searchsorted(rs, sites, right=True) - 1
    lenf = rs[rid] + rl[rid]
    i = sites.clone()
    reg = kmers[sites].long()
    t = torch.full((n_eff,), k, dtype=torch.int64, device=dev)
    nrec = torch.zeros(n_eff, dtype=torch.int64, device=dev)
    act = torch.arange(n_eff, device=dev)
    while act.numel():
        ii, rg, tt, nr, lf = i[act], reg[act], t[act], nrec[act], lenf[act]
        nalts, corr = alt_last(probe, rg)
        gate = nalts == 1
        g = gate.nonzero().squeeze(1)
        res = attempt(probe, code_at, ii[g], rg[g], corr[g], lf[g])
        n = act.numel()

        def spread(x, fill=0):
            out = torch.full((n,) + x.shape[1:], fill, dtype=x.dtype,
                             device=dev)
            out[g] = x
            return out

        capa = spread(res.cap, False)
        ok = spread(res.ok, False) & ~capa
        consumed = spread(res.consumed)
        new_kmer = spread(res.new_kmer)

        over = ok & (nr >= SLOTS)
        wr = ok & ~over
        widx = act[wr] * SLOTS + nr[wr]
        rec_p[widx] = ii[wr].int()
        rec_c[widx] = spread(res.cnt)[wr].int()
        rec_s[widx] = consumed[wr].int()
        rec_e[widx] = as_i32(spread(res.emit)[wr])
        nrec[act] = nr + wr.long()
        s_cap[act[over]] = CAP_OVERFLOW
        s_cap[act[capa]] = CAP_ATTEMPT
        bad = over | capa

        # dirty simulation: the scan machine for k steps past a repair
        si = torch.where(ok, ii + consumed, ii + 1)
        sreg = torch.where(ok, new_kmer, rg)
        st = torch.where(ok, 0, tt)
        prev = ok.clone()
        state = torch.full_like(si, -1)
        probes = torch.zeros_like(si)
        for _ in range(k):
            run = state < 0
            pure = run & (st >= k)
            end = run & ~pure & (si >= lf)
            go = run & ~pure & ~end
            state = torch.where(pure, DONE_PURE, state)
            state = torch.where(end, DONE_END, state)
            nreg = dc.add_nuc(sreg, code_at(si), k)
            v = probe(nreg)
            sreg = torch.where(go, nreg, sreg)
            probes = probes + go.long()
            nested = go & ~v & prev
            state = torch.where(nested, PENDING, state)
            adv = go & ~nested
            prev = torch.where(adv, v, prev)
            si = si + adv.long()
            st = st + adv.long()
        state = torch.where(state < 0, DONE_PURE, state)

        # successor: first listed site at or after si inside the read
        q = torch.searchsorted(sites, si)
        qc = q.clamp(max=n_eff - 1)
        has = ((state == DONE_PURE) & ~bad & (si < CHUNK) & (q < n_eff)
               & (sites[qc] < lf))
        succ[act[has]] = q[has].int()
        if trace is not None:
            trace(act, gate, probes,
                  (state == DONE_PURE) & ~bad & (si < CHUNK), q)

        pend = (state == PENDING) & ~bad
        nxt = act[pend]
        i[nxt] = si[pend]
        reg[nxt] = sreg[pend]
        t[nxt] = st[pend] + 1
        act = nxt
    return Sites(succ, s_cap, rec_p, rec_c, rec_s, rec_e)


def one_sites_plain(table, codes, kmers, s_pos, n_sites, rstart, rlen,
                    k: int, c: int) -> Sites:
    """The same function as K2 in plain PyTorch ops."""

    def attempt(probe, code_at, ii, rg, corr, lf):
        return one_attempt_plain(probe, code_at, k, c, ii, corr, lf)

    return run_sites_plain(table, codes, kmers, s_pos, n_sites, rstart,
                           rlen, k, 1, attempt)
