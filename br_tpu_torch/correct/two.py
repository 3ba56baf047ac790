"""K5 ``two_sites``: the attempt sites of a ``two`` pass.

Port of the site-block queue of br_tpu/correct/engine3.py:1592-1708 for
strategy ``two``, whose attempt is ``make_two_attempt32`` (:359-490): the
13 two-error scenarios of exist/two.rs.  Each has an apply step (a
candidate register and its gate), a score over c+1 k-mers from its apply
offset, its emitted bases (the last 1-3 bases of the alternative or of the
candidate; none for DCI, which consumes 1, PARITY.md:29) and its correct
offset for the record and the one_more probe.  A unique perfect score
applies; among several, a unique one_more.  The site chain around the
attempt is that of ``sites.py``.

``two_sites`` launches ``csrc/two_sites.cu`` for CUDA tensors and runs
``two_sites_plain`` for CPU tensors.
"""

from __future__ import annotations

import torch

from br_tpu_torch import kernels
from br_tpu_torch.correct import device_codec as dc
from br_tpu_torch.correct.sites import (
    Attempt, Sites, alt_last, alt_next, check_site_args, launch_sites,
    run_sites_plain)

#: per scenario, in exist/two.rs's order: II IS SS SD DD ICI ICS ICD SCI
#: SCS SCD DCI DCD.
APPLY_OFF = (3, 2, 2, 1, 0, 4, 3, 3, 4, 3, 2, 4, 1)
CORRECT_OFF = (2, 2, 2, 1, 0, 3, 4, 2, 4, 3, 2, 1, 1)
#: emitted bases per scenario: how many, and whether they are the last
#: bases of the alternative k-mer (else of the scenario's candidate).
EMIT_N = (1, 1, 2, 2, 2, 1, 2, 2, 3, 3, 3, 0, 3)
EMIT_CORR = (True, True, False, False, False, True, False, False, False,
             False, False, False, False)


def two_sites(table, codes, kmers, s_pos, n_sites, rstart, rlen, k: int,
              c: int) -> Sites:
    """Run every listed site of a ``two`` pass, on a chunk or a group
    (``sites.one_sites``)."""
    lead = check_site_args(table, codes, kmers, s_pos, n_sites, rstart,
                           rlen, k)
    if c < 0:
        raise ValueError(f"confirm must be >= 0, got {c}")
    if kernels.on_cuda(codes):
        return launch_sites("two_sites", 1, lead, table, codes,
                            (kmers, s_pos, n_sites, rstart, rlen), k, (c,))
    return kernels.each_chunk(two_sites_plain, (table,),
                              (codes, kmers, s_pos, n_sites, rstart, rlen),
                              (k, c))


def two_scenarios(probe, code_at, k: int, ii, corr, rem):
    """Each scenario's apply step, in exist/two.rs's order: (gate,
    candidate register km2) over lanes (make_two_attempt32, engine3.py:
    383-411)."""

    def absorb(km, idx):
        return dc.add_nuc(km, code_at(idx), k)

    def nxt(km):
        n, code = alt_next(probe, km, k)
        return n == 1, dc.add_nuc(km, code, k)

    true = torch.ones_like(rem, dtype=torch.bool)
    t1 = absorb(corr, ii + 1)
    t1v = probe(t1)
    n, ss = alt_last(probe, t1)
    sd_ok, sd = nxt(corr)
    t3 = absorb(corr, ii + 3)
    second = absorb(corr, ii + 2)
    icd_ok, icd = nxt(second)
    sci = absorb(t1, ii + 3)
    t2 = absorb(t1, ii + 2)
    n2, scs = alt_last(probe, t2)
    scd_ok, scd = nxt(t1)
    dcd_ok, dcd = nxt(absorb(corr, ii))
    return [
        (true, corr),                                       # II
        (true, corr),                                       # IS
        ((rem >= 2) & ~t1v & (n == 1), ss),                 # SS
        ((rem >= 1) & sd_ok, sd),                           # SD
        (sd_ok, sd),                                        # DD
        ((rem >= 4) & probe(t3), t3),                       # ICI
        ((rem >= 4) & ~t1v & (n == 1), ss),                 # ICS
        ((rem >= 4) & icd_ok, icd),                         # ICD
        (rem >= 4, sci),                                    # SCI
        ((rem >= 3) & t1v & ~probe(t2) & (n2 == 1), scs),   # SCS
        ((rem >= 2) & scd_ok, scd),                         # SCD
        (rem >= 4, sci),                                    # DCI
        ((rem >= 2) & dcd_ok, dcd),                         # DCD
    ]


def emitted(s: int, corr, km2):
    """The bases scenario s emits, first to last: the last EMIT_N[s]
    bases of corr or of its candidate."""
    src, ne = (corr if EMIT_CORR[s] else km2), EMIT_N[s]
    return [(src >> (2 * (ne - 1 - t))) & 3 for t in range(ne)]


def two_scores(probe, code_at, k: int, c: int, ii, corr, lf):
    """(keep, more, candidates): per scenario over lanes, a perfect score
    (its gate, its candidate and the c k-mers after it from APPLY_OFF
    solid, within the read) and its one_more (corr >> 2, the emitted
    bases and c+1 codes from CORRECT_OFF solid, within the read); keep
    and more are (13, lanes)."""
    rem = lf - ii
    keeps, mores, km2s = [], [], []
    for s, (a_ok, km2) in enumerate(two_scenarios(probe, code_at, k, ii,
                                                  corr, rem)):
        off_a, off_c = APPLY_OFF[s], CORRECT_OFF[s]
        km = km2
        score = a_ok & probe(km2) & (off_a + c <= rem)
        for t in range(c):
            km = dc.add_nuc(km, code_at(ii + off_a + t), k)
            score = score & probe(km)
        om = corr >> 2
        for b in emitted(s, corr, km2):
            om = dc.add_nuc(om, b, k)
        for t in range(c + 1):
            om = dc.add_nuc(om, code_at(ii + off_c + t), k)
        keeps.append(score)
        mores.append((rem > c + off_c + 1) & probe(om))
        km2s.append(km2)
    return torch.stack(keeps), torch.stack(mores), km2s


def two_attempt_plain(probe, code_at, k: int, c: int, ii, rg, corr, lf):
    """The 13 scenarios over lanes (make_two_attempt32, engine3.py:359)."""
    keep, more, km2s = two_scores(probe, code_at, k, c, ii, corr, lf)
    emits, new_kmers = [], []
    for s, km2 in enumerate(km2s):
        ew = torch.zeros_like(rg)
        nk = rg >> 2
        for t, b in enumerate(emitted(s, corr, km2)):
            ew = ew | (b << (2 * t))
            nk = dc.add_nuc(nk, b, k)
        emits.append(ew)
        new_kmers.append(nk)
    keep2 = keep & more
    nk1, nk2 = keep.sum(0), keep2.sum(0)
    ok = (nk1 == 1) | ((nk1 > 1) & (nk2 == 1))
    sel = torch.where(nk1 == 1, keep, keep2).long()
    consumed = (torch.tensor(CORRECT_OFF, device=sel.device)[:, None]
                * sel).sum(0)
    cnt = (torch.tensor(EMIT_N, device=sel.device)[:, None] * sel).sum(0)
    emit = (torch.stack(emits) * sel).sum(0)
    new_kmer = (torch.stack(new_kmers) * sel).sum(0)
    return Attempt(ok, torch.zeros_like(ok), new_kmer, consumed, cnt,
                   emit[:, None])


def two_sites_plain(table, codes, kmers, s_pos, n_sites, rstart, rlen,
                    k: int, c: int) -> Sites:
    """The same function as K5 in plain PyTorch ops."""

    def attempt(probe, code_at, ii, rg, corr, lf):
        return two_attempt_plain(probe, code_at, k, c, ii, rg, corr, lf)

    return run_sites_plain(table, codes, kmers, s_pos, n_sites, rstart,
                           rlen, k, 1, attempt)
