"""K3 ``chain_splice``: the visited sites of every read and its spliced
output.

Port of the whole-read chain walk (br_tpu/correct/engine3.py:1723-1749)
and the splice (:1751-1839, with ``_compact`` :195 and ``_lower_bound``
:183).  A read's visited sites are its head site (the first listed site
at or after its start) and the successors from there; their repair
records, in order, cut the read into verbatim segments, emitted bases and
a tail; a record's emitted bases are 16 to a word of its row of
``rec_e`` (one word for ``one``, ``two`` and ``greedy``, ``EW`` words of
up to walk_max + 1 bases for the walk strategies).  Cap rules are the
JAX pass's: a capped site anywhere in the
read, a negative verbatim length, an output longer than the slot, a
negative tail, and K1's site overflow.  Unlike :1822-1827 nothing is
clipped to the slot's last position, so a read that fills its slot
exactly keeps its last emitted base (ROADMAP C, the high fault).

Positions of a slot past ``out_len`` are written 0, and so are positions
before the first slot.  ``aux`` entries 0-4 and 7 are filled here; 5 and
6 need the record capacity NR over all reads and are finished by the pass
(``engine3.make_pass3_fn``).

``chain_splice`` launches ``csrc/chain_splice.cu`` for CUDA tensors and
runs ``chain_splice_plain`` for CPU tensors, on one chunk or on a group
of NC chunks in one call (every argument and result with a leading axis
of NC; ``aux`` (NC, 8)).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from br_tpu_torch import kernels
from br_tpu_torch.correct.layout import (
    BIG, CAP_ATTEMPT, CAP_OVERFLOW, CAP_ROUNDS, SLOTS, check_slots)
from br_tpu_torch.correct.sites import Sites


#: sites per window of the kernel's chain walk (K3_W in chain_splice.cu).
WINDOW = 512


class Spliced(NamedTuple):
    out: torch.Tensor      # (CHUNK,) uint8 codes after the pass
    out_len: torch.Tensor  # (R,) int32 read lengths after the pass
    cap: torch.Tensor      # (R,) bool read needs the host oracle
    rec_cnt: torch.Tensor  # (R,) int32 visited repair records per read
    aux: torch.Tensor      # (8,) int32 counters, see make_pass3_fn


def chain_splice(codes, rstart, rlen, s_pos, n_sites, sites: Sites,
                 cap_dense) -> Spliced:
    """Walk every read's site chain and splice its output, on a chunk
    or a group of chunks."""
    dev = codes.device
    lead = kernels.group_lead(codes)
    NS, R = s_pos.shape[-1], rstart.shape[-1]
    kernels.check(codes, "codes", torch.uint8, dev, lead=lead)
    kernels.check(rstart, "rstart", torch.int32, dev, lead=lead)
    kernels.check(rlen, "rlen", torch.int32, dev, R, lead)
    check_slots(rstart)
    kernels.check(s_pos, "s_pos", torch.int32, dev, lead=lead)
    kernels.check(n_sites, "n_sites", torch.int32, dev, 1, lead)
    kernels.check(cap_dense, "cap_dense", torch.bool, dev, R, lead)
    for name in ("succ", "s_cap"):
        kernels.check(getattr(sites, name), name, torch.int32, dev, NS,
                      lead)
    for name in ("rec_p", "rec_c", "rec_s"):
        kernels.check(getattr(sites, name), name, torch.int32, dev,
                      NS * SLOTS, lead)
    re = sites.rec_e
    if (re.dtype != torch.int32 or re.device != dev
            or re.dim() != len(lead) + 2 or tuple(re.shape[:-2]) != lead
            or re.shape[-2] != NS * SLOTS or not re.is_contiguous()):
        raise ValueError("rec_e must be a contiguous (NS*SLOTS, EW) int32 "
                         "tensor a chunk on the codes' device")
    if kernels.on_cuda(codes):
        return _chain_splice_cuda(codes, rstart, rlen, s_pos, n_sites,
                                  sites, cap_dense, lead)
    return kernels.each_chunk(chain_splice_plain, (),
                              (codes, rstart, rlen, s_pos, n_sites, sites,
                               cap_dense))


def _chain_splice_cuda(codes, rstart, rlen, s_pos, n_sites, sites: Sites,
                       cap_dense, lead: tuple) -> Spliced:
    CHUNK, R, NS, dev = (codes.shape[-1], rstart.shape[-1], s_pos.shape[-1],
                         codes.device)
    EW = sites.rec_e.shape[-1]
    # segment tables (output offset, verbatim start and length, record
    # row), one region per read (its site range), and per read its body
    # length, last record end, table start and size: written by the walk
    # kernel, read by the copy kernel, which writes every position of out
    seg = torch.empty(lead + (4, NS * SLOTS), dtype=torch.int32, device=dev)
    rtab = torch.empty(lead + (4, R), dtype=torch.int32, device=dev)
    out = torch.empty(lead + (CHUNK,), dtype=torch.uint8, device=dev)
    out_len = torch.empty(lead + (R,), dtype=torch.int32, device=dev)
    cap = torch.empty(lead + (R,), dtype=torch.bool, device=dev)
    rec_cnt = torch.empty(lead + (R,), dtype=torch.int32, device=dev)
    aux = torch.zeros(lead + (8,), dtype=torch.int32, device=dev)
    kernels.launch(
        "chain_splice", kernels.group_nc(lead), codes, rstart, rlen, s_pos,
        n_sites, *sites, cap_dense, CHUNK, R, NS, EW, seg, rtab, out,
        out_len, cap, rec_cnt, aux)
    return Spliced(out, out_len, cap, rec_cnt, aux)


def chain_splice_plain(codes, rstart, rlen, s_pos, n_sites, sites: Sites,
                       cap_dense) -> Spliced:
    """The same function in plain PyTorch ops: the chain walk advances
    every read one site per round; the splice is one gather."""
    CHUNK, R, NS, dev = (codes.shape[0], rstart.shape[0], s_pos.shape[0],
                         codes.device)
    n_raw = int(n_sites[0])
    n_eff = min(n_raw, NS)
    rs, rl = rstart.long(), rlen.long()
    rnext = torch.cat([rs[1:], rs.new_full((1,), CHUNK)])
    rcap = rnext - rs
    rend = rs + rl
    sp = s_pos[:n_eff].long()
    lo = torch.searchsorted(sp, rs)
    hi = torch.where(rl > 0, torch.searchsorted(sp, rend), lo)
    hi = torch.where(rs < CHUNK, hi, lo)

    # chain walk from every read's head site
    succ = sites.succ.long()
    visited = torch.zeros(NS, dtype=torch.bool, device=dev)
    cur = lo.clone()
    while True:
        live = cur < hi
        if not bool(live.any()):
            break
        visited[cur[live]] = True
        nx = succ[cur.clamp(max=NS - 1)]
        cur = torch.where(live & (nx > cur), nx, NS)

    # visited records in (site, slot) order
    rec_ok = (sites.rec_p.view(NS, SLOTS) < BIG) & visited[:, None]
    flat = rec_ok.flatten().nonzero().squeeze(1)
    p = sites.rec_p.long()[flat]
    cnt = sites.rec_c.long()[flat]
    sh = sites.rec_s.long()[flat]
    emit = sites.rec_e.long()[flat] & 0xFFFFFFFF      # (M, EW)
    EW = emit.shape[1]
    rr = torch.searchsorted(rs, p, right=True) - 1
    M = flat.numel()
    first = torch.ones(M, dtype=torch.bool, device=dev)
    first[1:] = rr[1:] != rr[:-1]
    last = torch.ones(M, dtype=torch.bool, device=dev)
    last[:-1] = rr[1:] != rr[:-1]
    prev_end = torch.cat([p.new_zeros(1), (p + sh)[:-1]])
    pe = torch.where(first, rs[rr], prev_end)
    vlen = p - pe
    cap = cap_dense.clone()
    cap[rr[vlen < 0]] = True
    vlen = vlen.clamp(0, CHUNK)
    slen = vlen + cnt
    body = torch.zeros(R, dtype=torch.int64, device=dev).index_add_(
        0, rr, slen)
    excl = torch.cumsum(slen, 0) - slen
    read_base = torch.zeros(R, dtype=torch.int64, device=dev)
    read_base[rr[first]] = excl[first]
    ostart = excl - read_base[rr]
    last_end = rs.clone()
    last_end[rr[last]] = (p + sh)[last]
    tail = rend - last_end
    outl = body + tail
    cap |= (rl > 0) & ((outl > rcap) | (tail < 0))
    outl = torch.where(rl > 0, torch.minimum(outl.clamp(min=0), rcap), 0)

    # capped sites, visited or not
    sc = sites.s_cap[:n_eff]
    site_read = torch.searchsorted(rs, sp, right=True) - 1
    cap[site_read[sc > 0]] = True
    aux = torch.tensor(
        [n_eff, int((sc == CAP_OVERFLOW).sum()),
         int((sc == CAP_ATTEMPT).sum()), int((sc == CAP_ROUNDS).sum()),
         int(visited.sum()), 0, 0, n_raw], dtype=torch.int32, device=dev)
    rec_cnt = torch.bincount(rr, minlength=R).int()

    # the splice: every position's source in one gather
    pos = torch.arange(CHUNK, device=dev)
    r = torch.searchsorted(rs, pos, right=True) - 1
    rc = r.clamp(min=0)
    o = pos - rs[rc]
    within = (r >= 0) & (o < outl[rc])
    in_tail = o >= body[rc]
    src_tail = last_end[rc] + o - body[rc]
    codes3 = codes & 3
    if M:
        span = 2 * CHUNK + 2
        j = torch.searchsorted(rr * span + ostart, rc * span + o,
                               right=True) - 1
        j = j.clamp(0, M - 1)
        d = o - ostart[j]
        verb = d < vlen[j]
        src_v = pe[j] + d
        e = (d - vlen[j]).clamp(min=0)
        word = emit[j, (e // 16).clamp(max=EW - 1)]
        code_e = ((word >> (2 * (e % 16))) & 3).to(torch.uint8)
        val_body = torch.where(verb, codes3[src_v.clamp(0, CHUNK - 1)],
                               code_e)
    else:
        val_body = torch.zeros(CHUNK, dtype=torch.uint8, device=dev)
    val = torch.where(in_tail, codes3[src_tail.clamp(0, CHUNK - 1)],
                      val_body)
    out = torch.where(within, val, torch.zeros_like(val))
    return Spliced(out, outl.int(), cap, rec_cnt, aux)
