"""K1 ``dense_probe``: the dense stage of a correction pass.

Port of ``scripts/pallas_probe_bench.py::_probe_kernel`` (the JAX
package's one Pallas kernel) together with the XLA dense stage it was
written for (br_tpu/correct/engine3.py:1387-1448).  Per position: the
read slot, the end-indexed k-mer (zero where the position is fewer than
k-1 bases into its slot; the JAX forms wrap or clip there, and every pass
masks those positions), the solid bit, the validity mask V, the
transition mask T; then the site list (position of every transition, in
order, for the first NS of them) and the reads whose sites overflow NS.

The table is a solid bitfield (int32 words) or the sorted table of a
``HashSet`` with its bucket index (a ``device_codec.SortedTable``,
``device_codec.make_probe``).  K-mers are int32 for a
bitfield at k <= 15 and int64 past it (the probe index ``cano >> 1`` then
reaches 2^33) and for a sorted table (k <= 31); the CUDA tensors' launch
takes the kernel's 64-bit or sorted-table instantiation there
(``kernels.table_kernel``).

``dense_probe`` launches ``csrc/dense_probe.cu`` for CUDA tensors and
runs ``dense_probe_plain`` for CPU tensors.  It takes one chunk, or a
group of NC chunks as one launch: (NC, CHUNK) codes and (NC, R) slot
tables, every output with the same leading axis (``Dense``'s shapes
after it).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from br_tpu_torch import kernels
from br_tpu_torch.correct import device_codec as dc
from br_tpu_torch.correct.layout import BIG, check_slots

#: positions per K1 tile (K1_TILE in dense_probe.cu: 256 threads of 16
#: consecutive positions each).
TILE = 4096


class Dense(NamedTuple):
    kmers: torch.Tensor     # (CHUNK,) k-mer ending at each position
    #                         (int32, or int64: dc.kmer_dtype)
    vraw: torch.Tensor      # (CHUNK,) bool solid bit of that k-mer
    V: torch.Tensor         # (CHUNK,) bool vraw inside the read, pin >= k-1
    T: torch.Tensor         # (CHUNK,) bool valid -> invalid transition
    s_pos: torch.Tensor     # (NS,) int32 position of site q, BIG past them
    n_sites: torch.Tensor   # (1,) int32 transitions in the chunk
    cap_read: torch.Tensor  # (R,) bool the read has a site of rank >= NS


def _check(table, codes, rstart, rlen, k: int, NS: int) -> tuple:
    """The arguments' checks, once a call (a group's once); returns the
    leading axes (``kernels.group_lead``)."""
    dc.check_k(k, dc.table_kind(table))
    dev = codes.device
    lead = kernels.group_lead(codes)
    kernels.check(codes, "codes", torch.uint8, dev, lead=lead)
    kernels.check(rstart, "rstart", torch.int32, dev, lead=lead)
    kernels.check(rlen, "rlen", torch.int32, dev, rstart.shape[-1], lead)
    kernels.check_table(table, k, dev)
    check_slots(rstart)
    if not 0 < codes.shape[-1] < BIG or NS < 1:
        raise ValueError("bad chunk or site capacity")
    return lead


def dense_probe(table, codes, rstart, rlen, k: int, NS: int) -> Dense:
    """Dense stage of one pass over a chunk or a group of chunks (see the
    module docstring)."""
    lead = _check(table, codes, rstart, rlen, k, NS)
    if kernels.on_cuda(codes):
        return _dense_probe_cuda(table, codes, rstart, rlen, k, NS, lead)
    return kernels.each_chunk(dense_probe_plain, (table,),
                              (codes, rstart, rlen), (k, NS))


def _dense_probe_cuda(table, codes, rstart, rlen, k: int, NS: int,
                      lead: tuple) -> Dense:
    CHUNK, R, dev = codes.shape[-1], rstart.shape[-1], codes.device
    NC = kernels.group_nc(lead)
    kmers = torch.empty(lead + (CHUNK,),
                        dtype=dc.kmer_dtype(k, dc.table_kind(table)),
                        device=dev)
    vraw = torch.empty(lead + (CHUNK,), dtype=torch.bool, device=dev)
    V = torch.empty(lead + (CHUNK,), dtype=torch.bool, device=dev)
    T = torch.empty(lead + (CHUNK,), dtype=torch.bool, device=dev)
    s_pos = torch.empty(lead + (NS,), dtype=torch.int32,
                        device=dev)  # BIG: kernel
    n_sites = torch.empty(lead + (1,), dtype=torch.int32, device=dev)
    ntiles = (CHUNK + TILE - 1) // TILE
    # one zero fill: the look-back states (ntiles a chunk), one ticket a
    # chunk, and cap_read (bytes, which no tile writes for a read without
    # a site of rank >= NS)
    states = NC * (ntiles + 1)
    scratch = torch.zeros(states + (NC * R + 7) // 8, dtype=torch.int64,
                          device=dev)
    cap_read = (scratch[states:].view(torch.uint8)[:NC * R]
                .view(torch.bool).view(lead + (R,)))
    name, tab, extra = kernels.table_kernel("dense_probe", k, table)
    kernels.launch(
        name, NC, codes, tab, rstart, rlen, CHUNK, R, k, NS, kmers, vraw, V,
        T, s_pos, cap_read, n_sites, scratch, scratch[NC * ntiles:], *extra)
    return Dense(kmers, vraw, V, T, s_pos, n_sites, cap_read)


def dense_probe_plain(table, codes, rstart, rlen, k: int, NS: int) -> Dense:
    """The same function in plain PyTorch ops (int64 k-mer math)."""
    CHUNK, R, dev = codes.shape[0], rstart.shape[0], codes.device
    pos = torch.arange(CHUNK, device=dev)
    rs, rl = rstart.long(), rlen.long()
    rid = torch.searchsorted(rs, pos, right=True) - 1
    has = rid >= 0
    ridc = rid.clamp(min=0)
    pin = pos - torch.where(has, rs[ridc], 0)
    length = torch.where(has, rl[ridc], 0)

    c = (codes & 3).long()
    km = torch.zeros(CHUNK, dtype=torch.int64, device=dev)
    for t in range(k):
        km[t:] |= c[: CHUNK - t] << (2 * t)
    full = pin >= k - 1
    km = torch.where(full, km, 0)
    vraw = full & dc.make_probe(table, k)(km)
    inread = pin < length
    V = vraw & inread
    vprev = torch.cat([vraw.new_zeros(1), vraw[:-1]])
    T = vprev & ~vraw & (pin >= k) & inread

    q = torch.cumsum(T.long(), 0) - 1
    s_pos = torch.full((NS,), BIG, dtype=torch.int32, device=dev)
    listed = T & (q < NS)
    s_pos[q[listed]] = pos[listed].int()
    cap_read = torch.zeros(R, dtype=torch.bool, device=dev)
    cap_read[rid[T & (q >= NS)]] = True
    n_sites = (q[-1:] + 1).int()
    return Dense(km.to(dc.kmer_dtype(k, dc.table_kind(table))), vraw, V, T,
                 s_pos, n_sites, cap_read)
