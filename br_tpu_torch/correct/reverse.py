"""K4 ``reverse_slots``: in-slot reversal between the two directions.

Port of br_tpu/correct/engine3.py::make_reverse3_fn (:1920): the first
``rlen[r]`` codes of every slot are reversed in place (plain reversal,
not complemented: the reverse direction of br runs on reversed bytes,
src/lib.rs:110-117), the slack after them is copied, and every code is
masked to its two bits.

``reverse_slots`` launches ``csrc/reverse_slots.cu`` for CUDA tensors and
runs ``reverse_slots_plain`` for CPU tensors, on one chunk or on a group
of NC chunks in one call ((NC, CHUNK) codes, (NC, R) slot tables), as
``make_reverse3_fn(batch=True)`` vmaps it.
"""

from __future__ import annotations

import torch

from br_tpu_torch import kernels
from br_tpu_torch.correct.layout import check_slots


def reverse_slots(codes, rstart, rlen):
    """(CHUNK,) or (NC, CHUNK) uint8 codes with every read reversed
    inside its slot."""
    dev = codes.device
    lead = kernels.group_lead(codes)
    kernels.check(codes, "codes", torch.uint8, dev, lead=lead)
    kernels.check(rstart, "rstart", torch.int32, dev, lead=lead)
    kernels.check(rlen, "rlen", torch.int32, dev, rstart.shape[-1], lead)
    check_slots(rstart)
    if kernels.on_cuda(codes):
        out = torch.empty_like(codes)
        kernels.launch("reverse_slots", kernels.group_nc(lead), codes,
                       rstart, rlen, out, codes.shape[-1], rstart.shape[-1])
        return out
    return kernels.each_chunk(reverse_slots_plain, (), (codes, rstart, rlen))


def reverse_slots_plain(codes, rstart, rlen):
    """The same function in plain PyTorch ops (one gather)."""
    CHUNK = codes.shape[0]
    pos = torch.arange(CHUNK, device=codes.device)
    rs, rl = rstart.long(), rlen.long()
    r = torch.searchsorted(rs, pos, right=True) - 1
    rc = r.clamp(min=0)
    o = pos - rs[rc]
    n = rl[rc]
    src = torch.where((r >= 0) & (o < n), rs[rc] + n - 1 - o, pos)
    return codes[src.clamp(0, CHUNK - 1)] & 3
