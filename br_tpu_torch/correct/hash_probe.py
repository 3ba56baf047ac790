"""K9 ``hash_probe``: membership of k-mers in the sorted table of a
``HashSet`` (the port of ``br_tpu.correct.device_codec.make_hash_probe``
and ``make_hash_probe_any``, ROADMAP B9).

N int64 forward k-mers in, N memberships out: canonicalise, then a
branchless binary search of the sorted, sentinel-padded table
(``HashSet.device_table_tensor``: 2^levels int64 entries holding the
uint64 bits, compared as unsigned).  The pass kernels probe the same way
inside their chains (``br_probe_sorted`` in ``csrc/common.cuh``); this
entry point is the probe alone, which the card checks hold against its
plain version and ``torch.searchsorted``.

``hash_probe`` launches ``csrc/hash_probe.cu`` for CUDA tensors and runs
``device_codec.make_hash_probe`` for CPU tensors.
"""

from __future__ import annotations

import torch

from br_tpu_torch import kernels
from br_tpu_torch.correct import device_codec as dc


def hash_probe(table, kmers, k: int) -> torch.Tensor:
    """(N,) bool: whether each k-mer's canonical form is in ``table``."""
    dc.check_k(k, "hash")
    dev = kmers.device
    kernels.check(table, "table", torch.int64, dev)
    kernels.check(kmers, "kmers", torch.int64, dev)
    dc.check_table(table, k)
    if not kernels.on_cuda(kmers):
        return dc.make_hash_probe(table, k)(kmers)
    out = torch.empty(kmers.shape[0], dtype=torch.bool, device=dev)
    if kmers.shape[0]:
        kernels.launch("hash_probe", table, dc.table_levels(table), kmers,
                       kmers.shape[0], k, out)
    return out
