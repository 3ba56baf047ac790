"""K9 ``hash_probe``: membership of k-mers in the sorted table of a
``HashSet`` (the port of ``br_tpu.correct.device_codec.make_hash_probe``
and ``make_hash_probe_any``, ROADMAP B9).

N int64 forward k-mers in, N memberships out: canonicalise, read the
k-mer's bucket from the table's index, then a branchless search of
``bucket_levels`` steps inside it (``device_codec.SortedTable``, as
``HashSet.device_table_tensor`` builds it).  The pass kernels probe the
same way inside their chains (``br_probe_sorted`` in
``csrc/common.cuh``); this entry point is the probe alone, which the card
checks hold against its plain version and ``torch.searchsorted``.

``hash_probe`` launches ``csrc/hash_probe.cu`` for CUDA tensors and runs
``device_codec.make_hash_probe`` for CPU tensors.
"""

from __future__ import annotations

import torch

from br_tpu_torch import kernels
from br_tpu_torch.correct import device_codec as dc


def hash_probe(table, kmers, k: int) -> torch.Tensor:
    """(N,) bool: whether each k-mer's canonical form is in ``table`` (a
    ``SortedTable``)."""
    dc.check_k(k, "hash")
    dev = kmers.device
    if dc.table_kind(table) != "hash":
        raise TypeError("hash_probe takes a SortedTable")
    kernels.check_table(table, k, dev)
    kernels.check(kmers, "kmers", torch.int64, dev)
    if not kernels.on_cuda(kmers):
        return dc.make_hash_probe(table, k)(kmers)
    out = torch.empty(kmers.shape[0], dtype=torch.bool, device=dev)
    if kmers.shape[0]:
        kernels.launch("hash_probe", table.table,
                       *kernels.sorted_args(table), kmers, kmers.shape[0],
                       k, out)
    return out
