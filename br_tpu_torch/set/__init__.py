"""Membership layer: the dense solid-k-mer bitfield and the sparse
large-k set (the port's copies of ``br_tpu.set.solid`` and
``br_tpu.set.hash``, plus their device tables).

The reference contract is ``KmerSet { get(kmer: u64) -> bool, k() -> u8 }``
(src/set.rs:17-21).  ``get`` accepts *forward* (non-canonical) k-mers;
canonicalization happens inside (src/set/pcon.rs:219-230,
src/set/hash.rs:207-219).
"""

from __future__ import annotations

from typing import Protocol


class KmerSet(Protocol):
    """Uniform membership interface (reference src/set.rs:17-21)."""

    def get(self, kmer: int) -> bool:  # pragma: no cover - protocol
        ...

    @property
    def k(self) -> int:  # pragma: no cover - protocol
        ...


from br_tpu_torch.set.hash import HashSet  # noqa: E402,F401
from br_tpu_torch.set.solid import SolidSet, solid_words_from_numpy  # noqa: E402,F401
