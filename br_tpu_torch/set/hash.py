"""Sparse membership set for large k (the port's copy of
``br_tpu.set.hash``, the FxHashSet backend of the reference,
src/set/hash.rs).

A set of canonical uint64 k-mers for k up to 31, where the dense bitfield
(2^(2k-1) bits) is infeasible.  Only set semantics matter (no dependence
on iteration order).  The k-mers live in one sorted, duplicate-free numpy
array: ``from_sequences`` adds each sequence's canonical k-mers in bulk
(``np.unique``), so a 2 Mb genome at k = 21 (about 2 M k-mers) takes
seconds, not the minutes of a Python set.  ``device_table`` pads the
sorted table to a power of two with an out-of-space sentinel, and
``device_table_tensor`` puts those bits on a device as ``int64`` and
builds their bucket index there (a ``device_codec.SortedTable``); the
probe there reads a k-mer's bucket from the index and searches it
(``device_codec.make_hash_probe``, kernel K9 and the ``_h``
instantiations of the k-mer kernels).
"""

from __future__ import annotations

from typing import Iterable

import numpy as np

from br_tpu_torch import codec
from br_tpu_torch.errors import CsvMissingFirstColumn


class HashSet:
    """Sparse canonical k-mer membership set for k up to 31."""

    def __init__(self, k: int, kmers=None):
        if not (1 <= k <= codec.MAX_K):
            raise ValueError(f"k must be in [1, {codec.MAX_K}], got {k}")
        self._k = k
        self._table = np.zeros(0, dtype=np.uint64)
        #: canonical k-mers added since the table was last sorted
        self._pending: list = []
        #: a Python set for ``get``, built at first use: the forward
        #: k-mers whose canonical k-mer is in the table
        self._lookup = None
        if kmers is not None:
            self._pending.append(np.fromiter(kmers, dtype=np.uint64))

    @property
    def k(self) -> int:
        return self._k

    def _sorted(self) -> np.ndarray:
        if self._pending:
            self._table = np.unique(np.concatenate([self._table,
                                                    *self._pending]))
            self._pending = []
            self._lookup = None
        return self._table

    def get(self, kmer: int) -> bool:
        """Membership of a forward k-mer (canonicalizes,
        src/set/hash.rs:175-182)."""
        if self._lookup is None or self._pending:
            self._lookup = self._forward_kmers()
        if 0 <= kmer <= codec.mask(self._k):
            return kmer in self._lookup
        cano = codec.canonical(kmer, self._k)   # bits past 2k: search
        table = self._sorted()
        pos = (int(np.searchsorted(table, np.uint64(cano)))
               if 0 <= cano < 1 << 64 else table.size)
        return pos < table.size and int(table[pos]) == cano

    def _forward_kmers(self) -> set:
        """Every k-mer z with canonical(z) in the table, as a Python set:
        canonical(z) is z or its reverse complement, so z is an entry x
        of even popcount or revcomp(x) of odd popcount.  ``get`` is then
        one set lookup, with no canonicalisation on the host's hot path
        (the oracle's)."""
        table = self._sorted()
        rc = codec.revcomp_np(table, self._k)
        one = np.uint64(1)
        return set(np.concatenate([
            table[(codec.popcount_np(table) & one) == 0],
            rc[(codec.popcount_np(rc) & one) == 1]]).tolist())

    def set(self, kmer: int, value: bool = True) -> None:
        cano = codec.canonical(kmer, self._k)
        if value:
            self._pending.append(np.array([cano], dtype=np.uint64))
            return
        table = self._sorted()
        pos = int(np.searchsorted(table, np.uint64(cano)))
        if pos < table.size and int(table[pos]) == cano:
            self._table = np.delete(table, pos)
            self._lookup = None

    def set_many(self, kmers: np.ndarray) -> None:
        if kmers.size:
            self._pending.append(codec.canonical_np(
                kmers.astype(np.uint64), self._k))

    def get_many(self, kmers: np.ndarray) -> np.ndarray:
        cano = codec.canonical_np(kmers, self._k)
        table = self.sorted_table()
        if table.size == 0:
            return np.zeros(cano.shape, dtype=bool)
        pos = np.minimum(np.searchsorted(table, cano), table.size - 1)
        return table[pos] == cano

    def __len__(self) -> int:
        return int(self._sorted().size)

    @classmethod
    def from_sequences(cls, seqs: Iterable[bytes], k: int) -> "HashSet":
        """All k-mers of all sequences (reference from_fasta,
        src/set/hash.rs:40-104)."""
        self = cls(k)
        for seq in seqs:
            if len(seq) >= k:
                arr = np.frombuffer(seq, dtype=np.uint8)
                self.set_many(np.unique(codec.rolling_kmers_np(
                    codec.encode_ascii_np(arr), k)))
        return self

    @classmethod
    def from_csv(cls, stream, k: int) -> "HashSet":
        """First CSV column is a k-mer string; header row skipped
        (reference src/set/hash.rs:20-38).  The k-mers are added in one
        batch at the end."""
        self = cls(k)
        first = True
        kmers = []
        for line in stream:
            if isinstance(line, bytes):
                line = line.decode()
            line = line.strip()
            if not line:
                continue
            if first:
                first = False
                continue
            field = line.split(",")[0]
            if not field:
                raise CsvMissingFirstColumn()
            kmers.append(codec.seq2bit(field.encode()))
        self.set_many(np.array(kmers, dtype=np.uint64))
        return self

    def sorted_table(self) -> np.ndarray:
        """Sorted uint64 canonical k-mers for binary-search probes."""
        return self._sorted().copy()

    def device_table(self) -> np.ndarray:
        """Sorted table padded to a power of two with an out-of-space
        sentinel (1 << min(2k+1, 63), above every canonical k-mer)."""
        table = self._sorted()
        sentinel = np.uint64(1) << np.uint64(min(2 * self._k + 1, 63))
        n = 1 << max(0, (int(table.size) - 1).bit_length())
        if n < max(1, table.size):
            n = table.size
        pad = np.full(max(1, n) - table.size, sentinel, dtype=np.uint64)
        return np.concatenate([table, pad])

    def device_table_tensor(self, device):
        """``device_table`` on ``device`` with its bucket index, built
        there once: a ``device_codec.SortedTable`` whose ``table`` is an
        ``int64`` tensor of the same 64 bits an entry (the k = 31
        sentinel reads as negative)."""
        import torch

        from br_tpu_torch.correct import device_codec as dc

        table = torch.from_numpy(self.device_table().view(np.int64))
        return dc.sorted_table(table.to(device), self._k)
