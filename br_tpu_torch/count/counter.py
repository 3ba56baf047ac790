"""Canonical k-mer counter (pcon ``Counter`` equivalent).

Dense count array over the canonical half-space: ``counts[canonical >> 1]``,
``2**(2k-1)`` entries, saturating at the count-type maximum (u8 by default,
matching the reference's default ``count_u8`` feature, Cargo.toml:54).

Host path: numpy unbuffered scatter-add in a wide dtype, then saturating
downcast.  This is the port's own copy of the JAX package's host counter;
the CLI's ``fasta -a`` builds the solid set on the device instead
(``br_tpu_torch.set.device_build``, ROADMAP B8), bit for bit this
counter's ``to_solid``.

Count-file format [inferred — no pcon source or asset available to verify]:
``gzip(k: u8 || counts bytes)``, mirroring the verified solid format.
"""

from __future__ import annotations

import gzip
import zlib
from typing import Iterable

import numpy as np

from br_tpu_torch import codec
from br_tpu_torch.set.solid import SolidSet


class Counter:
    """Saturating canonical k-mer counts over the 2^(2k-1) half-space."""

    def __init__(self, k: int, counts: np.ndarray | None = None,
                 count_dtype=np.uint8):
        if k % 2 == 0:
            raise ValueError("k must be odd")
        self._k = k
        self.count_dtype = np.dtype(count_dtype)
        n = 1 << (2 * k - 1)
        if counts is None:
            self.counts = np.zeros(n, dtype=self.count_dtype)
        else:
            if counts.shape[0] != n:
                raise ValueError("count array size mismatch")
            self.counts = counts.astype(self.count_dtype, copy=False)

    @property
    def k(self) -> int:
        return self._k

    def count_sequence(self, seq: bytes) -> None:
        if len(seq) < self._k:
            return
        arr = np.frombuffer(seq, dtype=np.uint8)
        kmers = codec.rolling_kmers_np(codec.encode_ascii_np(arr), self._k)
        self.add_kmers(kmers)

    def add_kmers(self, kmers: np.ndarray) -> None:
        """Scatter-add forward k-mers (canonicalized) with saturation."""
        if kmers.size == 0:
            return
        idx = (codec.canonical_np(kmers, self._k) >> np.uint64(1)).astype(np.int64)
        # Unbuffered add in a wide accumulator for this batch, then saturate.
        uniq, batch_counts = np.unique(idx, return_counts=True)
        maxv = np.iinfo(self.count_dtype).max
        cur = self.counts[uniq].astype(np.int64)
        self.counts[uniq] = np.minimum(cur + batch_counts, maxv).astype(self.count_dtype)

    def count_sequences(self, seqs: Iterable[bytes]) -> "Counter":
        for seq in seqs:
            self.count_sequence(seq)
        return self

    def raw(self) -> np.ndarray:
        return self.counts

    def to_solid(self, abundance: int) -> SolidSet:
        """Threshold: solid iff count > abundance (verified rule)."""
        return SolidSet.from_count(self._k, self.counts, abundance)

    # -- serialization ([inferred] format: gzip(k || counts)) ----------------

    @classmethod
    def from_stream(cls, stream) -> "Counter":
        """Load a count artifact written by :meth:`to_stream`.

        The format is [inferred] and NOT verified against real pcon
        output (no pcon source/asset in this environment) — so validate
        structurally and fail loudly on anything that doesn't match
        ``gzip(k: u8 || 2^(2k-1) count bytes)`` rather than silently
        mis-loading a foreign file (VERDICT r3 item 9)."""
        from br_tpu_torch.errors import CountFileFormatError

        data = stream.read()
        if data[:2] == b"\x1f\x8b":
            try:
                data = gzip.decompress(data)
            except (OSError, EOFError, zlib.error) as e:
                raise CountFileFormatError(
                    f"count file: corrupt gzip stream: {e}") from e
        if not data:
            raise CountFileFormatError("count file: empty payload")
        k = data[0]
        if k % 2 == 0 or not 1 <= k <= 31:
            raise CountFileFormatError(
                f"count file: header k={k} is not an odd k in 1..=31 — "
                "not a br_tpu count artifact (note: the real pcon count "
                "format is unverified here and NOT supported)")
        want = 1 << (2 * k - 1)
        if len(data) - 1 != want:
            raise CountFileFormatError(
                f"count file: payload is {len(data) - 1} bytes but k={k} "
                f"implies 2^(2k-1) = {want} canonical counts — "
                "not a br_tpu count artifact (note: the real pcon count "
                "format is unverified here and NOT supported)")
        counts = np.frombuffer(data[1:], dtype=np.uint8).copy()
        return cls(k, counts)

    @classmethod
    def load(cls, path: str) -> "Counter":
        with open(path, "rb") as fh:
            return cls.from_stream(fh)

    def to_stream(self, stream, compresslevel: int = 6) -> None:
        payload = bytes([self._k]) + self.counts.astype(np.uint8).tobytes()
        stream.write(gzip.compress(payload, compresslevel=compresslevel))

    def save(self, path: str) -> None:
        with open(path, "wb") as fh:
            self.to_stream(fh)


def count_file(path: str, k: int) -> Counter:
    """Count every canonical k-mer of a FASTA/FASTQ file (compression
    auto-detected)."""
    from br_tpu_torch.io.fasta import read_records

    counter = Counter(k)
    for _, seq, _ in read_records(path):
        counter.count_sequence(seq)
    return counter
