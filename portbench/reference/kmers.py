"""The solid k-mer set of a corpus, counted from the reads with NumPy.

br's ``fasta -k K -a A`` counts every canonical k-mer of every read
(reads shorter than k give none) and keeps those seen more than A times
(strictly greater: pcon's ``Solid::from_count``, src/main.rs:87-115).
Here the count is exact: every k-mer of the corpus, sorted, and the
length of each run.  Nothing of the program is read: its set, its
counters and its output stay its own.
"""

from __future__ import annotations

import numpy as np

from portbench.reference import codec

#: bases of the reads joined into one block of the count
BLOCK_BASES = 1 << 22


def _rolling(codes: np.ndarray, k: int, reverse: bool) -> np.ndarray:
    """Every window of k codes of ``codes`` as uint64, first code in the
    highest bits; with ``reverse`` first code in the lowest bits (applied
    to complemented codes this gives each window's reverse complement).
    Built by doubling: windows of 1, 2, 4, ... codes, then the binary
    digits of k, about log2(k) passes over the array."""
    n = codes.shape[0] - k + 1
    x = codes.astype(np.uint64)
    levels = {1: x}
    w = 1
    while 2 * w <= k:
        m = codes.shape[0] - 2 * w + 1
        lo, hi = (x[:m], x[w : w + m]) if not reverse else (x[w : w + m],
                                                            x[:m])
        x = (lo << np.uint64(2 * w)) | hi
        w *= 2
        levels[w] = x
    out = x[:n].copy()
    got = w
    for part in sorted(levels, reverse=True):
        if got + part <= k:
            nxt = levels[part][got : got + n]
            if reverse:
                out |= nxt << np.uint64(2 * got)
            else:
                out <<= np.uint64(2 * part)
                out |= nxt
            got += part
    return out


def _block_kmers(seqs, k: int) -> np.ndarray:
    """The canonical k-mers of every read of ``seqs`` (each read's k-mers
    in order, reads in order) as uint64."""
    seqs = [s for s in seqs if len(s) >= k]
    if not seqs:
        return np.zeros(0, np.uint64)
    lens = np.fromiter((len(s) for s in seqs), np.int64, len(seqs))
    starts = np.concatenate([[0], np.cumsum(lens)[:-1]])
    codes = (np.frombuffer(b"".join(seqs), np.uint8) >> 1) & 3
    n = codes.shape[0] - k + 1
    # a k-mer starting at j is a read's when j .. j + k - 1 lie in one read
    edge = np.zeros(n + 1, np.int64)
    np.add.at(edge, starts, 1)
    np.add.at(edge, starts + lens - k + 1, -1)
    valid = np.cumsum(edge[:n]) > 0
    # popcount parity of a window: the xor of its codes' parities
    par = np.bitwise_xor.accumulate((codes ^ (codes >> 1)) & 1)
    odd = par[k - 1 :].copy()
    odd[1:] ^= par[: n - 1]
    fwd = _rolling(codes, k, False)
    rc = _rolling(codes ^ np.uint8(2), k, True)
    return np.where(odd == 0, fwd, rc)[valid]


def solid_canonical(seqs, k: int, abundance: int) -> np.ndarray:
    """The sorted canonical k-mers of ``seqs`` seen more than
    ``abundance`` times, read a block of reads at a time."""
    if k % 2 == 0 or not 1 <= k <= 31:
        raise ValueError(f"k must be odd and at most 31, got {k}")
    blocks, block, n = [], [], 0
    for s in seqs:
        block.append(s)
        n += len(s)
        if n >= BLOCK_BASES:
            blocks.append(block)
            block, n = [], 0
    blocks.append(block)
    allk = np.concatenate([_block_kmers(b, k) for b in blocks])
    if allk.size == 0:
        return allk
    allk.sort()
    first = np.flatnonzero(np.concatenate(
        [[True], allk[1:] != allk[:-1]]))
    counts = np.diff(np.append(first, allk.size))
    return allk[first[counts > abundance]]


class ForwardSet:
    """Membership of forward k-mers whose canonical form is solid: a
    Python set of both orientations of every solid canonical k-mer, so
    that ``get`` is one lookup (the oracle's ``valid_kmer``)."""

    def __init__(self, k: int, canonical: np.ndarray):
        self.k = k
        both = np.concatenate([canonical, codec.revcomp_np(canonical, k)])
        self._set = frozenset(both.tolist())

    def get(self, kmer: int) -> bool:
        return kmer in self._set

    def __len__(self) -> int:
        return len(self._set)
