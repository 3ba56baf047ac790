"""2-bit nucleotide codec and canonical k-mers, scalar and vectorized.

The reference's own copy of the functions of ``br_tpu_torch.codec`` that
it needs (natir/br's encoding through its ``cocktail`` crate):

* ``nuc2bit(b) = (b >> 1) & 0b11``: A=0, C=1, T=2, G=3;
* the complement of a code is ``code ^ 0b10``;
* the canonical k-mer (odd k) is whichever of {kmer, revcomp(kmer)} has
  an even popcount.
"""

from __future__ import annotations

import numpy as np

_BIT2NUC = b"ACTG"


def mask(k: int) -> int:
    """All-ones mask over 2k bits (src/correct/mod.rs:40-42)."""
    return (1 << (2 * k)) - 1


def comp_mask(k: int) -> int:
    """XOR mask complementing every base of a packed k-mer."""
    return int("10" * k, 2)


def nuc2bit(nuc: int) -> int:
    return (nuc >> 1) & 0b11


def bit2nuc(bit: int) -> int:
    return _BIT2NUC[bit & 0b11]


def seq2bit(seq: bytes) -> int:
    """Pack an ASCII sequence into a 2-bit k-mer, first base highest."""
    kmer = 0
    for b in seq:
        kmer = (kmer << 2) | nuc2bit(b)
    return kmer


def kmer2seq(kmer: int, k: int) -> bytes:
    """Unpack a k-mer into ASCII (cocktail ``kmer2seq``; greedy.rs:139)."""
    out = bytearray(k)
    for i in range(k - 1, -1, -1):
        out[i] = _BIT2NUC[kmer & 0b11]
        kmer >>= 2
    return bytes(out)


def revcomp_np(kmers: np.ndarray, k: int) -> np.ndarray:
    """Reverse complement of packed uint64 k-mers: complement, reverse
    the 2-bit groups of the 64-bit word, right-align to 2k bits."""
    x = kmers ^ np.uint64(comp_mask(k))
    for m, s in ((0x3333333333333333, 2), (0x0F0F0F0F0F0F0F0F, 4),
                 (0x00FF00FF00FF00FF, 8), (0x0000FFFF0000FFFF, 16)):
        m, s = np.uint64(m), np.uint64(s)
        x = ((x & m) << s) | ((x >> s) & m)
    x = (x << np.uint64(32)) | (x >> np.uint64(32))
    return x >> np.uint64(64 - 2 * k)
