"""Device k-mer math as PyTorch functions (the port of
``br_tpu.correct.device_codec``, odd k <= 17).

K-mers and bitfield words are held in ``int64``: a 2k-bit k-mer (34 bits
at k = 17) and a 32-bit word both fit, and every backend has the shifts,
masks and comparisons on ``int64`` that ``uint32`` and ``uint64`` lack.
torch's ``>>`` on ``int64`` is arithmetic, so the group swaps of the
reverse complement stay inside 34 bits (``revcomp64``): no intermediate
sets bit 63.  The CUDA kernels (``br_tpu_torch/csrc``) do the same
arithmetic on ``uint32`` registers for k <= 15 and ``uint64`` for k = 17;
these functions are their plain versions' building blocks and the tensor
form of the host codec (``br_tpu_torch.codec``).
"""

from __future__ import annotations

import torch

_M32 = 0xFFFFFFFF


def mask(k: int) -> int:
    return (1 << (2 * k)) - 1


def comp_mask(k: int) -> int:
    return int("10" * k, 2)


#: the largest k the device path takes: a k-mer in a 64-bit register and
#: a 2^(2k-1)-bit table of 1 GiB (larger k needs the hash set).
MAX_K = 17
#: the largest k whose k-mers fit 32 bits (the kernels' 32-bit
#: instantiations; k = 17 takes the 64-bit ones).
MAX_K32 = 15


def check_k(k: int) -> None:
    """The port's device path: an odd k <= 17."""
    if not (1 <= k <= MAX_K and k % 2 == 1):
        raise ValueError(
            f"br_tpu_torch's device path needs an odd k <= {MAX_K}, got "
            f"k={k} (larger k is ROADMAP A5)")


def kmer_dtype(k: int) -> torch.dtype:
    """The dtype of K1's k-mers: int32 up to k = 15, int64 at k = 17."""
    return torch.int32 if k <= MAX_K32 else torch.int64


def check_table(table: torch.Tensor, k: int) -> None:
    """The bitfield holds 2^(2k-1) bits, one per canonical k-mer."""
    if table.shape[0] < max(1, (1 << (2 * k - 1)) // 32):
        raise ValueError(f"table has {table.shape[0]} words, too few for "
                         f"k={k}")


def encode_ascii(ascii_arr: torch.Tensor) -> torch.Tensor:
    """uint8 ASCII -> uint8 2-bit codes ((b >> 1) & 3)."""
    return (ascii_arr >> 1) & 3


def add_nuc(kmer: torch.Tensor, code: torch.Tensor, k: int) -> torch.Tensor:
    """Rolling update ``((kmer << 2) & mask) ^ code`` on int64 tensors."""
    return ((kmer << 2) & mask(k)) ^ code.to(torch.int64)


def revcomp32(kmer: torch.Tensor, k: int) -> torch.Tensor:
    """Reverse complement of int64 k-mers (2k <= 32): complement, swap the
    2-bit groups of the 32-bit word, right-align."""
    x = (kmer ^ (comp_mask(k) & _M32)) & _M32
    x = ((x & 0x33333333) << 2) | ((x & 0xCCCCCCCC) >> 2)
    x = ((x & 0x0F0F0F0F) << 4) | ((x & 0xF0F0F0F0) >> 4)
    x = ((x & 0x00FF00FF) << 8) | ((x & 0xFF00FF00) >> 8)
    x = ((x << 16) | (x >> 16)) & _M32
    return x >> (32 - 2 * k)


def parity32(x: torch.Tensor) -> torch.Tensor:
    """Popcount parity of the low 32 bits (0 or 1, int64)."""
    x = x & _M32
    for s in (16, 8, 4, 2, 1):
        x = x ^ (x >> s)
    return x & 1


def revcomp64(kmer: torch.Tensor, k: int) -> torch.Tensor:
    """Reverse complement of int64 k-mers of up to 2k = 62 bits:
    complement, then reverse the k 2-bit groups inside the 64-bit word by
    swaps of 2, 4, 8, 16 and 32 bits whose right shifts are masked first,
    so the sign bit is never shifted in; right-align."""
    x = kmer ^ comp_mask(k)
    for sh, m in ((2, 0x3333333333333333), (4, 0x0F0F0F0F0F0F0F0F),
                  (8, 0x00FF00FF00FF00FF), (16, 0x0000FFFF0000FFFF)):
        x = ((x & m) << sh) | ((x >> sh) & m)
    x = ((x & _M32) << 32) | ((x >> 32) & _M32)
    return (x >> (64 - 2 * k)) & mask(k)


def parity64(x: torch.Tensor) -> torch.Tensor:
    """Popcount parity of a non-negative int64 (0 or 1)."""
    for s in (32, 16, 8, 4, 2, 1):
        x = x ^ (x >> s)
    return x & 1


def canonical_any(kmer: torch.Tensor, k: int) -> torch.Tensor:
    """pcon canonical rule: an even popcount keeps the k-mer, otherwise
    its reverse complement (32-bit math up to k = 15, 64-bit past it)."""
    if k <= MAX_K32:
        return torch.where(parity32(kmer) == 0, kmer, revcomp32(kmer, k))
    return torch.where(parity64(kmer) == 0, kmer, revcomp64(kmer, k))


def make_solid_probe_any(words: torch.Tensor, k: int):
    """Membership closure over the bitfield table (int32 words, see
    ``br_tpu_torch.set.solid.solid_words_from_numpy``).

    ``probe(kmer) -> bool``: canonicalise, drop the parity bit, read word
    ``idx >> 5``, test bit ``idx & 31``."""

    def probe(kmer: torch.Tensor) -> torch.Tensor:
        idx = canonical_any(kmer, k) >> 1
        w = words[idx >> 5].to(torch.int64) & _M32
        return ((w >> (idx & 31)) & 1) == 1

    return probe


def rolling_kmers(codes: torch.Tensor, k: int) -> torch.Tensor:
    """End-indexed rolling k-mers, int64 (k <= 31): out[j] covers
    codes[j-k+1 : j+1] (positions below k-1 wrap around the buffer, as in
    the JAX package)."""
    c = codes.to(torch.int64)
    out = torch.zeros_like(c)
    for t in range(k):
        out = out | (torch.roll(c, t, dims=-1) << (2 * t))
    return out



def unpack_codes(packed: torch.Tensor, L: int) -> torch.Tensor:
    """(..., L//4) uint8 with 4 LSB-first 2-bit codes per byte -> (..., L)."""
    sh = torch.arange(4, dtype=torch.uint8, device=packed.device) * 2
    c = (packed.unsqueeze(-1) >> sh) & 3
    return c.reshape(packed.shape[:-1] + (L,))


def pack_codes(codes: torch.Tensor) -> torch.Tensor:
    """Inverse of unpack_codes; strips anything above the 2-bit code."""
    L = codes.shape[-1]
    c = (codes & 3).reshape(codes.shape[:-1] + (L // 4, 4))
    return (c[..., 0] | (c[..., 1] << 2) | (c[..., 2] << 4)
            | (c[..., 3] << 6))
