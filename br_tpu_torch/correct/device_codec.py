"""Device k-mer math as PyTorch functions (the port of
``br_tpu.correct.device_codec``).

Two kinds of membership set reach the device: a solid bitfield
(``"solid"``: an odd k <= 17, 2^(2k-1) bits, int32 words) and the sorted
table of a ``HashSet`` (``"hash"``: any k <= 31, a ``SortedTable``: the
sorted, sentinel-padded table of canonical k-mers with its bucket index,
probed by a short search inside one bucket).  K-mers and bitfield words
are held in ``int64``: a 2k-bit k-mer (62 bits at k = 31) and a 32-bit
word both fit, and every backend has the shifts, masks and comparisons on
``int64`` that ``uint32`` and ``uint64`` lack.  torch's ``>>`` on
``int64`` is arithmetic, so the group swaps of the reverse complement
mask every right shift (``revcomp64``), and a canonical key with bit 63
set (the k = 31 sentinel's) is past every bucket and reads false
(``make_hash_probe``).  The CUDA kernels (``br_tpu_torch/csrc``) do the
same arithmetic on ``uint32`` registers for a bitfield at k <= 15 and
``uint64`` past it and for every sorted table; these functions are their
plain versions' building blocks and the tensor form of the host codec
(``br_tpu_torch.codec``).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

_M32 = 0xFFFFFFFF


def mask(k: int) -> int:
    return (1 << (2 * k)) - 1


def comp_mask(k: int) -> int:
    return int("10" * k, 2)


#: the largest k of a solid bitfield on the device: a 2^(2k-1)-bit table
#: of 1 GiB at k = 17.
MAX_K_SOLID = 17
#: the largest k of the device path: a k-mer in a 64-bit register, probed
#: in the sorted table of a ``HashSet``.
MAX_K = 31
#: the largest k whose k-mers fit 32 bits (the kernels' 32-bit
#: instantiations, for a bitfield; past it the 64-bit ones).
MAX_K32 = 15
#: the set kinds: a solid bitfield (int32 words) and the sorted table of
#: a HashSet (a SortedTable).
KINDS = ("solid", "hash")


def check_k(k: int, kind: str = "solid") -> None:
    """The port's device path: an odd k <= 17 for a bitfield, any k <= 31
    for a sorted table."""
    if kind == "hash":
        if not 1 <= k <= MAX_K:
            raise ValueError(f"a sorted k-mer table needs 1 <= k <= "
                             f"{MAX_K}, got k={k}")
        return
    if kind != "solid":
        raise ValueError(f"unknown set kind {kind!r}")
    if not (1 <= k <= MAX_K_SOLID and k % 2 == 1):
        raise ValueError(
            f"a solid bitfield on the device needs an odd k <= "
            f"{MAX_K_SOLID}, got k={k} (larger k takes a HashSet)")


def kmer_dtype(k: int, kind: str = "solid") -> torch.dtype:
    """The dtype of K1's k-mers: int32 for a bitfield up to k = 15, int64
    past it and for every sorted table."""
    return torch.int32 if kind == "solid" and k <= MAX_K32 else torch.int64


@dataclass(frozen=True)
class SortedTable:
    """The sorted table of a ``HashSet`` on a device, with its bucket
    index (``sorted_table`` builds it): what the ``_h`` kernels and K9
    take, and their plain versions.

    ``table``: (n,) int64, n a power of two, the canonical k-mers
    ascending (the uint64 bits), then sentinels above every k-mer
    (``HashSet.device_table``).  ``starts``: (2^b + 1,) int32;
    ``starts[i]`` is the first position whose entry's top b bits (of 2k)
    are >= i, counting real entries only, so bucket i is ``table[starts[i]
    : starts[i+1]]``.  ``shift``: 2k - b, an entry's bucket is ``entry >>
    shift``.  ``bucket_levels``: the bit length of the largest bucket, the
    steps of the search inside one."""

    table: torch.Tensor
    starts: torch.Tensor
    shift: int
    bucket_levels: int

    @property
    def buckets(self) -> int:
        """2^b."""
        return self.starts.shape[0] - 1


def table_kind(table) -> str:
    """The set kind of a device table: ``"solid"`` for int32 bitfield
    words, ``"hash"`` for a ``SortedTable``.  A bare int64 table, whose
    index is missing, is refused."""
    if isinstance(table, SortedTable):
        return "hash"
    if isinstance(table, torch.Tensor) and table.dtype == torch.int32:
        return "solid"
    if isinstance(table, torch.Tensor) and table.dtype == torch.int64:
        raise TypeError("an int64 sorted table without its bucket index: "
                        "build it with device_codec.sorted_table(table, k) "
                        "(HashSet.device_table_tensor does)")
    raise TypeError(f"table is {type(table).__name__} "
                    f"{getattr(table, 'dtype', '')}: int32 bitfield words "
                    "or a SortedTable")


def table_levels(table: torch.Tensor) -> int:
    """The binary search's steps over a sorted table of n entries (the
    whole-table search of br_tpu's make_hash_probe)."""
    return max(0, (table.shape[0] - 1).bit_length())


#: the largest b of a bucket index: 2^30 + 1 offsets, 4 GiB
MAX_INDEX_BITS = 30


def index_bits(table: torch.Tensor, k: int) -> int:
    """The default b of a table's bucket index: levels - 1, two entries
    a bucket on average for a full table, the index a quarter of the
    table's bytes (at most 2k, the k-mer's bits)."""
    return max(0, min(table_levels(table) - 1, 2 * k, MAX_INDEX_BITS))


def sorted_table(table: torch.Tensor, k: int,
                 bits: int | None = None) -> SortedTable:
    """The bucket index of a padded sorted table (int64, on its device),
    built there: ``bincount`` of each real entry's top ``bits`` bits
    (default ``index_bits``), then ``cumsum``; the sentinels are left
    out."""
    check_k(k, "hash")
    if table.dtype != torch.int64 or table.dim() != 1:
        raise TypeError("a sorted table is a 1-D int64 tensor")
    b = index_bits(table, k) if bits is None else bits
    if not 0 <= b <= min(2 * k, MAX_INDEX_BITS):
        raise ValueError(f"index bits {b} outside [0, "
                         f"{min(2 * k, MAX_INDEX_BITS)}] at k={k}")
    shift = 2 * k - b
    real = table[(table >= 0) & (table <= mask(k))]
    counts = torch.bincount(real >> shift, minlength=1 << b)
    starts = torch.zeros((1 << b) + 1, dtype=torch.int32,
                         device=table.device)
    starts[1:] = torch.cumsum(counts, 0)
    return SortedTable(table.contiguous(), starts, shift,
                       int(counts.max()).bit_length())


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
        w = gather(words, idx >> 5).to(torch.int64) & _M32
        return ((w >> (idx & 31)) & 1) == 1

    return probe


def gather(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``table[idx]`` for an index tensor of any shape, by
    ``index_select`` (advanced indexing is many times slower on the CPU
    with several threads)."""
    if idx.dim() == 1:
        return table.index_select(0, idx)
    return table.index_select(0, idx.reshape(-1)).reshape(idx.shape)


def make_hash_probe(table: SortedTable, k: int):
    """Membership closure over a ``SortedTable``: the plain version of K9
    and of ``br_probe_sorted`` in the ``_h`` kernels (csrc/common.cuh),
    stepping as they do; it equals br_tpu's ``make_hash_probe``, a binary
    search of the whole table.

    ``probe(kmer) -> bool``: canonicalise; a key past 2k bits (bucket
    2^b or more, bit 63 included) reads false without indexing
    ``starts``; else its bucket ``[lo, hi)`` is read from the index and
    searched in ``bucket_levels`` fixed steps from ``pos = lo - 1``:
    ``cand = pos + 2^level`` moves ``pos`` where ``cand < hi`` and
    ``table[cand] <= cano``, and the key is found where a taken entry
    equals it.  Inside a bucket every entry is a real k-mer, so the
    compares need no unsigned form."""
    if table_kind(table) != "hash":
        raise TypeError("make_hash_probe takes a SortedTable")
    entries, starts = table.table, table.starts
    n, shift, levels = entries.shape[0], table.shift, table.bucket_levels

    def probe(kmer: torch.Tensor) -> torch.Tensor:
        cano = canonical_any(kmer.long(), k)
        inb = (cano >= 0) & (cano <= mask(k))
        bucket = torch.where(inb, cano >> shift, 0)
        lo = gather(starts, bucket).long()
        hi = torch.where(inb, gather(starts, bucket + 1).long(), lo)
        pos = lo - 1
        found = torch.zeros(cano.shape, dtype=torch.bool,
                            device=cano.device)
        for level in reversed(range(levels)):
            cand = pos + (1 << level)
            x = gather(entries, cand.clamp(max=n - 1))
            take = (cand < hi) & (x <= cano)
            pos = torch.where(take, cand, pos)
            found |= take & (x == cano)
        return found

    return probe


def make_probe(table, k: int):
    """The membership closure of a device table: the bitfield probe for
    int32 words, the bucketed search for a ``SortedTable``."""
    if table_kind(table) == "hash":
        return make_hash_probe(table, k)
    return make_solid_probe_any(table, k)


def rolling_kmers(codes: torch.Tensor, k: int) -> torch.Tensor:
    """End-indexed rolling k-mers, int64 (k <= 31): out[j] covers
    codes[j-k+1 : j+1] (positions below k-1 wrap around the buffer, as in
    the JAX package)."""
    c = codes.to(torch.int64)
    out = torch.zeros_like(c)
    for t in range(k):
        out = out | (torch.roll(c, t, dims=-1) << (2 * t))
    return out



def _check_codes(t, name: str) -> None:
    if t.dtype != torch.uint8:
        raise TypeError(f"{name} has dtype {t.dtype}, expected uint8")


def unpack_codes(packed: torch.Tensor, L: int) -> torch.Tensor:
    """(..., L//4) uint8 with 4 LSB-first 2-bit codes per byte -> (..., L)
    (B7, ``make_unpack3_fn``): K11a ``unpack_codes`` for a CUDA tensor,
    ``unpack_codes_plain`` for a CPU one."""
    from br_tpu_torch import kernels

    _check_codes(packed, "packed")
    if packed.dim() < 1 or 4 * packed.shape[-1] != L:
        raise ValueError(f"packed codes of shape {tuple(packed.shape)} do "
                         f"not hold {L} codes a row")
    if not kernels.on_cuda(packed):
        return unpack_codes_plain(packed, L)
    packed = packed.contiguous()
    codes = torch.empty(packed.shape[:-1] + (L,), dtype=torch.uint8,
                        device=packed.device)
    kernels.launch("unpack_codes", packed, packed.numel(), codes)
    return codes


def pack_codes(codes: torch.Tensor) -> torch.Tensor:
    """Inverse of unpack_codes; strips anything above the 2-bit code (B7,
    ``make_pack3_fn``): K11b ``pack_codes`` for a CUDA tensor,
    ``pack_codes_plain`` for a CPU one."""
    from br_tpu_torch import kernels

    _check_codes(codes, "codes")
    if codes.dim() < 1 or codes.shape[-1] % 4:
        raise ValueError(f"codes of shape {tuple(codes.shape)}: the last "
                         "axis must be a multiple of 4")
    if not kernels.on_cuda(codes):
        return pack_codes_plain(codes)
    codes = codes.contiguous()
    packed = torch.empty(codes.shape[:-1] + (codes.shape[-1] // 4,),
                         dtype=torch.uint8, device=codes.device)
    kernels.launch("pack_codes", codes, packed.numel(), packed)
    return packed


def unpack_codes_plain(packed: torch.Tensor, L: int) -> torch.Tensor:
    """The plain version of K11a in PyTorch ops."""
    sh = torch.arange(4, dtype=torch.uint8, device=packed.device) * 2
    c = (packed.unsqueeze(-1) >> sh) & 3
    return c.reshape(packed.shape[:-1] + (L,))


def pack_codes_plain(codes: torch.Tensor) -> torch.Tensor:
    """The plain version of K11b in PyTorch ops."""
    L = codes.shape[-1]
    c = (codes & 3).reshape(codes.shape[:-1] + (L // 4, 4))
    return (c[..., 0] | (c[..., 1] << 2) | (c[..., 2] << 4)
            | (c[..., 3] << 6))
