"""B8: the solid set counted, thresholded and bit-packed on the device
(the port of ``br_tpu.set.device_build``), kernel K8
(``csrc/solid_build.cu``).

The host packs the reads, 2 bits a base, back to back (reads shorter than
k are dropped, the code is ``(b >> 1) & 3``, as ``_pack_reads``,
device_build.py:39-72), and ships only those; the count, the threshold
and the bitfield stay in device memory (1 GiB at k = 17, which never
crosses the bus).  A k-mer is solid where its count over the valid
positions (``pin >= k - 1`` inside its read) saturated at 255 is above
the abundance ``a``: ``min(count, 255) > a``, bit for bit the host
``Counter(k).to_solid(a)`` for every ``a``, 255 and above included (an
empty set; br_tpu's exact-count build differs there, device_build.py:
14-17, and is not copied).

For 0 <= a <= 254 that function reads only ``min(count, a + 1)``, so a
k-mer's counter is ``counter_bits(a)`` = w bits that saturate at a + 1
(1 bit at a = 0, 2 at a = 1 and 2, 4 at 3..14, 8 at 15..254), 32 / w to
an int32 word; a < 0 (every bit set) and a >= 255 (none) count nothing.
On the card the canonical half-space (2^(2k-1) counters: 8 MiB at k = 13
and 2 GiB at k = 17 for a = 2) is swept in partitions whose counters
take at most ``max_count_bytes``; for each, K8a ``count_kmers`` adds every
stored batch's k-mers that fall in it, then K8b ``threshold_pack`` writes
its bitfield words and clears the counters for the next partition (the
last partition's are left as they are).  At w = 1 the counters are the
bitfield: K8a counts into it and K8b is not launched.  Under the default
cap one partition covers k <= 15 for any a and k = 17 for a <= 14 (3 GiB
of device memory at a = 2 with the bitfield); k = 17 at a >= 15 takes
two.  Batches are kept packed on the device (a quarter byte a base), so
a caller can stream records through ``SolidBuilder.add`` without holding
a file.

The sweep takes the batches grouped by shard (``build_words``).  Each
group counts on its batches' device into its own row of the partition's
counters; with more than one row, K10 ``merge_counts``
(``csrc/merge_counts.cu``) takes every counter to min(sum over the rows,
a + 1) on the sweep's device before K8b packs (at w = 1 the merge is the
OR and writes the bitfield).  One group is the one-device build.

``count_kmers``, ``threshold_pack`` and ``merge_counts`` launch their
kernels for CUDA tensors and run their plain versions for CPU tensors.
The plain version of the whole build, ``solid_words_plain``
(``torch.unique`` with counts), is what ``SolidBuilder.finish`` runs for a
builder on the CPU: a dense sweep of 2^33 counters would not fit a test's
memory at k = 17.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from br_tpu_torch import kernels
from br_tpu_torch.correct import device_codec as dc
from br_tpu_torch.set.solid import SolidSet

#: a partition's default cap on the card, in bytes of its counters (one
#: partition of 2^33 2-bit counters at k = 17, a = 2)
DEFAULT_MAX_COUNT_BYTES = 4 << 30
#: counters a partition is a multiple of (4 bitfield words)
GROUP = 128
#: bases of one packed batch of ``build_set``'s stream
BATCH_BASES = 1 << 26


class Packed(NamedTuple):
    """One batch of reads on a device."""

    codes: torch.Tensor   # uint8, 4 codes a byte LSB first, whole words
    starts: torch.Tensor  # int64, the reads' first positions, from 0
    n_bases: int


def pack_reads(seqs, k: int, device) -> Packed:
    """The reads of at least k bases, 2-bit codes back to back, on
    ``device``."""
    seqs = [s for s in seqs if len(s) >= k]
    lens = np.fromiter((len(s) for s in seqs), dtype=np.int64,
                       count=len(seqs))
    n = int(lens.sum())
    codes = np.zeros(-(-n // 16) * 16, dtype=np.uint8)
    if n:
        codes[:n] = (np.frombuffer(b"".join(seqs), dtype=np.uint8) >> 1) & 3
    b4 = codes.reshape(-1, 4)
    packed = b4[:, 0] | (b4[:, 1] << 2) | (b4[:, 2] << 4) | (b4[:, 3] << 6)
    starts = np.concatenate([[0], np.cumsum(lens)[:-1]]).astype(np.int64)
    return Packed(torch.from_numpy(packed).to(device),
                  torch.from_numpy(starts).to(device), n)


def _check_packed(p: Packed, k: int) -> None:
    dc.check_k(k)
    dev = p.codes.device
    kernels.check(p.codes, "codes", torch.uint8, dev)
    kernels.check(p.starts, "starts", torch.int64, dev)
    if p.codes.shape[0] % 4 or p.codes.shape[0] * 4 < p.n_bases:
        raise ValueError("packed codes must be whole 32-bit words covering "
                         "n_bases")


def counter_bits(a: int) -> int:
    """w, the bits of a counter that saturates at ``a + 1``: the narrowest
    of 1, 2, 4 and 8 with 2^w - 1 >= a + 1 (0 <= a <= 254)."""
    if not 0 <= a <= 254:
        raise ValueError(f"abundance {a} needs no counters (0 to 254 do)")
    return next(w for w in (1, 2, 4, 8) if (1 << w) - 1 >= a + 1)


def _int32(x):
    """int64 values of 0 .. 2^32 - 1 as the int32 of the same bits."""
    return ((x ^ 0x80000000) - 0x80000000).int()


def count_kmers(p: Packed, k: int, pbase: int, a: int, counts) -> None:
    """K8a: add to counter ``i`` of ``counts`` (int32 words of 32 / w
    counters of w = ``counter_bits(a)`` bits, LSB first) the occurrences
    of canonical index ``pbase + i`` at the valid positions of ``p``,
    each counter saturating at ``a + 1``."""
    _check_packed(p, k)
    w = counter_bits(a)
    kernels.check(counts, "counts", torch.int32, p.codes.device)
    if kernels.on_cuda(counts):
        if p.starts.shape[0]:
            kernels.launch(kernels.variant("solid_count", k), p.codes,
                           p.codes.shape[0] // 4, p.starts,
                           p.starts.shape[0], p.n_bases, k, pbase,
                           counts.shape[0] * 32 // w, w, a, counts)
        return
    count_kmers_plain(p, k, pbase, a, counts)


def canonical_index(p: Packed, k: int):
    """``cano >> 1`` of the k-mer ending at every valid position of
    ``p`` (int64, in position order)."""
    n = p.n_bases
    c = dc.unpack_codes_plain(p.codes, 4 * p.codes.shape[0])[:n].long()
    km = torch.zeros(n, dtype=torch.int64, device=c.device)
    for t in range(k):
        km[t:] |= c[: n - t] << (2 * t)
    pos = torch.arange(n, device=c.device)
    rid = torch.searchsorted(p.starts, pos, right=True) - 1
    valid = pos - p.starts[rid] >= k - 1
    return dc.canonical_any(km[valid], k) >> 1


def count_kmers_plain(p: Packed, k: int, pbase: int, a: int,
                      counts) -> None:
    """The same function as K8a in plain PyTorch ops: the occurrences by
    ``torch.unique``, each touched counter raised to ``min(counter +
    occurrences, a + 1)``."""
    w = counter_bits(a)
    local = canonical_index(p, k) - pbase
    local = local[(local >= 0) & (local < counts.shape[0] * 32 // w)]
    u, c = torch.unique(local, return_counts=True)
    word, sh = (u * w) >> 5, (u * w) & 31
    uw, inv = torch.unique(word, return_inverse=True)
    old = counts[uw].long() & 0xFFFFFFFF
    cur = (old[inv] >> sh) & ((1 << w) - 1)
    # distinct counters of a word are distinct bits: their steps add
    counts[uw] = _int32(old.index_add_(
        0, inv, ((cur + c).clamp(max=a + 1) - cur) << sh))


def threshold_pack(counts, a: int, words, clear: bool = True) -> None:
    """K8b: ``words`` (int32, one bit a counter, LSB first) = counter >=
    a + 1 (``min(count, 255) > a``) of the w-bit counters ``counts``
    (w = ``counter_bits(a)``, 2 to 8: at a = 0 the 1-bit counters are
    the bitfield); with ``clear``, ``counts`` is zeroed."""
    dev = counts.device
    w = counter_bits(a)
    if w == 1:
        raise ValueError("a = 0 packs nothing: its counters are the "
                         "bitfield")
    kernels.check(counts, "counts", torch.int32, dev)
    if counts.shape[0] % (GROUP * w // 32):
        raise ValueError(f"counts must hold a multiple of {GROUP} counters")
    kernels.check(words, "words", torch.int32, dev, counts.shape[0] // w)
    if kernels.on_cuda(counts):
        if counts.data_ptr() % 16:
            raise ValueError("counts must be 16-byte aligned")
        kernels.launch("solid_pack", counts, words.shape[0], w, a, words,
                       int(clear))
        return
    threshold_pack_plain(counts, a, words, clear)


def counter_fields(counts, w: int):
    """The w-bit counters of int32 words, in order, as uint8."""
    b = counts.view(torch.uint8)
    if w == 8:
        return b
    sh = torch.arange(0, 8, w, dtype=torch.uint8, device=counts.device)
    return ((b[:, None] >> sh) & ((1 << w) - 1)).reshape(-1)


def pack_bits(solid):
    """(32 n,) bool -> (n,) int32 words, LSB first."""
    sh = torch.arange(8, dtype=torch.uint8, device=solid.device)
    b = (solid.reshape(-1, 8).to(torch.uint8) << sh).sum(1,
                                                          dtype=torch.uint8)
    return b.view(torch.int32)


#: counter words the plain pack and merge take at a time (their uint8
#: fields, at most 128 MiB a row)
_PLAIN_WORDS = 1 << 22


def threshold_pack_plain(counts, a: int, words, clear: bool = True) -> None:
    """The same function as K8b in plain PyTorch ops, a slice of counter
    words at a time."""
    w = counter_bits(a)
    for i in range(0, counts.shape[0], _PLAIN_WORDS):
        part = counts[i:i + _PLAIN_WORDS]
        words[i // w:(i + part.shape[0]) // w] = pack_bits(
            counter_fields(part, w) > a)
    if clear:
        counts.zero_()


def half_words(k: int) -> int:
    """Words of the bitfield of k: 2^(2k-1) bits, at least one word."""
    return max(1, (1 << (2 * k - 1)) // 32)


def _tail_mask(words, k: int):
    """Clear the bits past the half-space in a one-word field (k < 3)."""
    half = 1 << (2 * k - 1)
    if half < 32:
        words &= (1 << half) - 1
    return words


def partition_size(k: int, w: int, max_count_bytes: int) -> int:
    """Counters per partition: a power of two whose w-bit counters take
    at most ``max_count_bytes`` (at least ``GROUP``), no more than the
    half-space rounded up to a group."""
    half = 1 << (2 * k - 1)
    cap = max(GROUP, max_count_bytes * 8 // w)
    psize = 1 << (cap.bit_length() - 1)
    return min(psize, max(GROUP, half))


def _check_merge(rows, w: int, cap: int) -> None:
    if w not in (1, 2, 4, 8):
        raise ValueError(f"counter width {w}: 1, 2, 4 or 8 bits")
    if not 1 <= cap <= (1 << w) - 1:
        raise ValueError(f"cap {cap} outside 1 .. {(1 << w) - 1} at "
                         f"w = {w}")
    if rows.dtype != torch.int32:
        raise TypeError(f"rows have dtype {rows.dtype}, expected int32")
    if rows.dim() != 2 or rows.shape[0] < 1 or not rows.is_contiguous():
        raise ValueError("rows must be a contiguous (D, n) tensor, D >= 1")


def merge_counts(rows, w: int, cap: int, out=None):
    """K10: ``out`` (n int32 words, apart from ``rows``; a new tensor
    where it is None) = for each w-bit counter, min(sum over the D rows
    of ``rows`` (D, n), cap); at w = 1 and cap 1, the OR."""
    _check_merge(rows, w, cap)
    d, n = rows.shape
    if out is None:
        out = torch.empty(n, dtype=torch.int32, device=rows.device)
    kernels.check(out, "out", torch.int32, rows.device, n)
    if kernels.on_cuda(rows):
        kernels.launch("merge_counts", rows, d, n, w, cap, out)
        return out
    return merge_counts_plain(rows, w, cap, out)


def merge_counts_plain(rows, w: int, cap: int, out=None):
    """The same function as K10 in plain PyTorch ops, a slice of words at
    a time: the rows' fields as uint8, summed in int32, clamped at cap,
    packed back."""
    _check_merge(rows, w, cap)
    n = rows.shape[1]
    if out is None:
        out = torch.empty(n, dtype=torch.int32, device=rows.device)
    sh = torch.arange(0, 8, w, dtype=torch.int32, device=rows.device)
    for i in range(0, n, _PLAIN_WORDS):
        part = rows[:, i:i + _PLAIN_WORDS]
        f = torch.stack([counter_fields(r.contiguous(), w)
                         for r in part]).sum(0, dtype=torch.int32)
        b = (f.clamp(max=cap).reshape(-1, 8 // w) << sh).sum(1)
        out[i:i + part.shape[1]] = b.to(torch.uint8).view(torch.int32)
    return out


def count_group(batches, k: int, pbase: int, a: int, row) -> None:
    """K8a of one shard's batches (all on one device) into ``row``:
    directly where they lie on the row's device, else into counters on
    their own device, copied over and freed."""
    batches = [p for p in batches if p.n_bases]
    if not batches:
        return
    dev = batches[0].codes.device
    local = row if dev == row.device else torch.zeros_like(row, device=dev)
    for p in batches:
        count_kmers(p, k, pbase, a, local)
    if local is not row:
        row.copy_(local)


def _abundance(a) -> int:
    """``a`` clamped to -1 .. 255: below 0 every k-mer is solid, from 255
    none (the u8 count's limit)."""
    return max(-1, min(int(a), 255))


def build_words(groups, k: int, abundance: int,
                max_count_bytes: int = DEFAULT_MAX_COUNT_BYTES,
                device=None):
    """The partitioned sweep over the half-space through K8a, K10 and K8b
    on ``device`` (the first group's first batch's by default: the
    kernels on the card, their plain versions on the CPU).  ``groups``
    holds the batches by shard: each group counts into its own row of
    counters, the rows (all of them together at most
    ``max_count_bytes``) merged by K10 where there is more than one.
    Returns the bitfield as int32 words."""
    dc.check_k(k)
    dev = device or groups[0][0].codes.device
    a = _abundance(abundance)
    if not 0 <= a <= 254:   # nothing to count
        words = torch.full((half_words(k),), -1 if a < 0 else 0,
                           dtype=torch.int32, device=dev)
        return _tail_mask(words, k)
    w = counter_bits(a)
    d = len(groups)
    half = 1 << (2 * k - 1)
    psize = partition_size(k, w, max_count_bytes // d)
    nparts = -(-half // psize)
    # at w = 1 and one group the counters are the bitfield's words
    words = (torch.zeros if w == 1 else torch.empty)(
        nparts * psize // 32, dtype=torch.int32, device=dev)
    rows = None if w == 1 and d == 1 else torch.zeros(
        (d, psize * w // 32), dtype=torch.int32, device=dev)
    merged = None if w == 1 or d == 1 else torch.empty(
        psize * w // 32, dtype=torch.int32, device=dev)
    for part in range(nparts):
        out = words[part * psize // 32:(part + 1) * psize // 32]
        # the last partition's counters are read by nothing after it
        last = part + 1 == nparts
        for r, batches in enumerate(groups):
            count_group(batches, k, part * psize, a,
                        out if rows is None else rows[r])
        if d > 1:
            merge_counts(rows, w, a + 1, out if w == 1 else merged)
            if not last:
                rows.zero_()
        if w > 1:
            threshold_pack(rows[0] if d == 1 else merged, a, out,
                           clear=d == 1 and not last)
    return _tail_mask(words[:half_words(k)], k)


def solid_words_plain(batches, k: int, abundance: int,
                      device=None):
    """The whole build in plain PyTorch ops: the valid positions'
    canonical indices, ``torch.unique`` with counts, ``min(count, 255) >
    a``, one bit each.  Returns the bitfield as int32 words on
    ``device`` (the batches' by default)."""
    dc.check_k(k)
    dev = device or (batches[0].codes.device if batches else "cpu")
    words = torch.zeros(half_words(k), dtype=torch.int32, device=dev)
    a = _abundance(abundance)
    if a < 0:
        return _tail_mask(words.fill_(-1), k)
    idx = [canonical_index(p, k) for p in batches]
    if not idx:
        return words
    u, c = torch.unique(torch.cat(idx), return_counts=True)
    solid = u[c.clamp(max=255) > a].to(dev)
    # distinct indices are distinct (word, bit), so adding their bits is
    # their OR (bit 31 is the int32 -2^31)
    ones = torch.ones_like(solid, dtype=torch.int32)
    words.index_add_(0, solid >> 5,
                     torch.bitwise_left_shift(ones, (solid & 31).int()))
    return words


class SolidBuilder:
    """Count k-mers batch by batch on a device, then threshold them into
    the solid bitfield (``finish``).  On the card the sweep runs K8; on
    the CPU, ``solid_words_plain``."""

    def __init__(self, k: int, device,
                 max_count_bytes: int = DEFAULT_MAX_COUNT_BYTES):
        dc.check_k(k)
        self.k = k
        self.device = torch.device(device)
        self.max_count_bytes = max_count_bytes
        self.batches: list = []

    def add(self, seqs) -> None:
        """Pack a batch of reads and keep it on the device."""
        p = pack_reads(seqs, self.k, self.device)
        if p.n_bases:
            self.batches.append(p)

    def finish(self, abundance: int):
        """The bitfield of ``min(count, 255) > abundance`` as int32 words
        on the device."""
        if self.device.type == "cuda":
            return build_words([self.batches], self.k, abundance,
                               self.max_count_bytes, self.device)
        return solid_words_plain(self.batches, self.k, abundance,
                                 self.device)


def build_solid_words(seqs, k: int, abundance: int, device,
                      max_count_bytes: int = DEFAULT_MAX_COUNT_BYTES):
    """The bitfield of the solid k-mers of ``seqs`` on ``device`` (the
    counterpart of ``build_solid_words_on_device``)."""
    b = SolidBuilder(k, device, max_count_bytes)
    b.add(seqs)
    return b.finish(abundance)


def device_words_to_solid(words, k: int) -> SolidSet:
    """A host ``SolidSet`` of a device bitfield (one device-to-host copy:
    1 GiB at k = 17)."""
    nbytes = max(1, (1 << (2 * k - 1)) // 8)
    bits = words.cpu().numpy().view(np.uint8)[:nbytes]
    return SolidSet(k, np.ascontiguousarray(bits))


def popcount_words(words) -> int:
    """Set bits of an int32 bitfield (on its device)."""
    x = words.long() & 0xFFFFFFFF
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return int((((x * 0x01010101) & 0xFFFFFFFF) >> 24).sum())


class DeviceSolidSet:
    """A solid set whose bitfield lives on a device (``build_solid_words``'s
    output), with the k and the table interface of ``SolidSet``; a host
    ``SolidSet`` of it is made once, at first ``host()`` (the native
    engine's host reads need one)."""

    def __init__(self, k: int, words):
        dc.check_k(k)
        if words.dtype != torch.int32 or words.shape != (half_words(k),):
            raise ValueError("words must be the int32 bitfield of k")
        self.k = k
        self.words = words
        self._host = None

    def device_words(self, device):
        return self.words.to(device)

    def host(self) -> SolidSet:
        if self._host is None:
            self._host = device_words_to_solid(self.words, self.k)
        return self._host

    def count_ones(self) -> int:
        return popcount_words(self.words)
