"""Device mesh plumbing: data-parallel shards, sharded counting and the
sharded solid-set build (the port of ``br_tpu.parallel.mesh``).

A ``Mesh`` is a tuple of ``torch.device``s, one a shard.  A device may
appear more than once, so one card (or the CPU, in tests) can hold several
shards; on a host with more cards the same code spreads the shards over
them.  A shard's work runs on its device (``kernels.launch`` makes the
device current for each launch), and whatever is merged is gathered on
the mesh's first device by peer copies.

The shards count with K8a (``csrc/solid_build.cu``) into w-bit counters
that saturate at a + 1, so their merge is no psum: K10 ``merge_counts``
(``csrc/merge_counts.cu``, bound in ``set/device_build.py`` beside the
sweep that runs it) takes each counter to min(sum over the shards, a + 1),
field by field.
"""

from __future__ import annotations

import numpy as np
import torch

from br_tpu_torch.correct import device_codec as dc
from br_tpu_torch.set import device_build as db
from br_tpu_torch.set.device_build import (  # noqa: F401
    merge_counts,
    merge_counts_plain,
)


class Mesh(tuple):
    """A 1-D data-parallel mesh: shard d runs on ``mesh[d]``."""

    @property
    def size(self) -> int:
        return len(self)

    @property
    def devices(self) -> tuple:
        """The distinct devices, in the order of their first shard."""
        return tuple(dict.fromkeys(self))


def _device(d) -> torch.device:
    """A mesh device: an int is a CUDA ordinal; "cuda" is the current
    CUDA device; CUDA only where it is available."""
    d = torch.device("cuda", d) if isinstance(d, int) else torch.device(d)
    if d.type == "cpu":
        return d
    if d.type != "cuda":
        raise ValueError(f"unsupported device {d}: a mesh holds cuda "
                         "devices, or the cpu when asked")
    if not torch.cuda.is_available():
        raise RuntimeError(f"mesh device {d} was asked for and CUDA is "
                           "not available")
    index = torch.cuda.current_device() if d.index is None else d.index
    if not 0 <= index < torch.cuda.device_count():
        raise ValueError(f"no CUDA device {index} (this host has "
                         f"{torch.cuda.device_count()})")
    return torch.device("cuda", index)


def data_parallel_mesh(devices=None) -> Mesh:
    """A mesh over every CUDA device, or over ``devices`` (repeats allowed:
    ``["cuda:0"] * 4`` puts four shards on one card).  Without CUDA and
    without ``devices`` it raises: it never picks the CPU on its own."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("data_parallel_mesh: no CUDA device; pass "
                               "devices (e.g. ['cpu'] * 4) to shard on "
                               "the CPU")
        devices = range(torch.cuda.device_count())
    mesh = Mesh(_device(d) for d in devices)
    if not mesh:
        raise ValueError("a mesh needs at least one device")
    if len({d.type for d in mesh}) > 1:
        raise ValueError(f"a mesh's devices are all cuda or all cpu: "
                         f"{list(mesh)}")
    return mesh


def shard_batch(mesh: Mesh, ascii_batch, lens):
    """A padded (B, L) read batch split along B, shard d's rows (and
    their lens) on ``mesh[d]``: a list of (rows, lens) tensors.  B must be
    a multiple of the mesh size (the driver pads with empty lanes)."""
    batch = torch.as_tensor(np.asarray(ascii_batch, dtype=np.uint8))
    lens = torch.as_tensor(np.asarray(lens, dtype=np.int32))
    if batch.dim() != 2 or lens.shape != batch.shape[:1]:
        raise ValueError("a batch is (B, L) with B lens")
    if batch.shape[0] % mesh.size:
        raise ValueError(f"batch of {batch.shape[0]} rows does not split "
                         f"over {mesh.size} shards")
    return [(b.to(d), n.to(d)) for b, n, d in
            zip(batch.chunk(mesh.size), lens.chunk(mesh.size), mesh)]


def _to(x, device):
    """A device table (bitfield words, a ``SortedTable``) on ``device``,
    the object itself where it is there already."""
    if isinstance(x, dc.SortedTable):
        if x.table.device == device:
            return x
        return dc.SortedTable(x.table.to(device), x.starts.to(device),
                              x.shift, x.bucket_levels)
    return x.to(device)


def replicated(mesh: Mesh, x) -> tuple:
    """``x`` (a tensor or a ``SortedTable``) copied once to each distinct
    device of the mesh: shard d's copy at index d (shards of one device
    share it)."""
    copies = {d: _to(x, d) for d in mesh.devices}
    return tuple(copies[d] for d in mesh)


def count_sharded(mesh: Mesh, ascii_batch, lens, k: int):
    """Count a (B, L) batch across the mesh: the rows split into
    ``mesh.size`` contiguous shards, each packed (``pack_reads``: row b's
    first lens[b] bases) and counted by K8a on its device into 8-bit
    counters saturating at 255 (a = 254), every shard's counters gathered
    on the mesh's first device and merged by K10.  Returns the saturated
    u8 count of every canonical index (2^(2k-1) uint8 on ``mesh[0]``):
    byte for byte ``counts_to_u8`` of br_tpu's ``count_sharded``.  Device
    memory on ``mesh[0]``: (D + 1) 2^(2k-1) bytes at the merge."""
    dc.check_k(k)
    batch = np.asarray(ascii_batch, dtype=np.uint8)
    lens = np.asarray(lens)
    half = 1 << (2 * k - 1)
    n = max(db.GROUP, half) // 4
    dev0 = mesh[0]
    rows = torch.zeros((mesh.size, n), dtype=torch.int32, device=dev0)
    for d, (idx, dev) in enumerate(zip(
            np.array_split(np.arange(batch.shape[0]), mesh.size), mesh)):
        p = db.pack_reads([batch[b, :lens[b]].tobytes() for b in idx], k,
                          dev)
        db.count_group([p], k, 0, 254, rows[d])
    out = merge_counts(rows, 8, 255)
    del rows
    return out.view(torch.uint8)[:half]


def counts_to_u8(counts):
    """pcon-compatible saturating-u8 view of a count array: the identity
    on ``count_sharded``'s uint8 counts; wider counts (a tensor, or a
    numpy array as ``count_stripe_merged`` returns) clamped at 255."""
    if isinstance(counts, torch.Tensor):
        if counts.dtype == torch.uint8:
            return counts
        return counts.clamp(max=255).to(torch.uint8)
    return np.minimum(np.asarray(counts), 255).astype(np.uint8)


def solid_sharded(mesh: Mesh, seqs, k: int, abundance: int,
                  max_count_bytes: int = db.DEFAULT_MAX_COUNT_BYTES):
    """The solid set of ``seqs`` at ``abundance`` built across the mesh:
    the reads split into ``mesh.size`` contiguous shards, each packed on
    its device, then ``device_build.build_words`` with a group a shard
    (K8a on each shard's device, K10 merging on the first, K8b packing).
    Bit for bit ``build_solid_words`` and the host
    ``Counter(k).to_solid(a)``, for every a.  Returns a
    ``DeviceSolidSet`` on ``mesh[0]``."""
    dc.check_k(k)
    seqs = list(seqs)
    groups = [[db.pack_reads([seqs[i] for i in idx], k, dev)] for idx, dev
              in zip(np.array_split(np.arange(len(seqs)), mesh.size), mesh)]
    return db.DeviceSolidSet(k, db.build_words(groups, k, abundance,
                                               max_count_bytes, mesh[0]))
