"""Several processes, each on its own device (the port of
``br_tpu.parallel.multihost``, with ``jax.distributed`` swapped for
``torch.distributed``).

* ``initialize`` joins a process group over TCP (``gloo``: every
  collective here is on host arrays, the counts and the record count) and
  picks the process's device: ``local_device_ids[0]``, or
  ``cuda:(process_id % device_count)``, never the CPU unless asked.
  Several processes may share one card.  ``shutdown`` leaves the group.
* **Counting** (``count_stripe_merged``): each process counts its record
  stripe on the host into wide (u32, non-saturating) counts, and one
  ``all_reduce`` sums them; saturation is taken once, from the merged
  counts, so striping cannot change a threshold.
* **Correction**: each process corrects its stripe with its own corrector
  on its device and writes a part file; process 0 merges the parts in
  input order.  ``run_correction_striped`` stripes records round robin
  and merges by interleaving (completion by sentinel files);
  ``run_correction_ranged`` gives each process one contiguous byte range
  of a plain FASTA input, meets the others at an ``all_reduce`` of its
  record count, and merges by concatenation.
"""

from __future__ import annotations

import datetime
import logging
import os
import time
from typing import Optional, Sequence

import numpy as np
import torch

from br_tpu_torch import DEFAULT_RECORD_BUFFER

log = logging.getLogger("br_tpu_torch")

#: the device ``initialize`` chose for this process
_STATE: dict = {}


def initialize(coordinator_address: str, num_processes: int,
               process_id: int, local_device_ids=None,
               timeout_s: float = 300.0) -> None:
    """Join the process group (``gloo`` over ``tcp://``, the coordinator
    being process 0's address, e.g. ``localhost:29500``) and set this
    process's device: ``local_device_ids[0]`` (an int is a CUDA ordinal;
    ``"cpu"`` asks for the CPU), else ``cuda:(process_id %
    device_count)``.  No CUDA and no device asked for raises before the
    rendezvous.  A collective that waits longer than ``timeout_s`` for a
    process (one that died) raises."""
    import torch.distributed as dist

    device = _default_device(process_id, local_device_ids)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    addr = coordinator_address
    if "://" not in addr:
        addr = "tcp://" + addr
    dist.init_process_group(
        "gloo", init_method=addr, world_size=num_processes,
        rank=process_id, timeout=datetime.timedelta(seconds=timeout_s))
    _STATE["device"] = device


def shutdown() -> None:
    """Leave the process group: a barrier, so that no process tears its
    connections down while another still uses them, then its
    destruction (a process that exits with the group alive may abort in
    its communication threads)."""
    import torch.distributed as dist

    if dist.is_initialized():
        dist.barrier()
        dist.destroy_process_group()
    _STATE.pop("device", None)


def _default_device(process_id: int, local_device_ids=None) -> torch.device:
    from br_tpu_torch.parallel.mesh import _device

    if local_device_ids:
        return _device(local_device_ids[0])
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device for this process; pass "
                           "local_device_ids=['cpu'] to run on the CPU")
    return torch.device("cuda", process_id % torch.cuda.device_count())


def local_device(process_id: int = 0, device=None) -> torch.device:
    """The device this process corrects on: ``device`` when given, else
    the one ``initialize`` chose, else ``cuda:(process_id %
    device_count)`` (no CUDA raises)."""
    if device is not None:
        from br_tpu_torch.parallel.mesh import _device

        return _device(device)
    if "device" in _STATE:
        return _STATE["device"]
    return _default_device(process_id)


def global_mesh():
    """The mesh of every process's device in rank order (a collective:
    every process calls it).  Entry r is process r's device as that
    process names it; only process r computes on it."""
    import torch.distributed as dist

    from br_tpu_torch.parallel.mesh import Mesh

    if not dist.is_initialized():
        return Mesh([local_device()])
    names = [None] * dist.get_world_size()
    dist.all_gather_object(names, str(local_device(dist.get_rank())))
    return Mesh(torch.device(n) for n in names)


def count_stripe_merged(seqs, k: int, process_id: int, num_processes: int):
    """Count this process's record stripe (records ``i % num_processes ==
    process_id``) into host u32 counts, then sum across processes.

    Returns the merged uint32 count array (identical in every process).
    Needs ``initialize`` first, or a single process, where it is the
    local count.  gloo does not reduce uint32, so the sum is taken in
    int64 and cast back (modulo 2^32, as a u32 sum wraps)."""
    from br_tpu_torch.count import Counter

    local = Counter(k, count_dtype=np.uint32)
    for i, s in enumerate(seqs):
        if i % num_processes == process_id:
            local.count_sequence(s)
    if num_processes == 1:
        return local.counts

    import torch.distributed as dist

    total = torch.from_numpy(local.counts.astype(np.int64))
    dist.all_reduce(total, op=dist.ReduceOp.SUM)
    return total.numpy().astype(np.uint32)


def part_path(output: str, process_id: int) -> str:
    return f"{output}.part{process_id}"


# ---------------------------------------------------------------------------
# Contiguous byte-range striping: each process reads only ~1/P of the
# input's bytes (ranges snapped forward to the next record start, which
# balances bytes, a better proxy for work than records with 157 b .. 62 kb
# reads), completion is a collective barrier, and the merge is a raw byte
# concatenation of the parts in range order.  Compressed inputs cannot
# seek and FASTQ cannot be snapped: fasta_range_bounds refuses both, and
# the caller takes the striped path.
# ---------------------------------------------------------------------------


def fasta_range_bounds(path: str, process_id: int, num_processes: int):
    """[start, end) byte range of this process's stripe, snapped to record
    starts (a ``>`` at line start).  Plain (uncompressed) FASTA only."""
    with open(path, "rb") as fh:
        head = fh.read(2)
        if head[:2] in (b"\x1f\x8b", b"BZ"):
            raise ValueError("ranged striping needs an uncompressed input")
        # FASTQ would pass the compression check but '>' occurs inside
        # quality lines (Phred+33 Q29), so '\n>' snapping would split
        # records mid-stream; require a real FASTA head byte.
        if head[:1] != b">":
            raise ValueError(
                "ranged striping needs plain FASTA (file must start "
                "with '>'); use the striped path for FASTQ/compressed")
        fh.seek(0, os.SEEK_END)
        size = fh.tell()

        def snap(off: int) -> int:
            if off <= 0:
                return 0
            if off >= size:
                return size
            fh.seek(off - 1)
            prev = fh.read(1)
            pos = off
            while True:
                chunk = fh.read(1 << 20)
                if not chunk:
                    return size
                data = prev + chunk
                i = data.find(b"\n>")
                if i >= 0:
                    return pos - 1 + i + 1
                pos += len(chunk)
                prev = data[-1:]

        lo = snap(size * process_id // num_processes)
        hi = snap(size * (process_id + 1) // num_processes)
        return lo, hi


def _read_records_range(path: str, start: int, end: int):
    """Yield FASTA records whose byte offset lies in [start, end)."""
    if start >= end:
        return
    with open(path, "rb") as fh:
        fh.seek(start)
        definition = None
        seq_parts: list = []
        consumed = 0
        budget = end - start
        for line in fh:
            if consumed >= budget and line.startswith(b">"):
                break
            consumed += len(line)
            if line.startswith(b">"):
                if definition is not None:
                    yield (definition, b"".join(seq_parts), None)
                definition = line[1:].rstrip(b"\r\n")
                seq_parts = []
            else:
                seq_parts.append(line.strip())
            if consumed >= budget:
                # finish the current record (it may spill past `end`;
                # the snap guarantees no NEW record starts before it)
                for line2 in fh:
                    if line2.startswith(b">"):
                        break
                    seq_parts.append(line2.strip())
                break
        if definition is not None:
            yield (definition, b"".join(seq_parts), None)


def _corrector(valid_kmer, corrections, confirm, max_search, process_id,
               device):
    from br_tpu_torch.runtime import make_corrector

    return make_corrector(valid_kmer, corrections, confirm, max_search,
                          device=local_device(process_id, device))


def run_correction_ranged(
    input_path: str,
    output_path: str,
    valid_kmer,
    corrections: Sequence[str],
    confirm: int,
    max_search: int,
    two_side: bool,
    process_id: int,
    num_processes: int,
    device=None,
    record_buffer: int = DEFAULT_RECORD_BUFFER,
    line_width: int = 80,
    barrier: bool = True,
) -> Optional[int]:
    """Correct this process's contiguous byte-range stripe on its device
    (``local_device``).

    All processes meet at an ``all_reduce`` of their record counts (the
    barrier, no polling); process 0 then concatenates the part files
    byte for byte in range order, the single-process output because the
    ranges partition the record sequence.  Returns the total record count
    on process 0, None elsewhere."""
    from br_tpu_torch.io.fasta import write_fasta_record

    lo, hi = fasta_range_bounds(input_path, process_id, num_processes)
    corrector = _corrector(valid_kmer, corrections, confirm, max_search,
                           process_id, device)

    part = part_path(output_path, process_id)
    n_local = 0
    batch: list = []
    with open(part, "wb") as out:

        def flush():
            nonlocal n_local
            if not batch:
                return
            seqs = [s for (_d, s, _q) in batch]
            fixed = corrector.correct_batch(seqs, two_side)
            for (definition, _s, _q), f in zip(batch, fixed):
                write_fasta_record(out, definition, f, width=line_width)
                n_local += 1
            batch.clear()

        for rec in _read_records_range(input_path, lo, hi):
            batch.append(rec)
            if len(batch) >= record_buffer:
                flush()
        flush()

    if barrier and num_processes > 1:
        import torch.distributed as dist

        count = torch.tensor([n_local], dtype=torch.int64)
        dist.all_reduce(count, op=dist.ReduceOp.SUM)
        total = int(count[0])
    else:
        total = n_local

    if process_id != 0:
        return None

    with open(output_path, "wb") as out:
        for p in range(num_processes):
            with open(part_path(output_path, p), "rb") as src:
                while True:
                    buf = src.read(1 << 22)
                    if not buf:
                        break
                    out.write(buf)
    for p in range(num_processes):
        os.remove(part_path(output_path, p))
    log.info("multihost ranged merge: %d records from %d parts",
             total, num_processes)
    return total


def run_correction_striped(
    input_path: str,
    output_path: str,
    valid_kmer,
    corrections: Sequence[str],
    confirm: int,
    max_search: int,
    two_side: bool,
    process_id: int,
    num_processes: int,
    device=None,
    record_buffer: int = DEFAULT_RECORD_BUFFER,
    line_width: int = 80,
    merge_timeout_s: float = 600.0,
) -> Optional[int]:
    """Correct this process's stripe on its device (``local_device``);
    process 0 merges to ``output_path``.

    Every process streams the same input (a cheap host parse), corrects
    only records ``i % num_processes == process_id`` and appends them to
    its part file in local order.  A ``.done`` sentinel marks completion;
    process 0 then interleaves the parts round robin, the single-process
    output byte for byte (a part missing after ``merge_timeout_s`` raises
    TimeoutError).  Returns the record count on process 0, None
    elsewhere."""
    from br_tpu_torch.io.fasta import read_records, write_fasta_record

    corrector = _corrector(valid_kmer, corrections, confirm, max_search,
                           process_id, device)

    part = part_path(output_path, process_id)
    batch: list = []
    with open(part, "wb") as out:

        def flush():
            if not batch:
                return
            seqs = [s for (_d, s, _q) in batch]
            fixed = corrector.correct_batch(seqs, two_side)
            for (definition, _s, _q), f in zip(batch, fixed):
                write_fasta_record(out, definition, f, width=line_width)
            batch.clear()

        for i, rec in enumerate(read_records(input_path)):
            if i % num_processes != process_id:
                continue
            batch.append(rec)
            if len(batch) >= record_buffer:
                flush()
        flush()
    with open(part + ".done", "w") as fh:
        fh.write("ok\n")

    if process_id != 0:
        return None

    # ---- order-preserving merge (round-robin interleave) ----------------
    deadline = time.monotonic() + merge_timeout_s
    parts = [part_path(output_path, p) for p in range(num_processes)]
    while not all(os.path.exists(p + ".done") for p in parts):
        if time.monotonic() > deadline:
            missing = [p for p in parts if not os.path.exists(p + ".done")]
            raise TimeoutError(f"multihost merge: parts not ready: {missing}")
        time.sleep(0.05)

    iters = [read_records(p) for p in parts]
    n = 0
    with open(output_path, "wb") as out:
        exhausted = [False] * num_processes
        while not all(exhausted):
            for p in range(num_processes):
                if exhausted[p]:
                    continue
                try:
                    definition, seq, _q = next(iters[p])
                except StopIteration:
                    exhausted[p] = True
                    continue
                write_fasta_record(out, definition, seq, width=line_width)
                n += 1
    for p in parts:
        os.remove(p)
        os.remove(p + ".done")
    log.info("multihost merge: %d records from %d parts", n, num_processes)
    return n
