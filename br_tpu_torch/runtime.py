"""Pipeline runtime: stream records, batch, correct, ordered write-back
(the port of ``br_tpu.runtime``).

Reference: ``run_correction`` (src/lib.rs:72-139) — read ``record_buffer``
records, correct the batch, then write corrected records back in input
order.

Backends (``make_corrector``), all giving the same bytes:

* ``torch``  — ``Torch3Corrector`` on one device: CUDA unless the caller
  passes ``device="cpu"``, which runs the kernels' plain PyTorch
  versions.  It takes every set kind: a solid bitfield (k <= 17) and a
  ``HashSet`` (``large-kmer``, k <= 31), where br_tpu routes a
  ``HashSet`` or k > 17 to its bucketed ``Tpu2Corrector``
  (br_tpu/runtime.py:104-116): the port corrects both in the same flat
  pass engine.  ``auto`` is ``torch``: without CUDA and without
  ``device="cpu"`` it raises, never switching to a host backend.
* ``native`` — the C++ host engine (``br_tpu_torch/native``), the CPU
  baseline.
* ``oracle`` — the scalar Python reference (``correct/reference.py``).
"""

from __future__ import annotations

import logging
import sys
from typing import Iterable, Optional, Sequence

from br_tpu_torch import DEFAULT_RECORD_BUFFER
from br_tpu_torch.correct import build_methods, correct_read
from br_tpu_torch.io.fasta import read_records, write_fasta_record
from br_tpu_torch.profiling import stage

log = logging.getLogger("br_tpu_torch")

#: the backends of ``make_corrector`` that run on the host only
HOST_BACKENDS = ("native", "oracle")


def _batches(records: Iterable, size: int):
    buf = []
    for rec in records:
        buf.append(rec)
        if len(buf) >= size:
            yield buf
            buf = []
    if buf:
        yield buf


def run_correction(
    inputs: Sequence,
    outputs: Sequence,
    valid_kmer,
    corrections: Sequence[str],
    confirm: int,
    max_search: int,
    two_side: bool,
    record_buffer: int = DEFAULT_RECORD_BUFFER,
    line_width: int = 80,
    device=None,
    corrector=None,
    threads: int = 0,
    backend: str = "auto",
) -> int:
    """Correct every record of every (input, output) pair; returns #records.

    ``inputs`` / ``outputs`` are paths or streams, zipped pairwise like the
    reference (src/lib.rs:79).  ``backend`` picks the corrector
    (``make_corrector``), ``device`` the device corrector's device
    (default CUDA) and ``threads`` the native engine's host threads (0:
    one a core); a ready ``corrector`` may be passed instead.
    """
    if corrector is None:
        corrector = make_corrector(valid_kmer, corrections, confirm,
                                   max_search, device=device,
                                   threads=threads, backend=backend)
    n = 0
    for source, sink in zip(inputs, outputs):
        own_sink = isinstance(sink, str)
        out = open(sink, "wb") if own_sink else sink
        try:
            for batch in _batches(read_records(source), record_buffer):
                log.info("correcting batch of %d records", len(batch))
                seqs = [seq for (_d, seq, _q) in batch]
                with stage("correct"):
                    corrected = corrector.correct_batch(seqs, two_side)
                with stage("write"):
                    for (definition, _seq, _qual), fixed in zip(batch,
                                                                corrected):
                        # The reference always writes FASTA records, even
                        # for FASTQ input (src/lib.rs:30-31,121-127).
                        write_fasta_record(out, definition, fixed,
                                           width=line_width)
                        n += 1
        finally:
            if own_sink:
                out.close()
            elif hasattr(out, "flush"):
                out.flush()
    return n


def make_corrector(valid_kmer, corrections, confirm, max_search,
                   device=None, threads: int = 0, backend: str = "auto"):
    """Pick a batch corrector backend: ``auto`` and ``torch`` the device
    corrector on ``device`` ("cuda" by default, or "cpu"), its host reads
    on ``threads`` native threads (0: one a core); ``native`` the host
    engine on ``threads`` threads; ``oracle`` the Python reference.  The
    host backends ignore ``device``."""
    if backend in ("auto", "torch"):
        from br_tpu_torch.correct.engine3 import Torch3Corrector

        return Torch3Corrector(valid_kmer, corrections, confirm, max_search,
                               device=device, threads=threads)
    if backend == "native":
        from br_tpu_torch.native import NativeCorrector

        return NativeCorrector(valid_kmer, corrections, confirm, max_search,
                               threads=threads)
    if backend == "oracle":
        return OracleCorrector(valid_kmer, corrections, confirm, max_search)
    raise ValueError(f"unknown backend {backend!r}")


class OracleCorrector:
    """Scalar reference backend (one read at a time)."""

    def __init__(self, valid_kmer, corrections, confirm, max_search):
        self.methods = build_methods(corrections, valid_kmer, confirm,
                                     max_search)

    def correct_batch(self, seqs: Sequence[bytes], two_side: bool):
        return [correct_read(seq, self.methods, two_side) for seq in seqs]


def stdio_streams(input_paths: Optional[Sequence[str]],
                  output_paths: Optional[Sequence[str]]):
    """Default to stdin/stdout when -i/-o are omitted (src/cli.rs:80-113)."""
    ins = list(input_paths) if input_paths else [sys.stdin.buffer]
    outs = list(output_paths) if output_paths else [sys.stdout.buffer]
    return ins, outs
