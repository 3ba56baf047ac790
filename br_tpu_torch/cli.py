"""Command-line interface of the port — the br-compatible parser of
``br_tpu.cli`` (with ``--backend``, ``--trace``, ``--line-width``) plus
``--device``.

    python -m br_tpu_torch.cli -i reads.fa -o out.fa \\
        fasta -i reads.fa -k 13 -a 2

Global flags + one set-construction subcommand:

* ``count``  — load a serialized count file, threshold to a solid set
  (src/main.rs:60-70);
* ``fasta``  — count the corpus, threshold to a solid set
  (src/main.rs:72-85); even k is silently rounded down to odd
  (src/cli.rs:277-279).  With ``-a`` the count, the threshold and the
  bitfield stay on the corrector's device (``set/device_build.py``, kernel
  K8 on the card; the records stream through in batches); a selection
  method counts on the host (``Counter``, ``Spectrum``), as br_tpu does;
* ``solid``  — load a membership set from a solid artifact / csv /
  fasta / fastq (src/main.rs:117-145);
* ``large-kmer`` — a sparse ``HashSet`` of every k-mer of a csv / fasta /
  fastq input, any k <= 31 (src/main.rs:147-160), corrected through the
  sorted-table instantiations of the kernels.

Abundance selection (count/fasta) is a nested subcommand, like the
reference: ``first-minimum`` | ``rarefaction PERCENT`` |
``percent-most PERCENT`` | ``percent-least PERCENT``; or pass ``-a``.

``-c`` names the strategies of the chain, in order, from ``one``,
``two``, ``graph``, ``greedy`` and ``gap-size``; without ``-c`` the chain
is br's default, all five in that order.  A solid bitfield above k = 17
is refused (2^(2k-1) bits: a host ``Counter`` at k = 19 would hold 128
GiB, in br_tpu too): for ``fasta`` before anything is counted, for
``count`` and ``solid`` as soon as the set is loaded; ``large-kmer`` is
the way to a large k.

``--backend`` picks the corrector (``runtime.make_corrector``): ``auto``
(default) and ``torch`` the device corrector, on ``--device``: ``cuda``
(default) or ``cpu`` (the kernels' plain PyTorch versions); ``native``
(the C++ host engine) and ``oracle`` (the Python reference) run on the
host only, touch no CUDA, and build the set as br_tpu's CLI does (the
host ``Counter`` for ``fasta``).  ``-t`` sets the native engine's host
threads (0: one a core): for the device corrector those of the reads the
device does not finish.  ``-T sec|ms|ns`` stamps every log line;
``-v`` ends the run with one line a stage (``build-set``, ``correct``,
``write``: ``profiling.report``); ``--trace DIR`` writes a
``torch.profiler`` trace of the run (``profiling.device_trace``).
"""

from __future__ import annotations

import argparse
import logging
import sys

import torch

from br_tpu_torch import (
    DEFAULT_CONFIRM,
    DEFAULT_CORRECTIONS,
    DEFAULT_MAX_SEARCH,
    DEFAULT_RECORD_BUFFER,
    __version__,
    profiling,
)
from br_tpu_torch.correct.device_codec import MAX_K_SOLID
from br_tpu_torch.count import Counter, Spectrum, ThresholdMethod
from br_tpu_torch.errors import (
    AbundanceThresholdOrAbundanceMethod,
    BrError,
    ComputeAbundanceThreshold,
    SolidRequireKmerSize,
)
from br_tpu_torch.io.fasta import open_maybe_compressed, read_records
from br_tpu_torch.runtime import HOST_BACKENDS, run_correction, stdio_streams
from br_tpu_torch.set import HashSet, SolidSet
from br_tpu_torch.set.device_build import (
    BATCH_BASES, DeviceSolidSet, SolidBuilder)

METHOD_CHOICES = ("one", "two", "graph", "greedy", "gap-size")


def round_down_odd(k: int) -> int:
    """Silent even->odd rounding (src/cli.rs:277-279: k - (!(k&1)&1))."""
    return k - ((~k & 1) & 1)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="br-tpu-torch",
        description="br-tpu-torch: the PyTorch/CUDA port of br-tpu, a "
        "long-read k-mer corrector (capability parity with natir/br)",
    )
    p.add_argument("--version", action="version", version=__version__)
    p.add_argument("-i", "--inputs", action="append",
                   help="input read file (repeatable; default stdin)")
    p.add_argument("-o", "--outputs", action="append",
                   help="output file (repeatable; default stdout)")
    p.add_argument("-s", "--two-side", action="store_true",
                   help="correct in two side (disables the reverse pass, "
                   "mirroring the reference's inverted flag)")
    p.add_argument("-c", "--corrections", action="append",
                   choices=METHOD_CHOICES,
                   help="correction method, repeatable (default: the "
                   "chain one, two, graph, greedy, gap-size)")
    p.add_argument("-C", "--confirm", type=int, default=DEFAULT_CONFIRM,
                   help="number of kmers required to validate a correction")
    p.add_argument("-M", "--max-search", type=int, default=DEFAULT_MAX_SEARCH,
                   help="number of bases used to try to correct an error")
    p.add_argument("-b", "--record_buffer", type=int,
                   default=DEFAULT_RECORD_BUFFER,
                   help="number of records per batch")
    p.add_argument("-t", "--threads", type=int, default=0,
                   help="host threads of the native engine: the native "
                   "backend's, or the device corrector's for the reads the "
                   "device does not finish (0: one a core)")
    p.add_argument("-q", "--quiet", action="store_true",
                   help="silence all output")
    p.add_argument("-v", "--verbosity", action="count", default=0)
    p.add_argument("-T", "--timestamp", choices=("sec", "ms", "ns", "none"),
                   default="none")
    p.add_argument("--backend", choices=("auto", "torch", "native",
                                          "oracle"),
                   default="auto", help="correction backend (auto: torch, "
                   "the device corrector; native, oracle: on the host)")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help="where the device corrector and the set build of "
                   "`fasta -a` run (cpu: the kernels' plain PyTorch "
                   "versions); the host backends ignore it")
    p.add_argument("--line-width", type=int, default=80,
                   help="FASTA output wrap width (0 = single line)")
    p.add_argument("--trace", metavar="DIR",
                   help="write a torch.profiler trace of the run to "
                   f"DIR/{profiling.TRACE_FILE}")

    sub = p.add_subparsers(dest="subcommand", required=True)

    def add_abundance_selection(sp):
        sel = sp.add_subparsers(dest="abundance_selection")
        sel.add_parser("first-minimum")
        for name in ("rarefaction", "percent-most", "percent-least"):
            s = sel.add_parser(name)
            s.add_argument("percent", type=float)

    c = sub.add_parser("count", help="build the solid set from a count file")
    c.add_argument("-i", "--inputs", required=True, dest="count_input")
    c.add_argument("-a", "--abundance", type=int)
    add_abundance_selection(c)

    f = sub.add_parser("fasta", help="count the corpus, threshold to a solid set")
    f.add_argument("-i", "--inputs", action="append", required=True,
                   dest="set_inputs")
    f.add_argument("-k", "--kmer-size", type=int, required=True)
    f.add_argument("-a", "--abundance", type=int)
    add_abundance_selection(f)

    s = sub.add_parser("solid", help="load a membership set")
    s.add_argument("-i", "--input", required=True, dest="set_input")
    s.add_argument("-f", "--format", required=True,
                   choices=("solid", "csv", "fasta", "fastq"))
    s.add_argument("-k", "--kmer-size", type=int)

    lk = sub.add_parser("large-kmer", help="sparse set for large k")
    lk.add_argument("-i", "--input", required=True, dest="set_input")
    lk.add_argument("-f", "--format", required=True,
                    choices=("csv", "fasta", "fastq"))
    lk.add_argument("-k", "--kmer-size", type=int, required=True)

    return p


def _threshold(counter: Counter, abundance, selection, percent) -> int:
    """Pick the abundance threshold (src/main.rs:95-110)."""
    if abundance is not None:
        return abundance
    if selection is None:
        raise AbundanceThresholdOrAbundanceMethod()
    spectrum = Spectrum.from_count(counter.raw())
    method = {
        "first-minimum": ThresholdMethod.FIRST_MINIMUM,
        "rarefaction": ThresholdMethod.RAREFACTION,
        "percent-most": ThresholdMethod.PERCENT_AT_MOST,
        "percent-least": ThresholdMethod.PERCENT_AT_LEAST,
    }[selection]
    t = spectrum.get_threshold(method, percent or 0.0)
    if t is None:
        raise ComputeAbundanceThreshold()
    return t


def build_set(args):
    """Build the k-mer set per subcommand (src/main.rs:35-40)."""
    if args.subcommand == "count":
        counter = Counter.load(args.count_input)
        a = _threshold(counter, args.abundance, args.abundance_selection,
                       getattr(args, "percent", None))
        return counter.to_solid(a)

    if args.subcommand == "fasta":
        k = round_down_odd(args.kmer_size)
        if args.abundance is not None and args.backend not in HOST_BACKENDS:
            return device_set(args.set_inputs, k, args.abundance,
                              args.device)
        counter = Counter(k)
        for path in args.set_inputs:
            for _d, seq, _q in read_records(path):
                counter.count_sequence(seq)
        a = _threshold(counter, args.abundance, args.abundance_selection,
                       getattr(args, "percent", None))
        return counter.to_solid(a)

    if args.subcommand == "solid":
        fmt = args.format
        if fmt == "solid":
            return SolidSet.load(args.set_input)
        if args.kmer_size is None:
            raise SolidRequireKmerSize()
        if fmt == "csv":
            with open_maybe_compressed(args.set_input) as fh:
                return SolidSet.from_csv(fh, args.kmer_size)
        seqs = (seq for _d, seq, _q in read_records(args.set_input))
        return SolidSet.from_sequences(seqs, args.kmer_size)

    if args.subcommand == "large-kmer":
        if args.format == "csv":
            with open_maybe_compressed(args.set_input) as fh:
                return HashSet.from_csv(fh, args.kmer_size)
        seqs = (seq for _d, seq, _q in read_records(args.set_input))
        return HashSet.from_sequences(seqs, args.kmer_size)

    raise SystemExit(f"unknown subcommand {args.subcommand}")


def device_set(paths, k: int, abundance: int, device) -> DeviceSolidSet:
    """``fasta -a``: the records of ``paths`` streamed in batches of about
    BATCH_BASES bases into a ``SolidBuilder`` on ``device``, thresholded
    at ``abundance``; the bitfield stays there."""
    from br_tpu_torch.correct.engine3 import resolve_device

    builder = SolidBuilder(k, resolve_device(device))
    batch, n = [], 0
    for path in paths:
        for _d, seq, _q in read_records(path):
            batch.append(seq)
            n += len(seq)
            if n >= BATCH_BASES:
                builder.add(batch)
                batch, n = [], 0
    builder.add(batch)
    return DeviceSolidSet(k, builder.finish(abundance))


def refuse_k(k: int, kind: str = "solid") -> bool:
    """Print one error line and return True when the device path cannot
    take a set of ``kind`` at k: a solid bitfield above k = 17 (a
    ``HashSet``, ``large-kmer``, takes any k <= 31)."""
    if kind == "hash" or 1 <= k <= MAX_K_SOLID:
        return False
    print(f"error: k={k} is too large for a solid bitfield (br_tpu_torch "
          f"takes an odd k <= {MAX_K_SOLID} there); use large-kmer for "
          f"larger k", file=sys.stderr)
    return True


class _TimestampFormatter(logging.Formatter):
    """stderrlog-style optional timestamps (-T sec|ms|ns, src/main.rs:27)."""

    def __init__(self, unit: str):
        super().__init__("%(asctime)s %(levelname)s %(name)s: %(message)s",
                         datefmt="%Y-%m-%dT%H:%M:%S")
        self.unit = unit

    def formatTime(self, record, datefmt=None):
        base = super().formatTime(record, datefmt)
        if self.unit == "ms":
            return f"{base}.{int(record.msecs):03d}"
        if self.unit == "ns":
            frac = record.created - int(record.created)
            return f"{base}.{int(frac * 1e9):09d}"
        return base


def configure_logging(quiet: bool, verbosity: int, timestamp: str) -> None:
    """stderr logging à la stderrlog (src/main.rs:22-28): -q silences,
    -v raises verbosity, -T adds timestamps."""
    level = logging.CRITICAL if quiet else (
        [logging.WARNING, logging.INFO, logging.DEBUG][min(verbosity, 2)]
    )
    handler = logging.StreamHandler(sys.stderr)
    if timestamp != "none":
        handler.setFormatter(_TimestampFormatter(timestamp))
    else:
        handler.setFormatter(
            logging.Formatter("%(levelname)s %(name)s: %(message)s"))
    root = logging.getLogger()
    root.handlers[:] = [handler]
    root.setLevel(level)


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    configure_logging(args.quiet, args.verbosity, args.timestamp)

    corrections = args.corrections or list(DEFAULT_CORRECTIONS)
    # before anything is counted
    if (args.subcommand == "fasta"
            and refuse_k(round_down_odd(args.kmer_size))):
        return 2
    on_card = args.backend not in HOST_BACKENDS and args.device == "cuda"
    if on_card and not torch.cuda.is_available():
        print("error: --device cuda was asked for and CUDA is not "
              "available; pass --device cpu to run on the CPU",
              file=sys.stderr)
        return 1

    try:
        with profiling.device_trace(args.trace, cuda=on_card):
            with profiling.stage("build-set"):
                kmer_set = build_set(args)
            if refuse_k(kmer_set.k, "hash" if isinstance(kmer_set, HashSet)
                        else "solid"):
                return 2
            inputs, outputs = stdio_streams(args.inputs, args.outputs)
            n = run_correction(
                inputs,
                outputs,
                kmer_set,
                corrections,
                args.confirm,
                args.max_search,
                args.two_side,
                record_buffer=args.record_buffer,
                line_width=args.line_width,
                device=args.device,
                threads=args.threads,
                backend=args.backend,
            )
        if args.verbosity:
            logging.getLogger("br_tpu_torch").info("corrected %d records", n)
            profiling.report()
    except BrError as e:
        print(f"error: {e}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
