"""Judging a job's output FASTA against the reference.

br writes one FASTA record a read, in input order, with the read's
definition line as it was and the corrected sequence wrapped at the line
width (src/lib.rs:30-31, 121-127).  ``read_output`` holds every record
of a job's output to that layout and to the corpus's definitions, and
keeps the sequences of the chosen reads; ``records_wrong`` counts, over
every job, the records that are missing, extra, out of order or laid out
wrongly, and the chosen reads whose sequence differs from the
reference's correction.
"""

from __future__ import annotations


def read_output(data: bytes, definitions, chosen, width: int):
    """(records off, {index: sequence} of the ``chosen`` indices found) of
    a job's output ``data`` against the corpus's ``definitions``."""
    n = len(definitions)
    if not data:
        return n, {}
    if not data.startswith(b">") or not data.endswith(b"\n"):
        return n, {}
    recs = data[1:-1].split(b"\n>")
    off = abs(len(recs) - n)
    want = set(chosen)
    seqs = {}
    for i, (rec, definition) in enumerate(zip(recs, definitions)):
        head, _, body = rec.partition(b"\n")
        lines = body.split(b"\n")
        seq = b"".join(lines)
        laid = (len(lines) == max(1, -(-len(seq) // width)) if width > 0
                else len(lines) == 1)
        if width > 0 and len(lines) > 1:
            laid = laid and set(map(len, lines[:-1])) == {width}
        if head != definition or not laid:
            off += 1
        elif i in want:
            seqs[i] = seq
    return off, seqs


def records_wrong(jobs, reference: dict) -> int:
    """Over every job (``{"records_off": int, "chosen": {i: seq}}``): its
    records off, and each chosen read missing from its output or
    differing from ``reference[i]``."""
    wrong = 0
    for job in jobs:
        wrong += job["records_off"]
        for i, ref in reference.items():
            got = job["chosen"].get(i)
            if got is not None and got != ref:
                wrong += 1
    return wrong
