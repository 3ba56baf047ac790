"""Seconds a job of the program's ``write`` stage (``runtime.run_correction``
writing the corrected FASTA, ``io/fasta.py``), mean over the window's
jobs."""

from portbench.readings import per_job


def read(run):
    return per_job(run, lambda j: j["stages"].get("write"))
