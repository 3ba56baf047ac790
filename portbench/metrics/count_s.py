"""Seconds a job of the program's ``build-set`` stage (``cli.build_set``:
the FASTA read, the packing and K8 on the card), mean over the window's
jobs."""

from portbench.readings import per_job


def read(run):
    return per_job(run, lambda j: j["stages"].get("build-set"))
