"""Seconds a job in the native host engine: the harness's span around
every ``Torch3Corrector._oracle_correct_many`` call (the corrector's and
its wide sibling's), mean over the window's jobs; nothing where a job
sent reads to the host and the span saw no call."""

from portbench.readings import per_job


def read(run):
    return per_job(run, lambda j: j["spans"].get("host_engine"))
