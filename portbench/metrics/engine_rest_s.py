"""Seconds a job of the corrector's host glue (``correct/engine3.py``:
planning, packing, the copies, the decode, the wide retry's batch): the
``correct`` stage a job, less the host engine's span a job (both means
over the window's jobs), less the time a device operation ran inside the
traced job's ``correct`` ranges."""

from portbench import trace
from portbench.readings import per_job


def read(run):
    events = run.get("trace")
    correct = per_job(run, lambda j: j["stages"].get("correct"))
    host = per_job(run, lambda j: j["spans"].get("host_engine"))
    if not events or correct is None or host is None:
        return None
    busy = trace.busy_us(events, trace.ranges(events, "correct")) / 1e6
    return correct - host - busy
