"""The device's idle share of the traced job, in %: 100 x (1 - the union
of its device operations (kernels, copies, sets) / the job's length)."""

from portbench import trace


def read(run):
    events = run.get("trace")
    w = trace.window(events) if events else None
    if w is None or w[1] <= w[0]:
        return None
    busy = trace.busy_us(events)
    if busy <= 0:
        return None
    return 100.0 * (1.0 - busy / (w[1] - w[0]))
