"""GiB: the peak of ``torch.cuda.max_memory_allocated()`` over the window
and the traced job after it (the peak statistics reset at the window's
start)."""


def read(run):
    peak = run["memory"]["peak_bytes"]
    return peak / 2**30 if peak else None
