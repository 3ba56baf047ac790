"""Milliseconds of device time of the CUDA kernel events that start inside
the traced job's ``correct`` stage (the passes K1-K7, K3, K4, K11 and the
wide retry's), summed."""

from portbench import trace


def read(run):
    return trace.kernel_ms(run.get("trace"), "correct")
