"""Milliseconds of device time of every CUDA kernel event in the traced
job (the sum of their durations): the card's time that one whole job
takes, read from the trace of one more job after the window in every
run."""

from portbench import trace


def read(run):
    return trace.kernel_ms(run.get("trace"))
