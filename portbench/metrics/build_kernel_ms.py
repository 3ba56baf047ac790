"""Milliseconds of device time of the CUDA kernel events that start inside
the traced job's ``build-set`` stage (the solid set's build, K8),
summed."""

from portbench import trace


def read(run):
    return trace.kernel_ms(run.get("trace"), "build-set")
