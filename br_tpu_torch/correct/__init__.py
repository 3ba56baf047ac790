"""Correction layer of the port: the host oracle (``reference``), the
device pass and its kernels (``probe``, ``sites``, ``splice``,
``reverse``), and the batch driver (``engine3``)."""

from br_tpu_torch.correct.reference import (  # noqa: F401
    One,
    Two,
    Graph,
    Greedy,
    GapSize,
    build_methods,
    correct_read,
)
