"""In-product stage timing and an optional trace of the run (the port of
``br_tpu.profiling``).

Every pipeline stage (``build-set``, ``correct``, ``write``) is timed
into a process-wide registry, with a debug breadcrumb per call and a
``-v`` report at the end; each stage is also a ``torch.profiler``
range.  ``--trace DIR`` wraps the run in ``torch.profiler.profile`` and
writes one Chrome trace, ``DIR/TRACE_FILE`` (open it in Perfetto or
``chrome://tracing``): the host's torch ops and stage ranges, and with
the card the CUDA kernels, the port's own included.
"""

from __future__ import annotations

import contextlib
import logging
import os
import time
from collections import defaultdict

import torch

log = logging.getLogger("br_tpu_torch")

#: the Chrome trace's file name inside the ``--trace`` directory
TRACE_FILE = "br_tpu_torch_trace.json"

_STAGES: dict = defaultdict(lambda: [0, 0.0])  # name -> [calls, seconds]


@contextlib.contextmanager
def stage(name: str):
    """Time a pipeline stage (a profiler range of the same name);
    accumulate and emit a debug breadcrumb.  Once CUDA is initialised the
    stage ends with a synchronise, so its time is the device's work and
    not the enqueue of it."""
    t0 = time.perf_counter()
    try:
        with torch.profiler.record_function(name):
            yield
            if torch.cuda.is_initialized():
                torch.cuda.synchronize()
    finally:
        dt = time.perf_counter() - t0
        s = _STAGES[name]
        s[0] += 1
        s[1] += dt
        log.debug("stage %s: %.3fs (total %.3fs over %d calls)",
                  name, dt, s[1], s[0])


def stage_totals() -> dict:
    """{name: (calls, seconds)} accumulated so far."""
    return {k: tuple(v) for k, v in _STAGES.items()}


def reset_stages() -> None:
    _STAGES.clear()


def report(level=logging.INFO) -> None:
    """Log one summary line per stage (the -v run report)."""
    for name, (calls, secs) in sorted(_STAGES.items(),
                                      key=lambda kv: -kv[1][1]):
        log.log(level, "stage %-18s %8.3fs  %6d calls", name, secs, calls)


@contextlib.contextmanager
def device_trace(trace_dir: str | None, cuda: bool = False):
    """A ``torch.profiler`` trace of the whole run, written to
    ``trace_dir/TRACE_FILE``, when a directory is given: the CPU activity,
    and the CUDA activity too where the run uses the card (``cuda``)."""
    if not trace_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if cuda:
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(trace_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    path = os.path.join(trace_dir, TRACE_FILE)
    prof.export_chrome_trace(path)
    log.info("device trace written to %s", path)
