"""Reading a ``torch.profiler`` Chrome trace of one job.

The harness wraps the traced job in a ``portbench.job`` range; the
window is that range.  Device events are the complete events (``"ph":
"X"``) of the categories ``kernel``, ``gpu_memcpy`` and ``gpu_memset``;
host ranges are ``user_annotation`` events (``record_function``: the
program's stages ``build-set``, ``correct``, ``write`` and the harness's
own ``portbench.*`` spans) and ``cpu_op`` events (torch operators).
Times are in microseconds, as the trace writes them.
"""

from __future__ import annotations

import bisect
import json

JOB = "portbench.job"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def load(path: str) -> list:
    """The trace's events."""
    with open(path) as fh:
        data = json.load(fh)
    return data["traceEvents"] if isinstance(data, dict) else data


def _complete(events, cats):
    return [e for e in events if e.get("ph") == "X" and e.get("cat") in cats]


def ranges(events, name: str) -> list:
    """(start, end) of every host range named ``name``."""
    return [(e["ts"], e["ts"] + e["dur"])
            for e in _complete(events, ("user_annotation",))
            if e["name"] == name]


def window(events):
    """(start, end) of the traced job, or None."""
    r = ranges(events, JOB)
    return r[0] if r else None


def device_events(events, cats=DEVICE_CATS) -> list:
    return _complete(events, cats)


def union(intervals) -> list:
    """Sorted disjoint intervals covering ``intervals``."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def covered(intervals, within) -> float:
    """Length of the union of ``intervals`` inside the union of
    ``within``."""
    a, b = union(intervals), union(within)
    total, j = 0.0, 0
    for s, e in a:
        while j < len(b) and b[j][1] <= s:
            j += 1
        m = j
        while m < len(b) and b[m][0] < e:
            total += max(0.0, min(e, b[m][1]) - max(s, b[m][0]))
            m += 1
    return total


def busy_us(events, within=None) -> float:
    """Microseconds in which a device operation ran, inside ``within``
    (the job's window by default)."""
    if within is None:
        w = window(events)
        if w is None:
            return 0.0
        within = [w]
    return covered([(e["ts"], e["ts"] + e["dur"])
                    for e in device_events(events)], within)


def kernel_ms(events, stage: str | None = None):
    """Milliseconds of device time of the kernel events that start inside
    the traced job (and, with ``stage``, inside one of its host ranges of
    that name), summed; None where there is no job or no such kernel."""
    w = window(events) if events else None
    if w is None:
        return None
    within = [w] if stage is None else ranges(events, stage)
    ks = [e for e in device_events(events, ("kernel",))
          if any(s <= e["ts"] < t for s, t in within)]
    return sum(e["dur"] for e in ks) / 1e3 if ks else None


def short_name(name: str, n: int = 80) -> str:
    """A device operation's name without its argument list."""
    return name.split("(")[0][:n]


def device_ops(events, top: int = 10) -> list:
    """[[name, seconds]] of the device operations that took most time in
    the window, summed by name."""
    w = window(events)
    sums: dict = {}
    for e in device_events(events):
        if w is None or w[0] <= e["ts"] < w[1]:
            key = short_name(e["name"])
            sums[key] = sums.get(key, 0.0) + e["dur"] / 1e6
    return sorted(([k, v] for k, v in sums.items()),
                  key=lambda kv: -kv[1])[:top]


def idle_gaps(events, top: int = 10) -> list:
    """[[host activity, seconds]]: the window's time in which no device
    operation ran, summed by what the host was doing at each gap's
    middle (the nested host ranges, outermost first, and the innermost
    torch operator, if any), the largest first."""
    w = window(events)
    if w is None:
        return []
    busy = union((e["ts"], e["ts"] + e["dur"]) for e in device_events(events)
                 if e["ts"] < w[1] and e["ts"] + e["dur"] > w[0])
    gaps, t = [], w[0]
    for s, e in busy:
        if s > t:
            gaps.append((t, min(s, w[1])))
        t = max(t, e)
    if t < w[1]:
        gaps.append((t, w[1]))
    ann = [e for e in _complete(events, ("user_annotation",))
           if e["name"] != JOB]
    ops = sorted(_complete(events, ("cpu_op",)), key=lambda o: o["ts"])
    starts = [o["ts"] for o in ops]
    sums: dict = {}
    for s, e in gaps:
        mid = (s + e) / 2
        inside = sorted((a for a in ann if a["ts"] <= mid < a["ts"] + a["dur"]),
                        key=lambda a: (a["ts"], -a["dur"]))
        label = " > ".join(a["name"] for a in inside) or "host"
        # the innermost operator: the latest started that has not ended
        for o in reversed(ops[max(0, bisect.bisect_right(starts, mid) - 64):
                              bisect.bisect_right(starts, mid)]):
            if mid < o["ts"] + o["dur"]:
                label += " > " + o["name"]
                break
        sums[label] = sums.get(label, 0.0) + (e - s) / 1e6
    return sorted(([k, v] for k, v in sums.items()),
                  key=lambda kv: -kv[1])[:top]
