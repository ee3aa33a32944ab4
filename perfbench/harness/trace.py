"""Reading a torch.profiler Chrome trace (`*.pt.trace.json`).

The arithmetic of the port's chip_smoke.py `trace_summary`, copied and
widened: the window runs from the first event's start to the last
event's end (or is given), the device is busy over the union of the
intervals in which an operation ran on it (kernels, and also copies and
fills, which chip_smoke.py leaves out), and the kernels are summed by
name. `gaps` lists the idle intervals between them.
"""
from __future__ import annotations

import json
import os

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def trace_file(trace_dir):
    files = [f for f in os.listdir(trace_dir) if f.endswith(".pt.trace.json")]
    if len(files) != 1:
        raise RuntimeError(f"{len(files)} traces in {trace_dir}")
    return os.path.join(trace_dir, files[0])


def load(path):
    """The complete ('X') events of a trace file."""
    with open(path) as f:
        return [e for e in json.load(f)["traceEvents"]
                if e.get("ph") == "X" and "dur" in e]


def device_ops(events):
    return [e for e in events if e.get("cat") in DEVICE_CATS]


def _merged(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def summarize(events, window=None):
    """Window (t0, t1) in trace microseconds (default: all events), the
    device's busy microseconds in it, the device operations by name
    ({name: [count, us]}, clipped to the window) and the idle gaps
    [(start, end)]."""
    if window is None:
        t0 = min(float(e["ts"]) for e in events)
        t1 = max(float(e["ts"]) + float(e["dur"]) for e in events)
    else:
        t0, t1 = window
    ivs, by_name = [], {}
    for e in device_ops(events):
        s = max(float(e["ts"]), t0)
        d = min(float(e["ts"]) + float(e["dur"]), t1)
        if d <= s:
            continue
        ivs.append((s, d))
        k = by_name.setdefault(e["name"], [0, 0.0])
        k[0] += 1
        k[1] += d - s
    merged = _merged(ivs)
    busy = sum(e - s for s, e in merged)
    gaps, end = [], t0
    for s, e in merged:
        if s > end:
            gaps.append((end, s))
        end = max(end, e)
    if t1 > end:
        gaps.append((end, t1))
    return {"t0": t0, "t1": t1, "window_us": t1 - t0, "busy_us": busy,
            "by_name": by_name, "gaps": gaps}


def host_op_at(events, t):
    """The outermost host operator running at trace time t, or None."""
    best = None
    for e in events:
        if e.get("cat") not in ("cpu_op", "python_function"):
            continue
        s = float(e["ts"])
        if s <= t <= s + float(e["dur"]):
            if best is None or float(e["dur"]) > float(best["dur"]):
                best = e
    return None if best is None else best["name"]
