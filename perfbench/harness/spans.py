"""Reading the program's spans (drtvam_tpu_torch/utils/spans.py) in a
torch.profiler Chrome trace.

A span is a `user_annotation` event: the `record_function` range the
program enters while a profiler records. Each device operation is tied
to its launch (the `cuda_runtime` or `cuda_driver` event with the same
`args.correlation`), and the launch to the spans open around it on its
thread, at any depth. A launch on a thread with no span open (the
autograd engine runs a backward's kernels on a device thread of its own)
takes the spans open on the process's other threads at that time: the
program opens its spans on one thread. An idle gap of the device goes
to the innermost span open then on the thread with the most spans.
"""
from __future__ import annotations

import bisect
from collections import defaultdict

from . import trace as tr

LAUNCH_CATS = ("cuda_runtime", "cuda_driver")


def _segments(spans):
    """[(t0, t1, names)] over one thread's spans [(start, end, name)]:
    the names of the spans open in each interval, outermost first. A
    span is clipped to its parent (the trace rounds to 1 ns)."""
    segs, stack, cur = [], [], 0.0

    def emit(t):
        nonlocal cur
        if stack and t > cur:
            segs.append((cur, t, tuple(n for n, _ in stack)))
        cur = t

    for s, e, name in sorted(spans, key=lambda x: (x[0], -x[1])):
        while stack and stack[-1][1] <= s:
            emit(stack[-1][1])
            stack.pop()
        emit(s)
        stack.append((name, min(e, stack[-1][1]) if stack else e))
    while stack:
        emit(stack[-1][1])
        stack.pop()
    return segs


class Spans:
    """The spans of a trace's events, by thread, for lookups by time."""

    def __init__(self, events):
        by_thread = defaultdict(list)
        for e in events:
            if e.get("cat") == "user_annotation":
                s = float(e["ts"])
                by_thread[(e.get("pid"), e.get("tid"))].append(
                    (s, s + float(e["dur"]), e["name"]))
        self.names = {n for v in by_thread.values() for _, _, n in v}
        self.threads = {}
        for key, spans in by_thread.items():
            segs = _segments(spans)
            self.threads[key] = ([s[0] for s in segs], segs, len(spans))

    def _at(self, key, t):
        starts, segs, _ = self.threads.get(key, ((), (), 0))
        i = bisect.bisect_right(starts, t) - 1
        if i >= 0 and t <= segs[i][1]:
            return segs[i][2]
        return ()

    def open_at(self, pid, tid, t):
        """The names of the spans open around a launch at t on (pid,
        tid), outermost first; those of the process's other threads
        where none is open on its own."""
        names = self._at((pid, tid), t)
        if names:
            return names
        for key in self.threads:
            if key[0] == pid:
                other = self._at(key, t)
                if len(other) > len(names):
                    names = other
        return names

    def main_thread(self):
        """The thread with the most spans (the program's), or None."""
        if not self.threads:
            return None
        return max(self.threads, key=lambda k: self.threads[k][2])


def launched_under(events, spans=None):
    """[(device op, names of the spans open at its launch)] for every
    device operation of the trace (names empty where its launch is not
    in the trace or no span was open)."""
    spans = Spans(events) if spans is None else spans
    by_corr = {}
    for e in events:
        corr = e.get("args", {}).get("correlation")
        if e.get("cat") in LAUNCH_CATS and corr is not None:
            by_corr[corr] = spans.open_at(e.get("pid"), e.get("tid"),
                                          float(e["ts"]))
    return [(e, by_corr.get(e.get("args", {}).get("correlation"), ()))
            for e in tr.device_ops(events)]


def device_us_under(events, name):
    """Device microseconds of the operations launched inside a span
    called `name`, at any depth; None where the trace has no such span
    or no device operation."""
    spans = Spans(events)
    if name not in spans.names:
        return None
    ops = launched_under(events, spans)
    if not ops:
        return None
    return sum(float(e["dur"]) for e, names in ops if name in names)


def device_us_by_leaf(events):
    """{innermost span at launch (None: none): device microseconds}."""
    out = defaultdict(float)
    for e, names in launched_under(events):
        out[names[-1] if names else None] += float(e["dur"])
    return dict(out)


def idle_by_span(events, window=None):
    """{innermost span (None: none): idle microseconds} over the idle
    gaps of `trace.summarize(events, window)`, each gap split where the
    innermost span of the main thread changes."""
    gaps = tr.summarize(events, window)["gaps"]
    spans = Spans(events)
    key = spans.main_thread()
    segs = spans.threads[key][1] if key is not None else []
    ends = [s[1] for s in segs]
    out = defaultdict(float)
    for g0, g1 in gaps:
        covered = 0.0
        i = bisect.bisect_right(ends, g0)
        while i < len(segs) and segs[i][0] < g1:
            s0, s1, names = segs[i]
            d = min(s1, g1) - max(s0, g0)
            if d > 0:
                out[names[-1]] += d
                covered += d
            i += 1
        if g1 - g0 > covered:
            out[None] += g1 - g0 - covered
    return dict(out)


def ms_per_step(loop, name):
    """Device milliseconds a step of the operations launched inside
    `name` spans in the program's loop trace (the Context's `loop`);
    None where there is none to read."""
    if loop is None or loop["solve"].steps == 0:
        return None
    us = device_us_under(loop["events"], name)
    return None if us is None else 1e-3 * us / loop["solve"].steps
