"""Spans and counters of one optimization, in its `timings` and in a
torch.profiler trace.

`optimize()` makes its `timings` dict the active recorder for the length
of the call (`recording`). Inside it, `with span("fan"):` adds the host
seconds of its block to `timings["fan_s"]`, and `count("fan_builds")`
adds to `timings["fan_builds"]`. A span made with `timed=False` (the
loop's step and everything in it, and the renders, whose device work is
still in flight when the block ends) records no seconds. While a
torch.profiler records, a span also enters `record_function(name)`, so
it lies in the same Chrome trace as the kernels its block launches, on
their clock; otherwise it enters nothing. Outside a recorder a span
only marks the trace, and a counter does nothing.
"""
from __future__ import annotations

import contextlib
import contextvars
import time

import torch
from torch.autograd.profiler import record_function

_active = contextvars.ContextVar("drtvam_timings", default=None)


@contextlib.contextmanager
def recording(timings):
    """Make `timings` (a dict) the recorder of the spans and counters
    opened in the block."""
    token = _active.set(timings)
    try:
        yield timings
    finally:
        _active.reset(token)


class span(contextlib.ContextDecorator):
    """A named block: its host seconds added to the recorder's
    `<name>_s` (unless timed is False), and a `record_function` range
    while a profiler records. As a decorator, each call is a block."""

    def __init__(self, name, timed=True):
        self.name, self.timed = name, timed

    def _recreate_cm(self):
        return span(self.name, self.timed)

    def __enter__(self):
        self._rf = None
        if torch.autograd._profiler_enabled():
            self._rf = record_function(self.name)
            self._rf.__enter__()
        if self.timed:
            self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if self.timed:
            rec = _active.get()
            if rec is not None:
                key = self.name + "_s"
                rec[key] = rec.get(key, 0.0) + time.perf_counter() - self._t0
        if self._rf is not None:
            self._rf.__exit__(*exc)
        return False


def count(name, n=1):
    """Add n to the recorder's `name`."""
    rec = _active.get()
    if rec is not None:
        rec[name] = rec.get(name, 0) + n
