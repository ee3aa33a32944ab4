"""The comparison that decides `correct`: what the window's optimizations
produced, against the plain reference, each number beside its limit
(limits/<cell>.json).

A cell's traffic mix names its comparison (`check`: `reference`, the
name of a module `reference/<name>.py`, and the parameters it takes).
That module defines `Check(cell, device, params)` with `NAMES` (the
numbers it compares, each worse when larger), `numbers(solve)`,
`best_iou(solve)` and `work()` (the work the geometry sets, which the
per-layer metrics' readers count from). The harness takes the worst of
each number over the optimizations compared: every one of the window,
or a sample of `sample` of them drawn from the run's seed where the
traffic asks for one.
"""
from __future__ import annotations

import importlib.util
import os

import numpy as np


def load_reference(bench_dir, name):
    """The module reference/<name>.py of the benchmark at bench_dir."""
    path = os.path.join(bench_dir, "reference", name + ".py")
    spec = importlib.util.spec_from_file_location(
        f"perfbench.reference.{name.replace('-', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Checker:
    """A cell's comparison: its reference module's Check, its limits."""

    def __init__(self, cell, device):
        spec = dict(cell.traffic["check"])
        mod = load_reference(cell.bench_dir, spec.pop("reference"))
        self.sample = spec.pop("sample", None)
        self.impl = mod.Check(cell, device, spec)
        self.names = tuple(self.impl.NAMES)
        self.limits = cell.limits
        missing = set(self.names) - set(self.limits)
        if missing:
            raise KeyError(f"limits/{cell.name}.json has no limit for "
                           f"{sorted(missing)}")

    def chosen(self, solves, rng):
        """The indices of the optimizations compared."""
        n = len(solves)
        if self.sample is None or n <= self.sample:
            return list(range(n))
        return sorted(int(i) for i in rng.choice(n, self.sample,
                                                 replace=False))

    def numbers(self, s):
        return self.impl.numbers(s)

    def best_iou(self, s):
        return self.impl.best_iou(s)

    def work(self):
        return self.impl.work()

    def run(self, solves, rng):
        """(correct, {name: {"value", "limit"}}, indices compared)."""
        idx = self.chosen(solves, rng)
        worst = {k: 0.0 for k in self.names}
        for i in idx:
            for k, v in self.numbers(solves[i]).items():
                worst[k] = max(worst[k], float(v) if np.isfinite(v)
                               else np.inf)
        checks = {k: {"value": worst[k], "limit": self.limits[k]}
                  for k in self.names}
        ok = bool(idx) and all(c["value"] <= c["limit"]
                               for c in checks.values())
        return ok, checks, idx
