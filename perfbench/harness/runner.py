"""One run of one cell: set-up, the measured window of whole
optimizations, the traced optimizations, and the comparison with the
plain reference.

The window calls the program's own entry,
`drtvam_tpu_torch.opt.optimize.optimize(config, device=..., timings=t)`,
on the cell's configuration merged with its traffic mix and a phantom
drawn from the seed, into a fresh directory under TMPDIR. An
optimization is timed by the host's clock around the call, less
`t["artifacts_s"]`: every phase before the artifacts ends in a device
synchronize and the final render returns a host array, so the card is
done when the artifacts begin. The harness reads `timing.npy`,
`loss.npy`, `target.npy` and `patterns.npz` and deletes the directory
before the next optimization.
"""
from __future__ import annotations

import contextlib
import gc
import json
import os
import shutil
import sys
import tempfile
import time
import traceback

import numpy as np

from . import guard, phantom
from . import trace as tr

# the optimize() phases in their order, for naming idle gaps
PHASES = ("scene_s", "cull_s", "precompute_s", "loop_s", "final_render_s")


def log(obj):
    print(json.dumps(obj), file=sys.stderr, flush=True)


class Solve:
    """What one optimization left: its timings and what the comparison
    needs (the final dose, the film's target, the patterns, the loss)."""

    def __init__(self, pose, wall, timings, out, vol):
        self.pose = pose
        self.wall = wall
        self.timings = dict(timings)
        self.solve_s = wall - timings["artifacts_s"]
        tim = np.load(os.path.join(out, "timing.npy"))
        self.steps = int(np.count_nonzero(np.any(tim != 0.0, axis=1)))
        self.loss = np.load(os.path.join(out, "loss.npy"))
        self.target = np.load(os.path.join(out, "target.npy"))
        with np.load(os.path.join(out, "patterns.npz")) as z:
            self.patterns = z["patterns"]
        self.vol = np.asarray(vol, np.float32)
        self.finite = bool(np.isfinite(self.vol).all())


class Runner:
    """A cell's program configuration, its phantom draws and its calls
    into the program, on one device; set up once, then any number of
    measured windows (`window`)."""

    def __init__(self, cell, device, workdir):
        self.cell = cell
        self.device = device
        self.workdir = workdir
        self.base = cell.program_config()
        self.env = dict(cell.traffic.get("env", {}))
        from drtvam_tpu_torch.opt.optimize import optimize
        self._optimize = optimize
        self._n = 0

    def solve(self, pose, n_steps=None, profile=None, wrap=None):
        """One optimization of `pose`; returns a Solve."""
        self._n += 1
        d = os.path.join(self.workdir, f"solve{self._n}")
        os.makedirs(d)
        try:
            ply = os.path.join(d, "target.ply")
            phantom.write_ply(pose, ply)
            cfg = json.loads(json.dumps(self.base))
            cfg["target"] = dict(cfg.get("target", {}), filename=ply)
            cfg["output"] = os.path.join(d, "out")
            if n_steps is not None:
                cfg["n_steps"] = n_steps
            if profile is not None:
                cfg["profile"] = profile
            t = {}
            saved = {k: os.environ.get(k) for k in self.env}
            os.environ.update(self.env)
            try:
                with (wrap or contextlib.nullcontext)():
                    t0 = time.perf_counter()
                    vol = self._optimize(cfg, device=self.device, timings=t)
                    wall = time.perf_counter() - t0
            finally:
                for k, v in saved.items():
                    if v is None:
                        os.environ.pop(k, None)
                    else:
                        os.environ[k] = v
            return Solve(pose, wall, t, cfg["output"], vol)
        finally:
            shutil.rmtree(d, ignore_errors=True)

    def warm_up(self, rng):
        """One optimization of the cell's own configuration cut to the
        traffic's `warmup_steps`: every kernel, library and shape the
        window uses, loaded and run once."""
        pose = phantom.make_pose(self.cell.config["phantom"], rng)
        self.solve(pose, n_steps=int(self.cell.traffic["warmup_steps"]))

    def window(self, rng, seconds):
        """Whole optimizations back to back until `seconds` have passed
        (the one in flight finished and counted). Returns (solves,
        attempted, failed, window seconds)."""
        spec = self.cell.config["phantom"]
        solves, attempted, failed = [], 0, 0
        t_w = time.perf_counter()
        while attempted == 0 or time.perf_counter() - t_w < seconds:
            pose = phantom.make_pose(spec, rng)
            attempted += 1
            try:
                s = self.solve(pose)
            except Exception:       # a failed optimization is counted
                traceback.print_exc(file=sys.stderr)
                failed += 1
                continue
            if not s.finite:
                failed += 1
            solves.append(s)
        return solves, attempted, failed, time.perf_counter() - t_w

    def traced(self, rng):
        """Two more optimizations: one with the program's own `profile`
        trace of its loop, one under the harness's torch.profiler, cut
        where its artifacts begin. Returns (loop, solve) dicts."""
        import torch
        from torch.profiler import ProfilerActivity, profile, record_function
        spec = self.cell.config["phantom"]
        loop_dir = os.path.join(self.workdir, "looptrace")
        s_loop = self.solve(phantom.make_pose(spec, rng), profile=loop_dir)
        ev = tr.load(tr.trace_file(loop_dir))
        shutil.rmtree(loop_dir, ignore_errors=True)
        loop = {"events": ev, "summary": tr.summarize(ev), "solve": s_loop}

        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
        prof = profile(activities=acts)

        @contextlib.contextmanager
        def wrap():
            with prof, record_function("perfbench.solve"):
                yield

        s_solve = self.solve(phantom.make_pose(spec, rng), wrap=wrap)
        path = os.path.join(self.workdir, "solve.pt.trace.json")
        prof.export_chrome_trace(path)
        ev = tr.load(path)
        os.unlink(path)
        mark = [e for e in ev if e["name"] == "perfbench.solve"
                and e.get("cat") == "user_annotation"]
        t0 = float(mark[0]["ts"]) if mark else min(float(e["ts"])
                                                   for e in ev)
        t1 = t0 + 1e6 * s_solve.solve_s
        summ = tr.summarize(ev, (t0, t1))
        return loop, {"events": ev, "summary": summ, "solve": s_solve,
                      "t0": t0}


def breakdown(solve_trace):
    """The traced optimization's device operations with the most time and
    its longest idle gaps, each named by the optimize() phase it falls in
    and the host operator the trace shows there."""
    summ, s = solve_trace["summary"], solve_trace["solve"]
    ops = sorted(summ["by_name"].items(), key=lambda kv: -kv[1][1])[:10]
    edges, acc = [], 0.0
    for p in PHASES:
        acc += s.timings.get(p, 0.0)
        edges.append((acc, p))
    gaps = sorted(summ["gaps"], key=lambda g: g[0] - g[1])[:10]
    named = []

    def phase(t):
        off = (t - solve_trace["t0"]) * 1e-6
        return next((p[:-2] for e, p in edges if off <= e), "after")

    for g0, g1 in gaps:
        p0, p1 = phase(g0), phase(g1)
        op = tr.host_op_at(solve_trace["events"], 0.5 * (g0 + g1))
        named.append([(p0 if p0 == p1 else f"{p0}..{p1}") +
                      (f": {op}" if op else ""), (g1 - g0) * 1e-6])
    return {"device_ops": [[n, v[1] * 1e-6] for n, v in ops],
            "idle_gaps": named}


def workdir():
    return tempfile.mkdtemp(prefix="perfbench-")


def check_clean():
    """Exit (code 3, no result) if JAX or the JAX package is loaded."""
    found = guard.jax_modules()
    if found:
        print(f"perfbench: the process holds {sorted(found)}; the "
              "benchmark runs the PyTorch port alone", file=sys.stderr)
        sys.exit(3)


def release():
    gc.collect()
    try:
        import torch
        if torch.cuda.is_available():
            torch.cuda.empty_cache()
    except ImportError:
        pass


class Context:
    """What a per-layer metric's reader (metrics/<name>.py) may read:
    the window's optimizations (`solves`), the program's loop trace
    (`loop`: its events, summary and optimization), the harness's trace
    of a whole optimization (`solve_trace`), the work the geometry sets
    (`work`, from the cell's reference: taps, A, Zf, U, Y, X) and the
    cell."""

    def __init__(self, cell, solves, loop, solve_trace, work):
        self.cell, self.solves = cell, solves
        self.loop, self.solve_trace, self.work = loop, solve_trace, work

    def mean_timing(self, key):
        vals = [s.timings[key] for s in self.solves if key in s.timings]
        return float(np.mean(vals)) if vals else None


def end_to_end(solves, ious, setup_s):
    steps = sum(s.steps for s in solves)
    loop = sum(s.timings["loop_s"] for s in solves)
    return {"solve_s": float(np.mean([s.solve_s for s in solves])),
            "step_ms": 1e3 * loop / steps if steps else None,
            "best_iou": float(np.mean(ious)),
            "setup_s": setup_s}


def run(cell, seed, seconds, trace, device, t_start):
    """Set up, measure, trace and check one run; returns the result
    object (without printing it)."""
    import torch
    from .check import Checker
    cuda = torch.device(device).type == "cuda"
    rng = np.random.default_rng(seed)
    wd = workdir()
    try:
        r = Runner(cell, device, wd)
        r.warm_up(rng)
        setup_s = time.perf_counter() - t_start
        solves, attempted, failed, window_s = r.window(rng, seconds)
        check_clean()
        peak = int(torch.cuda.max_memory_allocated()) if cuda else 0
        loop = solve_tr = None
        if trace:
            loop, solve_tr = r.traced(rng)
        del r
        release()
        checker = Checker(cell, device)
        ok, checks, compared = checker.run(solves, rng)
        ok = ok and failed == 0
        ious = []
        for i, s in enumerate(solves):
            ious.append(checker.best_iou(s))
            log({"solve": i, "pose_deg": float(np.rad2deg(s.pose.angle)),
                 "hole_x": s.pose.hole_x, "steps": s.steps,
                 "solve_s": s.solve_s, "wall_s": s.wall,
                 "timings": s.timings, "best_iou": ious[-1],
                 "iou_met_0.98": ious[-1] >= 0.98,
                 "compared": i in compared})
        log({"window_s": window_s, "attempted": attempted,
             "failed": failed})
        work = checker.work()
        del checker
        release()
        units = {m["name"]: m["unit"] for m in cell.end_to_end +
                 cell.per_layer}
        metrics = {}
        if not trace:
            vals = end_to_end(solves, ious, setup_s) if solves else {}
            for m in cell.end_to_end:
                v = vals.get(m["name"])
                if v is not None:
                    metrics[m["name"]] = {"value": v, "unit": units[m["name"]]}
        else:
            ctx = Context(cell, solves, loop, solve_tr, work)
            for m in cell.per_layer:
                v = cell.metric_reader(m["name"])(ctx)
                if v is not None:
                    metrics[m["name"]] = {"value": float(v),
                                          "unit": units[m["name"]]}
        dev = {"platform": "gpu" if cuda else "cpu",
               "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
               "count": cell.chips, "memory_peak_bytes": peak}
        res = {"correct": ok, "attempted": attempted, "failed": failed,
               "metrics": metrics, "device": dev}
        if trace:
            summ = solve_tr["summary"]
            dev["busy_s"] = summ["busy_us"] * 1e-6
            dev["window_s"] = summ["window_us"] * 1e-6
            res["breakdown"] = breakdown(solve_tr)
        res["checks"] = checks
        for k, c in checks.items():
            print(f"check {k}: {c['value']!r} (limit {c['limit']!r})",
                  file=sys.stderr)
        sys.stderr.flush()
        return res
    finally:
        shutil.rmtree(wd, ignore_errors=True)
