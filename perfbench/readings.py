"""The readings that a cell's limits are set from: the compared numbers
of sound runs of the program on many seeds (the lower reading) and of
its controls (the upper reading), in one process.

    python3 perfbench/readings.py --workload <cell> --seeds 1,2,3 \
        --control-seeds 4,5,6 --control env:DRTVAM_MATMUL=bf16 \
        [--control config:spp_ref=1 ...]

For each seed it draws the run's poses as `run.py` does (the warm-up's
first, then the window's), optimizes the window's first pose at the
cell's own size and prints one JSON line of its numbers. Each control
runs on every control seed: `env:KEY=VALUE` sets the program's
environment (the program's own bfloat16 operand path,
`DRTVAM_MATMUL=bf16`), `config:a.b=VALUE` a key of the program's
configuration (a JSON value), while the reference keeps the cell's. The
benchmark's runs never run this.
"""
import argparse
import json
import os
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def apply_control(runner, cell, control):
    """Set `control` on the runner; returns a function that undoes it."""
    kind, _, spec = control.partition(":")
    key, _, val = spec.partition("=")
    if kind == "env":
        runner.env[key] = val
    elif kind == "config":
        node = runner.base
        path = key.split(".")
        for k in path[:-1]:
            node = node[k]
        node[path[-1]] = json.loads(val)
    else:
        raise ValueError(f"a control is env:KEY=VALUE or config:a.b=VALUE, "
                         f"not {control!r}")

    def undo():
        runner.env = dict(cell.traffic.get("env", {}))
        runner.base = cell.program_config()
    return undo


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--control", action="append", default=[])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    import numpy as np
    from perfbench.harness import phantom, runner
    from perfbench.harness.check import Checker
    from perfbench.harness.manifest import Cell
    cell = Cell(args.workload, ROOT)
    runs = [("sound", None, int(s)) for s in args.seeds.split(",") if s] + \
        [("control", c, int(s)) for c in args.control
         for s in args.control_seeds.split(",") if s]
    with tempfile.TemporaryDirectory(prefix="perfbench-") as wd:
        r = runner.Runner(cell, args.device, wd)
        r.warm_up(np.random.default_rng(0))
        chk = Checker(cell, args.device)
        for kind, control, seed in runs:
            rng = np.random.default_rng(seed)
            phantom.make_pose(cell.config["phantom"], rng)   # the warm-up's
            undo = apply_control(r, cell, control) if control else None
            t0 = time.perf_counter()
            try:
                s = r.solve(phantom.make_pose(cell.config["phantom"], rng))
            finally:
                if undo:
                    undo()
            t1 = time.perf_counter()
            nums = chk.numbers(s)
            print(json.dumps(dict(kind=kind, control=control, seed=seed,
                                  steps=s.steps, solve_s=s.solve_s,
                                  best_iou=chk.best_iou(s),
                                  wall_s=t1 - t0,
                                  check_s=time.perf_counter() - t1, **nums)),
                  flush=True)
            del s
            runner.release()
    runner.check_clean()


if __name__ == "__main__":
    main()
