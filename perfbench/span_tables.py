"""Where a cell's optimization spends its device time and its idle time,
by the program's spans (drtvam_tpu_torch/utils/spans.py).

    python3 perfbench/span_tables.py --workload <cell> --seed <n>

Set-up as run.py's (one warm-up optimization cut to a few steps), then
run.py's two traced optimizations (`Runner.traced`), read through
harness/spans.py: the loop trace's device milliseconds a step by the
innermost span open at each launch, and the idle seconds of the solve
trace (to its artifacts) by the innermost span open on the host, each
with the share below the phases; the profiled loop's host milliseconds
a step and both traces' idle shares; the two optimizations' timings.
One JSON line. The benchmark's runs never run this.
"""
import argparse
import json
import os
import shutil
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CACHE = os.path.join(ROOT, ".bench_cache")
os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(CACHE, "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = os.path.join(CACHE, "triton")
sys.path.insert(0, ROOT)

# the spans at the phase level, and the harness's own
PHASES = (None, "perfbench.solve", "optimize", "scene", "cull", "loop",
          "final_render", "artifacts")


def _share_below(table, above):
    total = sum(table.values())
    return sum(v for k, v in table.items() if k not in above) / total \
        if total else None


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    import numpy as np
    import torch
    from perfbench.harness import runner, spans
    from perfbench.harness.manifest import Cell
    cell = Cell(args.workload, ROOT)
    rng = np.random.default_rng(args.seed)
    wd = runner.workdir()
    try:
        r = runner.Runner(cell, args.device, wd)
        r.warm_up(rng)
        loop, solve = r.traced(rng)
    finally:
        shutil.rmtree(wd, ignore_errors=True)
    runner.check_clean()

    steps = loop["solve"].steps
    leaf = {str(k): 1e-3 * v / steps for k, v in
            spans.device_us_by_leaf(loop["events"]).items()}
    idle = {str(k): 1e-6 * v for k, v in
            spans.idle_by_span(solve["events"],
                               (solve["summary"]["t0"],
                                solve["summary"]["t1"])).items()}
    ls, ss = loop["summary"], solve["summary"]
    cuda = torch.device(args.device).type == "cuda"
    print(json.dumps({
        "workload": args.workload, "seed": args.seed,
        "device": torch.cuda.get_device_name(0) if cuda else "cpu",
        "loop": {"steps": steps,
                 "step_ms_profiled": 1e3 * loop["solve"].timings["loop_s"]
                 / steps,
                 "idle_pct": 100.0 * (1.0 - ls["busy_us"] / ls["window_us"]),
                 "device_ms_by_leaf": leaf,
                 "leaf_share": _share_below(
                     leaf, {"None", "loop", "step", "optimize"})},
        "solve": {"solve_s": solve["solve"].solve_s,
                  "idle_pct": 100.0 * (1.0 - ss["busy_us"] /
                                       ss["window_us"]),
                  "idle_s_by_span": idle,
                  "below_phase_share": _share_below(
                      idle, {str(p) for p in PHASES})},
        "timings": {"loop": loop["solve"].timings,
                    "solve": solve["solve"].timings}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
