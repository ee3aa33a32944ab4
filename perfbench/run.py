"""One run of one cell of the benchmark of drtvam_tpu_torch.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Set-up (imports, the program's libraries, one warm-up optimization of
the cell cut to a few steps), then whole optimizations back to back for
`--seconds` seconds, then (with --trace 1) two traced optimizations,
then the comparison with the plain reference. The last line of standard
output is one JSON object: correct, attempted, failed, metrics (the
cell's end-to-end metrics, or with --trace 1 its per-layer ones),
device, with --trace 1 breakdown, and last the compared numbers beside
their limits (`checks`), which also end standard error.

It needs as many CUDA devices as the cell asks for, and exits with a
non-zero code and no result without them, or when JAX or the JAX
package is loaded. Build caches stay inside the checkout.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CACHE = os.path.join(ROOT, ".bench_cache")
os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(CACHE, "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = os.path.join(CACHE, "triton")
sys.path.insert(0, ROOT)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from perfbench.harness.manifest import Cell
    from perfbench.harness import runner
    cell = Cell(args.workload, ROOT)

    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"perfbench: {args.workload} needs {cell.chips} CUDA "
              f"device(s); this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    res = runner.run(cell, args.seed, args.seconds, bool(args.trace),
                     "cuda", T_START)
    runner.check_clean()
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
