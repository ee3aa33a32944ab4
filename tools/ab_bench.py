#!/usr/bin/env python3
"""Ballistic bench phases of two trees on one card, in turns.

    python3 tools/ab_bench.py PARENT_ROOT

run from the root of the changed tree, on a machine with one NVIDIA GPU.
PARENT_ROOT is an unpacked copy of the parent commit (`git archive`).
Each turn (parent, change, change, parent) is a fresh process that
builds that tree's backprojection kernels and runs its chip_smoke.py
phases 4 and 5 (optimize() on the bench scene, cylindrical and
index-matched vials); every JSON record it prints is tagged with the
turn. Compares two versions only within one call, as timings move
from card to card.
"""
import json
import os
import subprocess
import sys

BENCH = """
import os, sys, tempfile
sys.path.insert(0, os.getcwd())
import torch
import chip_smoke as cs
from drtvam_tpu_torch.ops import backproject as bp
dev = torch.device("cuda:0")
bp.build_kernels()
torch.zeros(1, device=dev)  # create the context before the memory stats
with tempfile.TemporaryDirectory() as tmp:
    cs.phase_bench(torch, bp, dev, tmp, "cylindrical", ("bp_fwd", "bp_bwd"))
    torch.cuda.empty_cache()
    cs.phase_bench(torch, bp, dev, tmp, "index_matched",
                   ("bp_fwd_band", "bp_bwd_band"))
"""


def main():
    if len(sys.argv) != 2:
        sys.exit(__doc__)
    trees = {"parent": os.path.abspath(sys.argv[1]), "change": os.getcwd()}
    smi = subprocess.run(["nvidia-smi", "-i", "0",
                          "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    print(smi.stdout.strip(), flush=True)
    for turn, tree in enumerate(("parent", "change", "change", "parent")):
        out = subprocess.run([sys.executable, "-c", BENCH],
                             cwd=trees[tree], capture_output=True, text=True,
                             timeout=900)
        if out.returncode != 0:
            sys.exit(f"{tree} (turn {turn}) failed:\n{out.stderr[-4000:]}")
        for line in out.stdout.splitlines():
            if line.startswith('{"phase"'):
                rec = json.loads(line)
                print(json.dumps({"turn": turn, "tree": tree, **rec}),
                      flush=True)


if __name__ == "__main__":
    main()
