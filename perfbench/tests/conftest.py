"""Shared fixtures of the benchmark's own tests: a copy of the benchmark's
files with every configuration cut to a size a CPU test can run."""
import json
import os
import shutil
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

# 24 angles, a 40 x 40 DMD at 0.25 mm, a 32 x 32 x 16 film; the final
# render's samples and the scattering reference's paths cut with it
TINY = {"projector": dict(n_patterns=24, resx=40, resy=40, pixel_size=0.25),
        "film": dict(resx=32, resy=32, resz=16),
        "optimize": dict(spp_ref=4),
        "check": dict(photons=1 << 18)}
# the limits of the scattering cell at this size, set as on the chip
# from the CPU's readings (perfbench/readings.py on this root: sound
# seeds 11, 12, the albedo and spp_ref controls on seed 13)
TINY_LIMITS = {"benchy-sq-scatter.hybrid-sa-radon": {
    "residual_sum_gap": 0.012, "block_gap": 0.005, "residual_noise": 0.016,
    "residual_peak": 0.07, "final_loss_ratio": 0.025}}


def make_tiny_root(dst):
    """A root holding BENCHMARK.json and perfbench/ with the
    configurations and the scattering reference cut to TINY."""
    shutil.copytree(os.path.join(ROOT, "perfbench"),
                    os.path.join(dst, "perfbench"),
                    ignore=shutil.ignore_patterns("tests", "__pycache__"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), dst)
    cdir = os.path.join(dst, "perfbench", "configs")
    for name in os.listdir(cdir):
        p = os.path.join(cdir, name)
        with open(p) as f:
            cfg = json.load(f)
        cfg["projector"].update(TINY["projector"])
        cfg["sensor"]["film"].update(TINY["film"])
        with open(p, "w") as f:
            json.dump(cfg, f)
    tdir = os.path.join(dst, "perfbench", "traffic")
    for name in os.listdir(tdir):
        p = os.path.join(tdir, name)
        with open(p) as f:
            traffic = json.load(f)
        if "photons" in traffic["check"]:
            traffic["check"].update(TINY["check"])
            traffic["optimize"].update(TINY["optimize"])
        with open(p, "w") as f:
            json.dump(traffic, f)
    for cell, lim in TINY_LIMITS.items():
        p = os.path.join(dst, "perfbench", "limits", cell + ".json")
        with open(p) as f:
            limits = json.load(f)
        limits.update(lim)
        with open(p, "w") as f:
            json.dump(limits, f)
    return str(dst)


@pytest.fixture
def tiny_root(tmp_path):
    return make_tiny_root(tmp_path / "root")


@pytest.fixture
def cuda_device():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: run on the chip with "
                    "python -m pytest -q perfbench/tests")
    return "cuda"
