#!/usr/bin/env python3
"""Smoke run of drtvam_tpu_torch on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (each failure exits non-zero before the result line):
  1. device: a CUDA device must exist; prints nvidia-smi's name and
     power limit.
  2. build: nvcc builds the four backprojection kernels from csrc/.
  3. kernels: each kernel against its plain PyTorch version on the card
     at the bench shapes (A = 400, Zf = 256, U = 400, 256x256 film,
     random fields with the banded u-geometry), with CUDA-event times;
     then the ballistic engine on the card against the same engine on
     the CPU on two small scenes (dense and banded layout).
  4. main path: optimize() on the bench scene (400 angles, 400x400 DMD,
     256^3 film, cylindrical vial, 40 Linear-L-BFGS steps); the best
     IoU over 301 thresholds must reach 0.98. Refraction at the vial
     wall stretches some (angle, 32x64 block) u-spans past the 256-column
     band, so the engine runs the dense pair here (as the JAX package's
     engine does on this scene).
  5. banded path: the same scene with an index-matched vial, whose
     u-spans fit the band: optimize() through the banded pair, same
     IoU gate.
  6. CLI: `python -m drtvam_tpu_torch config.json` on a 60x60x30 film
     (does not tile into 32x64 blocks) through the dense pair; the
     artifact set must exist.

Each earlier line is a JSON record; the line before the last lists the
kernels, the last is {"ok": true, "device": {...}}.
"""
import json
import os
import runpy
import subprocess
import sys
import tempfile
import time

import numpy as np

# kernel vs plain version: f32 sums in another order (forward: FMA
# contraction; adjoints: atomics in a run-dependent order), so each
# kernel must agree to this fraction of the plain result's max |value|
REL_TOL = 1e-5
IOU_GATE = 0.98
REPO = os.path.dirname(os.path.abspath(__file__))
REPLACES = {
    "bp_fwd": "drtvam_tpu/ops/backproject.py:187",
    "bp_bwd": "drtvam_tpu/ops/backproject.py:221",
    "bp_fwd_band": "drtvam_tpu/ops/backproject.py:362",
    "bp_bwd_band": "drtvam_tpu/ops/backproject.py:426",
}


def emit(obj):
    print(json.dumps(obj), flush=True)


def cuda_ms(fn, reps, torch):
    """Median milliseconds of fn() over `reps` runs after one warm-up."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def bench_fields(A=400, Y=256, X=256, U=400, Zf=256, seed=0):
    """Random fields whose u-map is an affine projection of (x, y) per
    angle, like the real transport, so each 32x64 block spans a narrow
    DMD band; 30 % empty cells exercise the sentinel."""
    rng = np.random.default_rng(seed)
    W = rng.uniform(0.0, 1.0, (A, Y, X)).astype(np.float32)
    W[W < 0.3] = 0.0
    ys, xs = np.meshgrid(np.arange(Y), np.arange(X), indexing="ij")
    scale = (U - 8) / np.hypot(Y, X)
    Umap = np.empty((A, Y, X), np.float32)
    for a in range(A):
        th = 2 * np.pi * a / A
        proj = np.cos(th) * xs + np.sin(th) * ys
        Umap[a] = (proj - proj.min()) * scale + 3.0 + \
            rng.uniform(-0.4, 0.4, (Y, X))
    Pz = rng.uniform(0.0, 1.0, (A, Zf, U)).astype(np.float32)
    dL = rng.uniform(0.0, 1.0, (Zf, Y * X)).astype(np.float32)
    return Pz, W, Umap, dL, U


def phase_kernels(torch, bp, dev):
    Pz, W, Umap, dL, U = bench_fields()
    A, Y, X = W.shape
    assert bp.banded_eligible(W.shape, U)
    assert bp.band_span_ok(torch.from_numpy(W), torch.from_numpy(Umap), U)
    Wt, Ut = torch.from_numpy(W).to(dev), torch.from_numpy(Umap).to(dev)
    dense = bp.PackedFields(Wt, Ut, U, banded=False)
    band = bp.PackedFields(Wt, Ut, U, banded=True)
    del Wt, Ut
    Pz = torch.from_numpy(Pz).to(dev)
    dL = torch.from_numpy(dL).to(dev)
    cases = {
        "bp_fwd": (lambda: bp.fwd_dense(Pz, dense.F),
                   lambda: bp.fwd_dense_plain(Pz, dense.F)),
        "bp_bwd": (lambda: bp.bwd_dense(dL, dense.F, U),
                   lambda: bp.bwd_dense_plain(dL, dense.F, U)),
        "bp_fwd_band": (lambda: bp.fwd_band(Pz, band.F, band.u0, Y, X),
                        lambda: bp.fwd_band_plain(Pz, band.F, band.u0,
                                                  Y, X)),
        "bp_bwd_band": (lambda: bp.bwd_band(dL, band.F, band.u0, U, Y, X),
                        lambda: bp.bwd_band_plain(dL, band.F, band.u0, U,
                                                  Y, X)),
    }
    results = {}
    for name, (kern, plain) in cases.items():
        out = kern()
        ref = plain()
        torch.cuda.synchronize()
        err = float((out - ref).abs().max())
        scale = float(ref.abs().max())
        del out, ref
        rec = {"phase": "kernel", "name": name, "max_abs_err": err,
               "max_abs_plain": scale, "tol": REL_TOL * scale,
               "ms": cuda_ms(kern, 7, torch),
               "plain_ms": cuda_ms(plain, 5, torch)}
        emit(rec)
        if not err <= REL_TOL * scale:
            raise AssertionError(f"{name} disagrees with its plain "
                                 f"version: {err} > {REL_TOL * scale}")
        results[name] = rec
    return results


def small_scene(vial, film, tmp):
    from drtvam_tpu_torch.models.scene import Scene
    from drtvam_tpu_torch.ops.mesh import make_box, save_ply
    path = os.path.join(tmp, "small_target.ply")
    save_ply(make_box((0.5, 0.5, 0.5)), path)
    cfg = {
        "vial": vial,
        "projector": {"type": "collimated", "n_patterns": 23, "resx": 210,
                      "resy": 16, "pixel_size": 0.025,
                      "motion": "circular", "distance": 20},
        "sensor": {"type": "dda", "scalex": 5.07, "scaley": 5.07,
                   "scalez": 1.29,
                   "film": {"type": "vfilm", "resx": film, "resy": film,
                            "resz": 20}},
        "target": {"filename": path, "size": 4.0},
        "output": tmp,
    }
    sc = Scene(cfg)
    static, arr = sc.build(mode="volume", include_target=False,
                           regular_sampling=True)
    return sc, static, arr


def phase_engine(torch, dev, tmp):
    """The engine on the card against the engine on the CPU (plain
    versions): dose and pattern gradient, one dense and one banded
    scene."""
    from drtvam_tpu_torch.ops.ballistic import BallisticEngine
    vial = {"type": "cylindrical", "r_int": 2.3, "r_ext": 2.6, "ior": 1.54,
            "medium": {"ior": 1.40, "extinction": 0.1, "albedo": 0.0}}
    for film, impl in ((40, "cuda"), (128, "cuda_band")):
        sc, static, arr = small_scene(vial, film, tmp)
        inv_vol = float(sc.sensor.inv_volume())
        cpu = BallisticEngine(static, arr, "cpu")
        gpu = BallisticEngine(static, arr, dev)
        assert gpu.impl == impl, (gpu.impl, impl)
        rng = np.random.default_rng(film)
        p = torch.from_numpy(rng.random(cpu.n_active).astype(np.float32))
        v = torch.from_numpy(rng.random(static.sensor.shape)
                             .astype(np.float32))
        ref_vol = cpu.render_vol(p, inv_vol)
        ref_g = cpu.pattern_grad(v, inv_vol)
        pg = p.to(dev).requires_grad_(True)
        vol = gpu.render_vol(pg, inv_vol)
        # autograd through the Backproject function == explicit adjoint
        (auto_g,) = torch.autograd.grad(vol, pg, v.to(dev))
        g = gpu.pattern_grad(v.to(dev), inv_vol)
        errs = {}
        for key, a, b in (("vol", vol, ref_vol), ("grad", g, ref_g),
                          ("autograd", auto_g, ref_g)):
            a = a.detach().cpu()
            assert a.shape == b.shape and bool(torch.isfinite(a).all())
            errs[key] = float((a - b).abs().max() / b.abs().max())
            if not errs[key] <= REL_TOL:
                raise AssertionError(f"engine {impl} {key}: {errs[key]}")
        emit({"phase": "engine_vs_cpu", "impl": impl, "film": film,
              "rel_err": errs})


def bench_config(tmp, vial="cylindrical"):
    from drtvam_tpu_torch.ops.mesh import make_box_with_hole, save_ply
    mesh_path = os.path.join(tmp, "bench_target.ply")
    save_ply(make_box_with_hole((1.0, 0.8, 2.0), 0.35,
                                hole_center_xy=(-0.4, 0.0), segments=99),
             mesh_path)
    med = {"ior": 1.40, "phase": {"type": "rayleigh"}, "extinction": 0.05,
           "albedo": 0.0}
    vials = {"cylindrical": {"type": "cylindrical", "r_int": 4.75,
                             "r_ext": 5.0, "ior": 1.54, "medium": med},
             "index_matched": {"type": "index_matched", "r": 4.75,
                               "medium": med}}
    return {
        "vial": vials[vial],
        "projector": {"type": "collimated", "n_patterns": 400,
                      "resx": 400, "resy": 400, "pixel_size": 10.0 / 400,
                      "motion": "circular", "distance": 30},
        "sensor": {"type": "dda", "scalex": 10, "scaley": 10, "scalez": 10,
                   "film": {"type": "vfilm", "resx": 256, "resy": 256,
                            "resz": 256}},
        "target": {"filename": mesh_path, "size": 10.0},
        "loss": {"type": "threshold"},
        "optimizer": {"type": "lbfgs"},
        "n_steps": 40,
        "output": os.path.join(tmp, f"bench_{vial}"),
    }


def phase_bench(torch, bp, dev, tmp, vial, kernels):
    """optimize() on the bench scene; `kernels` must have launched."""
    from drtvam_tpu_torch.opt.optimize import optimize
    from drtvam_tpu_torch.utils.metrics import best_iou
    cfg = bench_config(tmp, vial)
    timings = {}
    torch.cuda.reset_peak_memory_stats(dev)
    bp.reset_launches()
    t0 = time.perf_counter()
    vol = optimize(cfg, device=dev, timings=timings)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = dict(bp.launches)
    for name in kernels:
        if counts[name] == 0:
            raise AssertionError(f"the {vial} bench run never launched "
                                 f"{name}")
    target = np.load(os.path.join(cfg["output"], "target.npy"))
    assert vol.shape == (256, 256, 256, 1) and np.isfinite(vol).all()
    iou, thr = best_iou(vol[..., 0], target[..., 0], 301)
    loss = np.load(os.path.join(cfg["output"], "loss.npy"))
    steps = int(np.count_nonzero(
        np.load(os.path.join(cfg["output"], "timing.npy")).sum(1)))
    emit({"phase": "bench", "vial": vial, "scene_s": timings["scene_s"],
          "precompute_s": timings["precompute_s"],
          "loop_s": timings["loop_s"],
          "final_render_s": timings["final_render_s"],
          "artifacts_s": timings["artifacts_s"], "wall_s": wall,
          "steps_run": steps, "loss_first": float(loss[0]),
          "loss_last": float(loss[steps - 1]),
          "best_iou": iou, "best_threshold": thr, "launches": counts,
          "peak_mem_gb": torch.cuda.max_memory_allocated(dev) / 1e9})
    if not iou >= IOU_GATE:
        raise AssertionError(f"best IoU {iou} < {IOU_GATE}")
    return counts


def phase_cli(bp, tmp):
    from drtvam_tpu_torch.ops.mesh import make_box_with_hole, save_ply
    work = os.path.join(tmp, "cli")
    os.makedirs(work)
    save_ply(make_box_with_hole((2.0, 2.0, 0.5), 1.0,
                                hole_center_xy=(-1.0, 0.0)),
             os.path.join(work, "box_hole.ply"))
    cfg = {
        "vial": {"type": "cylindrical", "r_int": 7, "r_ext": 8, "ior": 1.54,
                 "medium": {"ior": 1.40, "phase": {"type": "rayleigh"},
                            "extinction": 0.1, "albedo": 0.0}},
        "projector": {"type": "collimated", "n_patterns": 60, "resx": 60,
                      "resy": 12, "pixel_size": 0.0833,
                      "motion": "circular", "distance": 20},
        "sensor": {"type": "dda", "scalex": 5, "scaley": 5, "scalez": 1.25,
                   "film": {"type": "vfilm", "resx": 60, "resy": 60,
                            "resz": 30}},
        "target": {"filename": "box_hole.ply", "size": 4.0},
        "loss": {"type": "threshold", "tl": 0.85, "tu": 0.95},
        "n_steps": 6, "output": os.path.join(work, "out")}
    cfg_path = os.path.join(work, "config.json")
    with open(cfg_path, "w") as f:
        json.dump(cfg, f)
    bp.reset_launches()
    argv = sys.argv
    sys.argv = ["drtvam_tpu_torch", cfg_path]
    try:
        runpy.run_module("drtvam_tpu_torch", run_name="__main__")
    finally:
        sys.argv = argv
    counts = dict(bp.launches)
    for name in ("bp_fwd", "bp_bwd"):
        if counts[name] == 0:
            raise AssertionError(f"the CLI run never launched {name}")
    out = cfg["output"]
    files = ["final.exr", "final.npy", "target.exr", "target.npy",
             "loss.npy", "timing.npy", "patterns.npz",
             "patterns_normalized_uint8.npz", "histogram.png",
             "opt_config.json"] + [f"patterns/{k:04d}.exr"
                                   for k in range(60)]
    missing = [f for f in files if not os.path.exists(os.path.join(out, f))]
    if missing:
        raise AssertionError(f"CLI artifacts missing: {missing}")
    loss = np.load(os.path.join(out, "loss.npy"))
    final = np.load(os.path.join(out, "final.npy"))
    assert np.isfinite(final).all() and loss[-1] < loss[0]
    emit({"phase": "cli", "launches": counts, "loss_first": float(loss[0]),
          "loss_last": float(loss[-1])})
    return counts


def main():
    import torch
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: torch.cuda.is_available() is false")
    sys.path.insert(0, REPO)
    from drtvam_tpu_torch.ops import backproject as bp

    smi = subprocess.run(["nvidia-smi", "-i", "0",
                          "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    print(smi.stdout.strip(), flush=True)
    dev = torch.device("cuda:0")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t0 = time.perf_counter()
    bp.build_kernels()
    emit({"phase": "build", "seconds": time.perf_counter() - t0})

    kern = phase_kernels(torch, bp, dev)
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        phase_engine(torch, dev, tmp)
        dense_counts = phase_bench(torch, bp, dev, tmp, "cylindrical",
                                   ("bp_fwd", "bp_bwd"))
        torch.cuda.empty_cache()
        band_counts = phase_bench(torch, bp, dev, tmp, "index_matched",
                                  ("bp_fwd_band", "bp_bwd_band"))
        torch.cuda.empty_cache()
        phase_cli(bp, tmp)

    launches = {"bp_fwd": dense_counts["bp_fwd"],
                "bp_bwd": dense_counts["bp_bwd"],
                "bp_fwd_band": band_counts["bp_fwd_band"],
                "bp_bwd_band": band_counts["bp_bwd_band"]}
    emit({"kernels": [
        {"name": n, "route": "cuda",
         "source": f"drtvam_tpu_torch/csrc/{n}.cu",
         "replaces": REPLACES[n], "launches": launches[n],
         "path": ("optimize() on the bench scene, index-matched vial"
                  if n.endswith("band") else
                  "main path: optimize() on the bench scene"),
         "max_abs_err": kern[n]["max_abs_err"], "ms": kern[n]["ms"],
         "plain_ms": kern[n]["plain_ms"]} for n in bp.KERNELS]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
