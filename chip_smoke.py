#!/usr/bin/env python3
"""Smoke run of drtvam_tpu_torch on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (each failure exits non-zero before the result line):
  1. device: a CUDA device must exist; prints nvidia-smi's name and
     power limit.
  2. build: nvcc builds the four backprojection kernels from csrc/.
  3. kernels: each kernel against its plain PyTorch version on the card
     at the bench shapes (A = 400, Zf = 256, U = 400, 256x256 film,
     random fields with the banded u-geometry), with CUDA-event times,
     the bound (float32 FMA peak or HBM rate, whichever is larger, for
     the taps the fields have) and the time of one cuSPARSE SpMM
     (torch.sparse.mm) computing the same function (library_ms; the
     port never calls it). All four must give bitwise equal results on
     two launches. Then each pair on the bench scene's real fields, as
     an engine built on the card packs them: the dense pair on the
     cylindrical vial's, the banded pair on the index-matched vial's;
     and the ballistic engine on the card against the same engine on the
     CPU on two small scenes (dense and banded layout).
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
import warnings

import numpy as np

# kernel vs plain version: f32 sums in another order (FMA contraction),
# so each kernel must agree to this fraction of the plain result's max
# |value|
REL_TOL = 1e-5
IOU_GATE = 0.98
# no kernel uses atomics: each output is written once, in a fixed order,
# so two launches agree bitwise
BITWISE = ("bp_fwd", "bp_bwd", "bp_fwd_band", "bp_bwd_band")
# published H100 SXM peaks (700 W): float32 FMA outside the tensor
# cores, HBM3
F32_FLOPS = 67e12
HBM_BYTES_PER_S = 3.35e12
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


def tap_entries(torch, bp, F, U, u0=None, Y=None, X=None):
    """Every nonzero tap of packed fields as (a * U + column, raster
    voxel, weight): B_a's nonzeros, band-masked for banded fields."""
    A, _, L = F.shape
    dev = F.device
    lo = None if u0 is None else bp._band_lo(u0)
    i0, i1, w0, w1 = bp._taps(F, U, lo)
    vox = torch.arange(L, device=dev)
    if u0 is not None:  # block-major position -> raster index
        vox = bp.block_permute(vox.reshape(Y, X), Y, X).reshape(-1)
    col = torch.cat([i0, i1]).reshape(-1)
    w = torch.cat([w0, w1]).reshape(-1)
    a = torch.arange(A, device=dev).repeat_interleave(L).repeat(2)
    keep = w != 0
    return (a[keep] * U + col[keep], vox.repeat(2 * A)[keep], w[keep])


def csr(torch, rows, cols, vals, shape):
    order = torch.argsort(rows * shape[1] + cols)
    rows, cols, vals = rows[order], cols[order], vals[order]
    crow = torch.searchsorted(rows, torch.arange(shape[0] + 1,
                                                 device=rows.device))
    with warnings.catch_warnings():  # "sparse CSR support is in beta"
        warnings.simplefilter("ignore", UserWarning)
        return torch.sparse_csr_tensor(crow, cols, vals, size=shape,
                                       check_invariants=False)


def bound(n_taps, Zf, n_bytes):
    """Least time on the card: 2 flops per (tap, z) at the float32 FMA
    peak, or the compulsory bytes at the HBM rate, whichever is larger."""
    flop_ms = 2.0 * n_taps * Zf / F32_FLOPS * 1e3
    byte_ms = n_bytes / HBM_BYTES_PER_S * 1e3
    return (max(flop_ms, byte_ms),
            "operations" if flop_ms >= byte_ms else "bytes")


def library_calls(torch, bp, F, U, x, fwd, u0=None, Y=None, X=None):
    """One cuSPARSE SpMM (torch.sparse.mm) computing the kernel's
    function on x = Pz (forward: (YX x A*U) CSR @ Pz as (A*U, Zf)) or
    x = dL (adjoint: (A*U x YX) CSR @ dL^T). Returns the call on
    pre-laid-out operands, the same call with the operand and result
    re-layouts, the number of taps and the CSR build seconds."""
    A = F.shape[0]
    Zf, YX = (x.shape[1], F.shape[2]) if fwd else x.shape
    t0 = time.perf_counter()
    au, vox, w = tap_entries(torch, bp, F, U, u0, Y, X)
    n_taps = int(w.numel())
    if fwd:
        B = csr(torch, vox, au, w, (YX, A * U))
        xl = x.permute(0, 2, 1).reshape(A * U, Zf).contiguous()
    else:
        B = csr(torch, au, vox, w, (A * U, YX))
        xl = x.t().contiguous()
    del au, vox, w
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    if fwd:
        def full():
            return torch.sparse.mm(B, x.permute(0, 2, 1).reshape(
                A * U, Zf)).t().contiguous()
    else:
        def full():
            return torch.sparse.mm(B, x.t().contiguous()).reshape(
                A, U, Zf).permute(0, 2, 1).contiguous()
    return (lambda: torch.sparse.mm(B, xl)), full, n_taps, build_s


def check_and_time(torch, name, kern, plain, reps=20):
    out = kern()
    ref = plain()
    out2 = kern()
    torch.cuda.synchronize()
    err = float((out - ref).abs().max())
    scale = float(ref.abs().max())
    bitwise = bool(torch.equal(out, out2))
    del out, out2, ref
    if not err <= REL_TOL * scale:
        raise AssertionError(f"{name} disagrees with its plain version: "
                             f"{err} > {REL_TOL * scale}")
    if name in BITWISE and not bitwise:
        raise AssertionError(f"{name}: two launches differ bitwise")
    return {"max_abs_err": err, "max_abs_plain": scale,
            "tol": REL_TOL * scale, "bitwise_repeat": bitwise,
            "ms": cuda_ms(kern, reps, torch),
            "plain_ms": cuda_ms(plain, 3, torch)}


def phase_kernels(torch, bp, dev):
    Pz, W, Umap, dL, U = bench_fields()
    A, Y, X = W.shape
    Zf = Pz.shape[1]
    assert bp.banded_eligible(W.shape, U)
    assert bp.band_span_ok(torch.from_numpy(W), torch.from_numpy(Umap), U)
    Wt, Ut = torch.from_numpy(W).to(dev), torch.from_numpy(Umap).to(dev)
    dense = bp.PackedFields(Wt, Ut, U, banded=False)
    band = bp.PackedFields(Wt, Ut, U, banded=True)
    del Wt, Ut
    Pz = torch.from_numpy(Pz).to(dev)
    dL = torch.from_numpy(dL).to(dev)
    # the engines' layouts, built once as PackedFields builds them: the
    # times are the kernels' alone
    lay, blay = dense.layout, band.layout
    # the fields fit the band: the band-masked layout is the dense one
    same = (lay.windows[1] == blay.windows[1] and
            torch.equal(lay.windows[0], blay.windows[0]) and
            all(torch.equal(d, b) for d, b in zip(lay.lists, blay.lists)))
    emit({"phase": "band_layout", "equals_dense": same,
          "max_window": blay.windows[1],
          "list_entries": int(blay.lists[1].shape[0])})
    if not same:
        raise AssertionError("the band-masked layout of span-ok fields "
                             "differs from the dense one")
    cases = {
        "bp_fwd": (lambda: bp.fwd_dense(Pz, dense.F, lay),
                   lambda: bp.fwd_dense_plain(Pz, dense.F)),
        "bp_bwd": (lambda: bp.bwd_dense(dL, dense.F, U, lay),
                   lambda: bp.bwd_dense_plain(dL, dense.F, U)),
        "bp_fwd_band": (lambda: bp.fwd_band(Pz, band.F, band.u0, Y, X,
                                            blay),
                        lambda: bp.fwd_band_plain(Pz, band.F, band.u0,
                                                  Y, X)),
        "bp_bwd_band": (lambda: bp.bwd_band(dL, band.F, band.u0, U, Y, X,
                                            blay),
                        lambda: bp.bwd_band_plain(dL, band.F, band.u0, U,
                                                  Y, X)),
    }
    results = {}
    for name, (kern, plain) in cases.items():
        rec = {"phase": "kernel", "name": name,
               "shapes": {"A": A, "Zf": Zf, "U": U, "Y": Y, "X": X}}
        rec.update(check_and_time(torch, name, kern, plain))
        fields = band if name.endswith("band") else dense
        fwd = "fwd" in name
        lib, lib_full, n_taps, build_s = library_calls(
            torch, bp, fields.F, U, Pz if fwd else dL, fwd, fields.u0, Y, X)
        ref = cases[name][0]()
        got = lib_full()
        rec["library_rel_err"] = float((got - ref).abs().max() /
                                       ref.abs().max())
        del ref, got
        rec["library_ms"] = cuda_ms(lib, 10, torch)
        rec["library_layout_ms"] = cuda_ms(lib_full, 10, torch) - \
            rec["library_ms"]
        rec["library_csr_build_s"] = build_s
        del lib, lib_full
        n_bytes = 4 * (A * Zf * U + fields.F.numel() + Zf * Y * X)
        rec["taps"] = n_taps
        rec["bound_ms"], rec["bound_by"] = bound(n_taps, Zf, n_bytes)
        rec["roofline_share"] = rec["bound_ms"] / rec["ms"]
        emit(rec)
        results[name] = rec
        torch.cuda.empty_cache()
    return results


def phase_real_fields(torch, bp, dev, tmp):
    """Each kernel pair on the bench scene's own fields, as the bench
    runs' engines pack them on the card: the dense pair on the
    cylindrical vial's fields, the banded pair on the index-matched
    vial's."""
    from drtvam_tpu_torch.models.scene import Scene
    from drtvam_tpu_torch.ops.ballistic import BallisticEngine
    out = {}
    for vial, impl in (("cylindrical", "cuda"),
                       ("index_matched", "cuda_band")):
        sc = Scene(bench_config(tmp, vial))
        static, arr = sc.build(mode="volume", include_target=False)
        t0 = time.perf_counter()
        eng = BallisticEngine(static, arr, dev)
        torch.cuda.synchronize()
        engine_s = time.perf_counter() - t0
        assert eng.impl == impl, (vial, eng.impl)
        f = eng.fields
        A, U, Y, X = f.A, f.U, f.Y, f.X
        Zf = static.sensor.res[2]
        rng = np.random.default_rng(1)
        Pz = torch.from_numpy(rng.uniform(0.0, 1.0, (A, Zf, U))
                              .astype(np.float32)).to(dev)
        dL = torch.from_numpy(rng.uniform(0.0, 1.0, (Zf, Y * X))
                              .astype(np.float32)).to(dev)
        maxw = f.layout.windows[1]
        n_taps = int(tap_entries(torch, bp, f.F, U, f.u0, Y, X)[2].numel())
        n_bytes = 4 * (A * Zf * U + f.F.numel() + Zf * Y * X)
        if f.banded:
            cases = (("bp_fwd_band",
                      lambda: bp.fwd_band_plain(Pz, f.F, f.u0, Y, X)),
                     ("bp_bwd_band",
                      lambda: bp.bwd_band_plain(dL, f.F, f.u0, U, Y, X)))
        else:
            cases = (("bp_fwd", lambda: bp.fwd_dense_plain(Pz, f.F)),
                     ("bp_bwd", lambda: bp.bwd_dense_plain(dL, f.F, U)))
        for (name, plain), kern in zip(cases, (lambda: f.forward(Pz),
                                               lambda: f.adjoint(dL))):
            rec = {"phase": "kernel_real_fields", "name": name,
                   "vial": vial,
                   "shapes": {"A": A, "Zf": Zf, "U": U, "Y": Y, "X": X},
                   "max_window": maxw,
                   "list_entries": int(f.layout.lists[1].shape[0]),
                   "engine_s": engine_s}
            rec.update(check_and_time(torch, name, kern, plain))
            rec["taps"] = n_taps
            rec["bound_ms"], rec["bound_by"] = bound(n_taps, Zf, n_bytes)
            rec["roofline_share"] = rec["bound_ms"] / rec["ms"]
            emit(rec)
            out[name] = rec
        del eng, f, Pz, dL, cases
        torch.cuda.empty_cache()
    return out


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
        real = phase_real_fields(torch, bp, dev, tmp)
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
         **{k: kern[n][k] for k in (
             "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
             "library_ms", "library_layout_ms", "roofline_share")},
         "real_fields": {k: real[n][k] for k in (
             "ms", "plain_ms", "max_abs_err", "bound_ms", "bound_by",
             "max_window", "list_entries")}} for n in bp.KERNELS]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
