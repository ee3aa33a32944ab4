#!/usr/bin/env python3
"""Variants of the wavefront kernel pair, timed on one card.

    python3 tools/wf_variants.py [VARIANT ...]   (default: all; "shipped"
                                                  always runs, first)
    python3 tools/wf_variants.py residual [VARIANT ...]   (the residual
                                                  pair's, RES_VARIANTS)
    python3 tools/wf_variants.py cull [--parent ROOT] [VARIANT ...]
                                                 (the culling renders',
                                                  CULL_VARIANTS)
    python3 tools/wf_variants.py target [--parent ROOT] [--cell-d]
                                        [VARIANT ...]
                                                 (the analog pair's
                                                  target forms',
                                                  TGT_VARIANTS)
    python3 tools/wf_variants.py res_target [VARIANT ...]   (the dda
                                                  residual's target path
                                                  pass', RTP_VARIANTS)
    python3 tools/wf_variants.py med [--share | --cell-c] [VARIANT ...]
                                                 (the medium adjoint's
                                                  forms', MED_VARIANTS)

run from the repo root on a machine with one NVIDIA GPU. Each variant
changes one thing against the source as it is ("shipped"): the threads
a CTA (WF_THREADS in a copy of drtvam_tpu_torch/csrc/wf_trace.cuh), the
angles a CTA traces a DMD row over (ops/render.py ANGLES_PER_GROUP), the
home-slice tile turned off (every deposit to global memory, in the same
grouped launch order) or cut to some of the film's rows (the others'
deposits to global memory), the tile's add written as a PTX reduction
on the shared state space, or the forward's task written another way
(all the lanes of a pixel on one thread, as the adjoint traces them; the
one lane a plain call).
nvcc builds every variant source's wf_fwd and wf_bwd at once, then each
pair runs the bench scene at full width (400 angles, 400x400 DMD, 256^3
film, spp 1, 64 M lanes) on chip_smoke.py phase 8's numpy-seeded
inputs: its result against the shipped pair's (forward within 1e-5 of
the max, adjoint bitwise), CUDA-event times (median of 5; for some
variants also the forward as the final render launches it, spp 16, and
on the bench scene at spp 2 to 16, median of 3), the counters and the
launch shape. One JSON record per variant; compare variants only within
one call.
The residual pair's variants (the hybrid engine's wf_res_fwd /
wf_res_bwd, csrc/wf_residual.cuh) are builds of the shipped source with
other values of its compile-time constants: the per-lane set-up levers
turned off one at a time and all together (WF_RES_FRAMES, WF_RES_CHORDS,
WF_RES_DIVS), other launch shapes of the per-lane kernel and of the
walk pass, and the walk's chunk of records. Each runs the bench
scattering scene (albedo 0.5) at full width: the delta fast loop at spp
1 each way (64 M lanes, median of 5; forward within 1e-5 of the max of
the shipped build's, adjoint bitwise) and the dda first-scatter forward
as the final render launches it (spp 16, 1.02 G lanes, one launch after
a warm-up: its path and walk passes' times, the walk's SIMT efficiency),
with the registers and spills of the instantiations these run.
The culling renders' variants (wf_radon / wf_corner, csrc/wf_cull.cuh
and csrc/wf_mesh.cuh) are builds of the shipped source with one lever
turned off or another launch shape (WF_CULL_*, WF_MESH_*), and
the shipped build with the mesh banks read from global memory; with
--parent, the parent tree's wf_radon / wf_corner sources too ("parent",
called through their own entry points). Each runs chip_smoke.py phase
11's full-width renders: the bench scene's radon render (regular, spp 1,
64 M lanes, median of 5), the square bench vial's corner render (64 M
lanes, median of 5) and the telecentric bench scene's radon render at
spp 4 (256 M lanes, median of 3), each image bitwise against the shipped
build's; the shipped build also on the bench scene without its target
mesh, its counting launches (bounce iterations, grid cells, triangles,
the triangle tests' SIMT efficiency, repeated tests, lanes that reach
the mesh's box), the telecentric image against the plain march on every
50th angle's pixels, and the launch shapes; every build its ptxas
registers and spills.
The target forms' variants (wf_fwd / wf_bwd on a scene that keeps the
target: csrc/wf_target.cu's staged adjoint and dda path and walk passes)
are builds of wf_target.cu with other launch shapes (WF_TGT_*), and the
one-pass kernels the scenes ran before (wf_fwd.cu / wf_bwd.cu with the
target: 1024 threads, the banks in global memory), as they are, with the
home-slice tile off (every deposit a global atomic, L1 free) and built at
512 threads a CTA (128 registers a thread); with --parent ROOT also
ROOT's wf_target.cu, built from ROOT's sources (a parent commit, or the
shipped sources with one header changed, to find what moved a kernel).
Each runs chip_smoke.py
phase 13's cell (b) (the bench scene with a surface-aware film on the
wavefront, dda, spp 1, 64 M lanes) on the patterns of its optimize()
after TGT_STEPS steps: the two-channel forward, the one-channel forward
(the film cut to one channel, the target kept) and the two-channel
adjoint, each against the shipped build's (forwards to 1e-4 of each
channel's max, the adjoint bitwise), CUDA-event times (median of 3), the
launch shapes and the registers and spills of the instantiations they
run; the shipped build also its counts (steps, the target's grid cells,
triangles and walks, records, batches), the forward's path and walk
passes apart and the scene without its target. --cell-d: the same on
chip_smoke.py's cell (d) (the custom cuvette with a scattering resin,
the delta sensor) on the patterns of its optimize() after TGT_STEPS
steps: the delta forward (the delta form, tgt_delta_kernel) and the
staged adjoint.
The residual target path pass's variants (the dda residual forward's path
pass on a scene that keeps the target: csrc/wf_res_target.cu) are builds
of wf_res_target.cu with other launch shapes (WF_RTP_*), the shipped build
with its banks read from global memory (RES_TGT_SMEM_LIMIT 0), and the
one-pass instantiation the scene ran before (wf_res_path with the target,
256 threads, the banks in global memory). Each runs the dda
residual forward of chip_smoke.py phase 13's cell (a) (the surface-aware
square scattering cell) as its final render launches it (spp 16, the
target kept, one channel) on the patterns of its optimize() after
RTP_STEPS steps: a counting launch (bounce iterations, records, the
target's grid walks, cells and triangle tests, the SIMT efficiencies of
the bounces and of the triangle tests), then one timed launch (CUDA
events) with its path and walk passes apart and one as the render calls
it (a batch's walk beside the next batch's path pass), the dose against the
shipped build's (1e-4 of the max, none off), the launch shape and the
registers and spills of the path pass's instantiation; the shipped build
also on the scene without its target.
The medium adjoint's variants (wf_med.cu: csrc/wf_med.cuh) are builds of
it with other threads a CTA: 512 or 1024 (128 or 64 registers a thread;
768, up to 80, is the shipped shape). Each runs chip_smoke.py phase 15's
calibration scene (the bench scene, dda, spp 1, 64 M lanes) on phase 9's
optimized patterns (chip_smoke.py phase_wf_bench, run first), dL the l2
loss's gradient between the render at sigma_t MED_ST and the dose
recorded at chip_smoke.MED_ST_TRUE: its time (CUDA events, median of 5)
beside the shipped wf_bwd's, its (stg, ssg) against the shipped build's
(to chip_smoke.MED_TOL), and the registers and spills of the
instantiation the scene runs; first the patterns' zero share and the
tasks before and after the compaction. --share: that record alone
(phase 9 and the count, no variant built). --cell-c: on chip_smoke.py
phase 14's cell (c) (a mesh vial and an occlusion; its optimize() run,
the loop's last inputs) with medium_grads, staged and one-pass (the
staged form's threads a CTA, WF_MED_STAGED_THREADS, are what
"staged1024" varies).
"""
import contextlib
import ctypes
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

# name: {WF_THREADS: source constant, ANGLES_PER_GROUP:
# wrapper constant, tile: False for no tile, tile_rows: (every, keep),
# the tile cut to film rows y % every < keep, red_shared: the tile's add
# in PTX, forward: the forward's task rewritten (FORWARD_NEW)}
VARIANTS = {
    "shipped": {},
    "no_tile": {"tile": False},
    "threads512": {"WF_THREADS": 512},
    "angles50": {"ANGLES_PER_GROUP": 50},
    "red_shared": {"red_shared": True},
    "tile_rows_1of2": {"tile_rows": (2, 1)},
    "tile_rows_1of3": {"tile_rows": (3, 1)},
    "tile_rows_2of3": {"tile_rows": (3, 2)},
    "pixel_lanes": {"forward": "pixel_lanes"},
    "straight_call": {"forward": "straight_call"},
}
# the forward's task, rewritten: "pixel_lanes" gives each thread all the
# lanes of its pixel (as the adjoint), "straight_call" traces the one
# lane by a plain call in place of the loop that runs once
FORWARD_OLD = """    if (em == 0.0f) return aidx;
    // the one lane, as a loop that runs once: nvcc's code for this form
    // ran 6 % faster on an H100 than a plain call (PERF.md section 6)
    for (int k = t % P.spp; k < P.spp; k += P.spp) {
      trace_lane<EST, SCAT, TONLY>(
          P, G, (uint32_t)aidx * (uint32_t)P.spp + (uint32_t)k, aidx,
          active_pixels, em, S);
    }"""
FORWARD_NEW = {
    "pixel_lanes": """    if (em == 0.0f) return aidx;
    for (int k = 0; k < P.spp; ++k)
      trace_lane<EST, SCAT, TONLY>(
          P, G, (uint32_t)aidx * (uint32_t)P.spp + (uint32_t)k, aidx,
          active_pixels, em, S);""",
    "straight_call": """    if (em == 0.0f) return aidx;
    trace_lane<EST, SCAT, TONLY>(
        P, G, (uint32_t)aidx * (uint32_t)P.spp + (uint32_t)(t % P.spp),
        aidx, active_pixels, em, S);"""}
# pixel_lanes also takes one task per 32 pixels, and 32 pixels a task
TASK_OLD = ("return (PRIMAL ? P.spp : 1) * ((hi - lo + 31) / 32);",
            "const int j = lo + 32 * (t / P.spp) + l;")
TASK_NEW = ("return (hi - lo + 31) / 32;", "const int j = lo + 32 * t + l;")
# variants whose forward is also timed as the final render launches it
SPP16 = ("shipped", "no_tile", "tile_rows_1of2", "tile_rows_1of3",
         "tile_rows_2of3", "pixel_lanes", "straight_call")
# variants whose forward is also timed on the bench scene at these spp
SPP_SWEEP = {"shipped": (2, 4, 8, 16), "no_tile": (2, 4, 8, 16),
             "pixel_lanes": (2, 4, 8, 16), "straight_call": (2, 16)}
# the tile's add as a PTX reduction on the shared state space, in place
# of atomicAdd on a generic pointer into shared memory
RED_SHARED = ('asm volatile("red.shared.add.f32 [%0], %1;" :: "r"('
              '(unsigned)__cvta_generic_to_shared(tile + slot)), "f"(val) '
              ': "memory");')


def variant_source(src_dir, dst, spec):
    shutil.copytree(src_dir, dst, ignore=shutil.ignore_patterns("host"))
    path = os.path.join(dst, "wf_trace.cuh")
    with open(path) as f:
        text = f.read()
    if "WF_THREADS" in spec:
        text, n = re.subn(r"constexpr int WF_THREADS = \d+;",
                          f"constexpr int WF_THREADS = {spec['WF_THREADS']};",
                          text)
        if n != 1:
            raise RuntimeError(f"cannot rewrite WF_THREADS in {path}")
    if "forward" in spec:
        edits = [(FORWARD_OLD, FORWARD_NEW[spec["forward"]])]
        if spec["forward"] == "pixel_lanes":
            edits += list(zip(TASK_OLD, TASK_NEW))
        for old, new in edits:
            if text.count(old) != 1:
                raise RuntimeError(f"cannot rewrite the forward's task in "
                                   f"{path}")
            text = text.replace(old, new)
    if spec.get("red_shared"):
        text, n = re.subn(r"atomicAdd\(tile \+ slot, val\);",
                          lambda m: RED_SHARED, text)
        if n != 1:
            raise RuntimeError(f"cannot rewrite the tile's add in {path}")
    with open(path, "w") as f:
        f.write(text)


def some_rows(rows, every, keep):
    """The tile's row table cut to film rows y with y % every < keep,
    the others empty (their deposits go to global memory)."""
    import torch
    r = rows.to(torch.int64)
    y = torch.arange(r.shape[0])
    n = torch.where(y % every < keep, r[:, 1], 0)
    lo = torch.where(n > 0, r[:, 0], 0)
    off = torch.cumsum(n, 0) - n
    out = torch.stack([lo, n, off - lo, torch.zeros_like(n)], 1)
    return out.to(torch.int32), int(n.sum())


def patched(wf, spec, libs):
    """Point the wrapper at the variant's libraries and constants."""
    wf.build_kernels = lambda: libs
    wf.ANGLES_PER_GROUP = spec.get("ANGLES_PER_GROUP", SHIPPED_ANGLES)
    if not spec.get("tile", True):
        wf.tile_rows = lambda static, arr: (
            SHIPPED_TILE_ROWS(static, arr)[0], 0)
    elif "tile_rows" in spec:
        wf.tile_rows = lambda static, arr: some_rows(
            SHIPPED_TILE_ROWS(static, arr)[0], *spec["tile_rows"])
    else:
        wf.tile_rows = SHIPPED_TILE_ROWS


def source_dir(work, spec):
    keys = [f"{k}{v}" for k, v in sorted(spec.items())
            if k in ("WF_THREADS", "red_shared", "forward")]
    return os.path.join(work, "_".join(["src"] + keys))


def build(work, names):
    """One nvcc per (variant source, entry point), all started together;
    returns {(source dir, entry point): ptxas log}."""
    from drtvam_tpu_torch.native import CUDA_SRC_DIR, nvcc_path
    jobs = []
    for spec in (VARIANTS[n] for n in names):
        vdir = source_dir(work, spec)
        if os.path.exists(vdir):
            continue
        variant_source(CUDA_SRC_DIR, vdir, spec)
        for n in ("wf_fwd", "wf_bwd"):
            cmd = [nvcc_path(), "-gencode", "arch=compute_90a,code=sm_90a",
                   "-std=c++17", "-O3", "-Xptxas", "-v", "-shared",
                   "-Xcompiler", "-fPIC", "--fmad=false", "-I", vdir,
                   os.path.join(vdir, n + ".cu"), "-o",
                   os.path.join(vdir, f"lib{n}.so")]
            jobs.append((vdir, n, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
    logs = {}
    for vdir, n, proc in jobs:
        out, _ = proc.communicate(timeout=900)
        if proc.returncode != 0:
            raise RuntimeError(f"{vdir} {n}: nvcc failed\n{out}")
        logs[(vdir, n)] = out
    return logs


def bench_ptxas(log):
    """Registers and spill bytes of the bench instantiation (DDA, !SCAT,
    TONLY, not counting)."""
    for part in log.split("Compiling entry function '")[1:]:
        if re.match(r"\S*wf_kernelILi0ELb0ELb1ELi0ELb[01]ELb0E", part):
            regs = re.search(r"Used (\d+) registers", part)
            spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                              r"loads", part)
            return {"registers": int(regs.group(1)),
                    "spill_store_bytes": int(spill.group(1)),
                    "spill_load_bytes": int(spill.group(2))}
    return None


# name: {compile-time constant of csrc/wf_residual.cuh: value; "slabs":
# ops/render.py WALK_SLABS}
RES_VARIANTS = {
    "shipped": {},
    "no_frames": {"WF_RES_FRAMES": 0},
    "no_chords": {"WF_RES_CHORDS": 0},
    "divides": {"WF_RES_DIVS": 0},
    "no_levers": {"WF_RES_FRAMES": 0, "WF_RES_CHORDS": 0, "WF_RES_DIVS": 0},
    "threads128": {"WF_RES_THREADS": 128, "WF_RES_MIN_CTAS": 8},
    "threads512": {"WF_RES_THREADS": 512, "WF_RES_MIN_CTAS": 2},
    "threads1024": {"WF_RES_THREADS": 1024, "WF_RES_MIN_CTAS": 1},
    "walk_ctas8": {"WF_WALK_MIN_CTAS": 8},
    "walk_ctas5": {"WF_WALK_MIN_CTAS": 5},
    "walk_threads128": {"WF_WALK_THREADS": 128, "WF_WALK_MIN_CTAS": 8},
    "walk_chunk32": {"WF_WALK_CHUNK": 32},
    "slabs1": {"slabs": 1},
    "slabs3": {"slabs": 3},
    "slabs4": {"slabs": 4},
    # the per-lane work timed apart, with the levers and without: every
    # lane stopped after its ray's set-up (1), after its first scatter (2)
    "stop_setup": {"WF_RES_STOP": 1},
    "stop_first_scatter": {"WF_RES_STOP": 2},
    "no_levers_stop_setup": {"WF_RES_FRAMES": 0, "WF_RES_CHORDS": 0,
                             "WF_RES_DIVS": 0, "WF_RES_STOP": 1},
    "no_levers_stop_first_scatter": {"WF_RES_FRAMES": 0, "WF_RES_CHORDS": 0,
                                     "WF_RES_DIVS": 0, "WF_RES_STOP": 2},
}
# timed launches of the delta fast loop a variant (median)
RES_REPS = 20


def res_build(work, names):
    """One nvcc per (variant, residual entry point), all started
    together; returns {(variant, entry point): (library, ptxas log)}."""
    from drtvam_tpu_torch.native import CUDA_SRC_DIR, nvcc_path
    jobs = []
    for v in names:
        for n in ("wf_res_fwd", "wf_res_bwd"):
            lib = os.path.join(work, f"lib{n}_{v}.so")
            cmd = [nvcc_path(), "-gencode", "arch=compute_90a,code=sm_90a",
                   "-std=c++17", "-O3", "-Xptxas", "-v", "-shared",
                   "-Xcompiler", "-fPIC", "--fmad=false", "-I", CUDA_SRC_DIR]
            cmd += [f"-D{k}={val}" for k, val in RES_VARIANTS[v].items()
                    if k.startswith("WF_")]
            cmd += [os.path.join(CUDA_SRC_DIR, n + ".cu"), "-o", lib]
            jobs.append((v, n, lib, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
    out = {}
    for v, n, lib, proc in jobs:
        log, _ = proc.communicate(timeout=900)
        if proc.returncode != 0:
            raise RuntimeError(f"{v} {n}: nvcc failed\n{log}")
        out[(v, n)] = (lib, log)
    return out


def res_ptxas(log):
    """Registers and spill bytes of the instantiations the bench runs:
    the delta fast loop (forward, adjoint), the dda path pass and the
    walk pass (not counting)."""
    import chip_smoke as cs
    keep = {}
    for part in log.split("Compiling entry function '")[1:]:
        name = cs.instantiation(part.split("'")[0])
        if "counting" in name or not (
                "FAST_RESIDUAL" in name or "DDA, FIRST_SCATTER, path" in name
                or name == "walk pass"):
            continue
        regs = re.search(r"Used (\d+) registers", part)
        spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                          r"loads", part)
        keep[name] = {"registers": int(regs.group(1)),
                      "spill_store_bytes": int(spill.group(1)),
                      "spill_load_bytes": int(spill.group(2))}
    return keep


def main_residual(names):
    import torch
    import chip_smoke as cs
    from drtvam_tpu_torch.models.scene import Scene
    from drtvam_tpu_torch.ops import render as wf
    from drtvam_tpu_torch.ops.hybrid import ScatteringEngine
    dev = torch.device("cuda:0")
    with tempfile.TemporaryDirectory() as work:
        built = res_build(work, names)
        cfg = cs.bench_scattering_config(work)
        sc = Scene(cfg)
        static, arr = sc.build(mode="volume", include_target=False,
                               max_depth=6, rr_depth=6)
        eng = ScatteringEngine(static, arr, dev, spp=1, estimator="delta")
        st, at = eng.static_s, eng.arr
        static_f, arr_f = sc.build(mode="volume", include_target=False,
                                   max_depth=16, rr_depth=8)
        eng_f = ScatteringEngine(static_f, arr_f, dev, spp=16)
        st_f, at_f = eng_f.static_s, eng_f.arr
        rng = np.random.default_rng(3)  # phase 8b's inputs
        data = torch.from_numpy(rng.uniform(
            0.0, 1.0, st.projector.n_active).astype(np.float32)).to(dev)
        dL = torch.from_numpy(rng.uniform(
            0.0, 1.0, st.sensor.n_cells).astype(np.float32)).to(dev)
        ref = {}
        shipped_slabs = wf.WALK_SLABS
        for v in names:
            wf.WALK_SLABS = RES_VARIANTS[v].get("slabs", shipped_slabs)
            libs = {}
            for n in ("wf_res_fwd", "wf_res_bwd"):
                lib = ctypes.CDLL(built[(v, n)][0])
                wf._setup(lib, n)
                libs[n] = lib
            rec = {"variant": v, **RES_VARIANTS[v],
                   "ptxas": {n: res_ptxas(built[(v, n)][1])
                             for n in ("wf_res_fwd", "wf_res_bwd")}}
            for n, x in (("wf_res_fwd", data), ("wf_res_bwd", dL)):
                call = wf.res_forward if n == "wf_res_fwd" else \
                    wf.res_adjoint
                stats = {}
                out = call(libs, st, at, x, 0, 1, stats)
                torch.cuda.synchronize()
                stop = "WF_RES_STOP" in RES_VARIANTS[v]
                if v == "shipped":
                    ref[n] = out
                    err = 0.0
                elif stop:  # a stopped lane makes no deposit
                    err = None
                else:
                    err = float((out - ref[n]).abs().max())
                    lim = 1e-5 * float(ref[n].abs().max()) \
                        if n == "wf_res_fwd" else 0.0
                    if not err <= lim:
                        raise AssertionError(f"{v} {n}: off the shipped "
                                             f"build by {err}")
                rec[n] = {"ms": cs.cuda_ms(lambda: call(libs, st, at, x, 0,
                                                        1), RES_REPS, torch),
                          "max_abs_err_vs_shipped": err,
                          "simt_efficiency": None if stop else
                          stats["iterations"] / stats["lane_slots"]}
                del out
            if "WF_RES_STOP" in RES_VARIANTS[v]:
                print(json.dumps(rec), flush=True)
                continue
            stats, times = {}, {}
            call = lambda: wf.res_forward(  # noqa: E731
                libs, st_f, at_f, data, 0, 16, stats, times=times)
            ms = cs.cuda_ms(call, 1, torch)
            rec["final_render"] = {
                "ms": ms, **{k: t / 2 for k, t in times.items()},
                "steps": stats["steps"] // 2,
                "batches": stats["batches"] // 2,
                "simt_efficiency": stats["steps"] / stats["lane_slots"],
                "walking_share": stats["walk_steps"] / stats["lane_slots"]}
            print(json.dumps(rec), flush=True)


# name: {compile-time constant of csrc/wf_cull.cuh or wf_mesh.cuh: value;
# "staged": False reads the mesh banks from global memory}
CULL_VARIANTS = {
    "shipped": {},
    "global_banks": {"staged": False},
    "no_frames": {"WF_CULL_FRAMES": 0},
    "no_early_exit": {"WF_MESH_EARLY_EXIT": 0},
    "levers_off": {"WF_CULL_FRAMES": 0, "WF_MESH_EARLY_EXIT": 0,
                   "staged": False},
    "threads128": {"WF_CULL_THREADS": 128, "WF_CULL_MIN_CTAS": 6},
    "threads256": {"WF_CULL_THREADS": 256, "WF_CULL_MIN_CTAS": 3},
    "ctas4": {"WF_CULL_THREADS": 256, "WF_CULL_MIN_CTAS": 4},
    "threads512": {"WF_CULL_THREADS": 512, "WF_CULL_MIN_CTAS": 2},
    "threads1024": {"WF_CULL_THREADS": 1024, "WF_CULL_MIN_CTAS": 1},
}
CULL_REPS = {"radon": 5, "corner": 5, "telecentric": 3}


def cull_build(work, names, parent):
    """One nvcc per (variant, culling entry point), all started together
    (the parent tree's sources as variant "parent"); returns {(variant,
    entry point): (library, ptxas log)}."""
    from drtvam_tpu_torch.native import CUDA_SRC_DIR, nvcc_path
    jobs = []
    for v in names + (["parent"] if parent else []):
        src = os.path.join(parent, "drtvam_tpu_torch", "csrc") \
            if v == "parent" else CUDA_SRC_DIR
        defs = {} if v == "parent" else CULL_VARIANTS[v]
        for n in ("wf_radon", "wf_corner"):
            lib = os.path.join(work, f"lib{n}_{v}.so")
            cmd = [nvcc_path(), "-gencode", "arch=compute_90a,code=sm_90a",
                   "-std=c++17", "-O3", "-Xptxas", "-v", "-shared",
                   "-Xcompiler", "-fPIC", "--fmad=false", "-I", src]
            cmd += [f"-D{k}={val}" for k, val in defs.items()
                    if k.startswith("WF_")]
            cmd += [os.path.join(src, n + ".cu"), "-o", lib]
            jobs.append((v, n, lib, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
    out = {}
    for v, n, lib, proc in jobs:
        log, _ = proc.communicate(timeout=900)
        if proc.returncode != 0:
            raise RuntimeError(f"{v} {n}: nvcc failed\n{log}")
        out[(v, n)] = (lib, log)
    return out


def cull_ptxas(log):
    """Registers and spill bytes of each culling instantiation."""
    import chip_smoke as cs
    keep = {}
    for part in log.split("Compiling entry function '")[1:]:
        regs = re.search(r"Used (\d+) registers", part)
        spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                          r"loads", part)
        keep[cs.instantiation(part.split("'")[0])] = {
            "registers": int(regs.group(1)),
            "spill_store_bytes": int(spill.group(1)) if spill else 0,
            "spill_load_bytes": int(spill.group(2)) if spill else 0}
    return keep


def parent_call(wf, lib, name, static, arr, seed, spp, dist, radius):
    """A launch of the parent tree's culling entry point (its own
    argument list: WfParams, WfMesh, the active pixels, the corner's
    dist and radius, the image, no counters, the stream)."""
    import torch
    P = wf._cull_params(name, static, arr, seed, spp)
    M = wf.make_mesh(name, static, arr)
    p = static.projector
    img = torch.zeros((p.n_patterns * p.resy * p.resx,),
                      dtype=torch.float32, device=arr["active_pixels"].device)
    args = (ctypes.c_float(dist), ctypes.c_float(radius)) \
        if name == "wf_corner" else ()
    err = getattr(lib, name)(ctypes.byref(P), ctypes.byref(M),
                             ctypes.c_void_p(arr["active_pixels"].data_ptr()),
                             *args, ctypes.c_void_p(img.data_ptr()), None,
                             ctypes.c_void_p(wf._stream(img.device)))
    if err != 0:
        raise RuntimeError(f"parent {name}: cudaError_t {err}")
    return img


def main_cull(names, parent):
    import torch
    import chip_smoke as cs
    from drtvam_tpu_torch.models.scene import Scene
    from drtvam_tpu_torch.ops import render as wf
    from drtvam_tpu_torch.ops.march import scene_tensors
    dev = torch.device("cuda:0")
    with tempfile.TemporaryDirectory() as work:
        built = cull_build(work, names, parent)
        cfg = cs.bench_config(work, "cylindrical")
        build = dict(mode="radon", include_target=True, max_depth=5,
                     rr_depth=6, print_time=1.0)
        scenes = {
            "radon": (Scene(cfg).build(regular_sampling=True, **build), 1),
            "corner": (Scene(cs.square_bench_config(work)).build(
                mode="volume", include_target=True, max_depth=1, rr_depth=6,
                print_time=1.0, regular_sampling=True), 1),
            "telecentric": (Scene(cs.telecentric_bench_config(work)).build(
                **build), 4)}
        scenes = {k: (st, scene_tensors(arr, dev), spp)
                  for k, ((st, arr), spp) in scenes.items()}
        no_mesh = Scene(cfg).build(mode="radon", include_target=False,
                                   max_depth=5, rr_depth=6, print_time=1.0,
                                   regular_sampling=True)
        no_mesh = (no_mesh[0], scene_tensors(no_mesh[1], dev))
        ref = {}
        for v in names + (["parent"] if parent else []):
            libs = {}
            for n in ("wf_radon", "wf_corner"):
                lib = ctypes.CDLL(built[(v, n)][0])
                if v != "parent":
                    wf._setup(lib, n)
                libs[n] = lib
            spec = {} if v == "parent" else CULL_VARIANTS[v]
            staged = spec.get("staged", True)
            rec = {"variant": v, **spec,
                   "ptxas": {n: cull_ptxas(built[(v, n)][1])
                             for n in ("wf_radon", "wf_corner")}}
            wf.build_kernels = lambda: libs  # noqa: B023
            for cell, (st, at, spp) in scenes.items():
                name = "wf_corner" if cell == "corner" else "wf_radon"
                if v == "parent":
                    call = lambda: parent_call(  # noqa: E731
                        wf, libs[name], name, st, at, 0, spp, 3.6, 0.2)
                elif name == "wf_corner":
                    call = lambda: wf.wf_corner(  # noqa: E731
                        st, at, 3.6, 0.2, staged=staged)
                else:
                    call = lambda: wf.wf_radon(  # noqa: E731
                        st, at, 0, spp, staged=staged)
                img = call()
                torch.cuda.synchronize()
                if v == "shipped":
                    ref[cell] = img
                same = torch_equal(img, ref[cell])
                if not same:
                    raise AssertionError(f"{v} {cell}: the image differs "
                                         f"from the shipped build's")
                rec[cell] = {"ms": cs.cuda_ms(call, CULL_REPS[cell], torch),
                             "bitwise_vs_shipped": same,
                             "lanes": st.projector.n_active * spp}
                if v != "parent":
                    rec[cell]["launch"] = wf.cull_info(
                        name, st, at, spp, staged=staged)
                del img
            if v in ("shipped", "parent"):
                st, at = no_mesh
                call = (lambda: parent_call(wf, libs["wf_radon"], "wf_radon",
                                            st, at, 0, 1, 0.0, 0.0)) \
                    if v == "parent" else (lambda: wf.wf_radon(st, at, 0, 1))
                rec["radon_no_mesh"] = {"ms": cs.cuda_ms(call, 5, torch)}
            if v == "shipped":
                rec["counts"] = {}
                for cell, (st, at, spp) in scenes.items():
                    stats = {}
                    if cell == "corner":
                        wf.wf_corner(st, at, 3.6, 0.2, 0, stats)
                    else:
                        wf.wf_radon(st, at, 0, spp, stats)
                    lanes = st.projector.n_active * spp
                    rec["counts"][cell] = dict(
                        stats, simt_efficiency=stats["triangles"] /
                        max(stats["triangle_slots"], 1),
                        repeat_share=stats["repeats"] /
                        max(stats["triangles"], 1),
                        lanes_in_box_share=stats["lanes_in_box"] / lanes,
                        triangles_a_lane=stats["triangles"] / lanes)
                stats = {}
                wf.wf_radon(*no_mesh, 0, 1, stats)
                rec["counts"]["radon_no_mesh"] = stats
                st, at, spp = scenes["telecentric"]
                rec["telecentric_vs_plain"] = telecentric_check(
                    cs, wf, st, at, ref["telecentric"], spp)
            print(json.dumps(rec), flush=True)


def torch_equal(a, b):
    return bool((a == b).all())


# name: {WF_TGT_* constants of a wf_target.cu build; TGT_*
# constants of ops/render.py for the variant's run; "one_pass": the
# one-pass kernels of wf_fwd.cu / wf_bwd.cu; "tile": False, their tile
# off; WF_THREADS: their CTA's threads (a rewritten copy)}
TGT_VARIANTS = {
    "shipped": {},
    "threads256": {"WF_TGT_THREADS": 256, "WF_TGT_MIN_CTAS": 2},
    "threads256x1": {"WF_TGT_THREADS": 256, "WF_TGT_MIN_CTAS": 1},
    "threads512": {"WF_TGT_THREADS": 512, "WF_TGT_MIN_CTAS": 1},
    "threads768": {"WF_TGT_THREADS": 768, "WF_TGT_MIN_CTAS": 1},
    # the batches one after another on one stream
    "no_overlap": {"TGT_OVERLAP": False},
    # the record buffer a launch (records of 32 bytes): a batch a half
    # (12 GB), or a quarter of the shipped one's
    "one_batch": {"TGT_MAX_RECORDS": (12 << 30) // 32},
    "records_128mb": {"TGT_MAX_RECORDS": (128 << 20) // 32},
    "unit_lanes_4096": {"TGT_UNIT_LANES": 4096},
    "one_pass": {"one_pass": True},
    "one_pass_no_tile": {"one_pass": True, "tile": False},
    "one_pass_threads512": {"one_pass": True, "WF_THREADS": 512},
    # with --parent ROOT: ROOT's wf_target.cu (its own sources)
    "parent": {"tree": "parent"},
}
# the parent tree (target --parent ROOT)
TGT_PARENT = None
# optimize() steps on cell (b) before its loop patterns are taken
TGT_STEPS = 3


def tgt_build(work, names):
    """One nvcc per variant library (wf_target.cu with its constants, or
    wf_fwd.cu and wf_bwd.cu from a rewritten copy), all started together;
    returns the running jobs."""
    from drtvam_tpu_torch.native import CUDA_SRC_DIR, nvcc_path
    jobs = []
    for v in names:
        spec = TGT_VARIANTS[v]
        base = [nvcc_path(), "-gencode", "arch=compute_90a,code=sm_90a",
                "-std=c++17", "-O3", "-Xptxas", "-v", "-shared",
                "-Xcompiler", "-fPIC", "--fmad=false"]
        if "WF_THREADS" in spec:
            vdir = source_dir(work, spec)
            variant_source(CUDA_SRC_DIR, vdir, spec)
            srcs = [(n, vdir, []) for n in ("wf_fwd", "wf_bwd")]
        elif spec.get("tree") == "parent":
            srcs = [("wf_target", os.path.join(TGT_PARENT, "drtvam_tpu_torch",
                                               "csrc"), [])]
        elif any(k.startswith("WF_") for k in spec):
            srcs = [("wf_target", CUDA_SRC_DIR,
                     [f"-D{k}={val}" for k, val in spec.items()])]
        else:
            continue
        for n, src, defs in srcs:
            lib = os.path.join(work, f"lib{n}_{v}.so")
            cmd = base + defs + ["-I", src, os.path.join(src, n + ".cu"),
                                 "-o", lib]
            jobs.append((v, n, lib, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
    return jobs


def tgt_ptxas(log):
    """Registers and spill bytes of the target instantiations cells (b)
    and (d) run (DDA, !SCAT and DELTA, SCAT: the path and walk passes, the
    delta form, the staged adjoint, the one-pass forward and adjoint with
    the target; not counting)."""
    import chip_smoke as cs
    keep = {}
    for part in log.split("Compiling entry function '")[1:]:
        name = cs.instantiation(part.split("'")[0])
        if "counting" in name or not (
                "target" in name and ("DDA, !SCAT" in name or "DELTA, SCAT"
                                      in name or "walk" in name)):
            continue
        regs = re.search(r"Used (\d+) registers", part)
        spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                          r"loads", part)
        keep[name] = {"registers": int(regs.group(1)),
                      "spill_store_bytes": int(spill.group(1)),
                      "spill_load_bytes": int(spill.group(2))}
    return keep


def main_target(names, cell="b"):
    import torch
    import chip_smoke as cs
    from drtvam_tpu_torch.native import BUILD_DIR
    from drtvam_tpu_torch.ops import render as wf
    dev = torch.device("cuda:0")
    torch.zeros(1, device=dev)  # create the context before the memory stats
    with tempfile.TemporaryDirectory() as work:
        jobs = tgt_build(work, names)
        shipped = wf.build_kernels()
        built, logs = {}, {}
        for v, n, lib, proc in jobs:
            log, _ = proc.communicate(timeout=900)
            if proc.returncode != 0:
                raise RuntimeError(f"{v} {n}: nvcc failed\n{log}")
            built[(v, n)] = lib
            logs[(v, n)] = log
        for n in ("wf_fwd", "wf_bwd", wf.TGT_LIB):
            with open(os.path.join(BUILD_DIR, f"lib{n}.so.log")) as f:
                logs[("shipped", n)] = f.read()
        if cell == "d":
            cfg = cs.scatter_cuvette_config(work)
            cfg["n_steps"] = TGT_STEPS
            with cs.CallSpy(wf, by_depth=True) as spy:
                cs.optimize_on_card(torch, dev, cfg)
            st2, at2, data, seed, spp = spy.calls["wf_fwd:target1:depth6"]
            dL = torch.rand(st2.sensor.n_cells, generator=torch.Generator(
                dev).manual_seed(5), device=dev)
            forms = {"wf_fwd, delta": ("wf_fwd", st2, data),
                     "wf_bwd, delta": ("wf_bwd", st2, dL)}
        else:
            cfg = cs.sa_cell_config(work, "b")
            cfg["n_steps"] = TGT_STEPS
            with cs.CallSpy(wf) as spy:
                cs.optimize_on_card(torch, dev, cfg)
            st2, at2, data, seed, spp = spy.calls["wf_fwd:target2"]
            st1 = cs.one_channel_target(st2)
            st0, at0 = cs.strip_to_one_channel(st2, at2)
            at0 = dict(at0)
            dL = torch.rand(st2.sensor.n_cells, generator=torch.Generator(
                dev).manual_seed(5), device=dev)
            forms = {"wf_fwd, 2 channels": ("wf_fwd", st2, data),
                     "wf_fwd, 1 channel": ("wf_fwd", st1, data),
                     "wf_bwd, 2 channels": ("wf_bwd", st2, dL)}
        tile_rows = wf.tile_rows
        shipped_consts = {k: getattr(wf, k) for k in (
            "TGT_MAX_RECORDS", "TGT_UNIT_LANES", "TGT_OVERLAP")}
        ref = {}
        for v in names:
            spec = TGT_VARIANTS[v]
            libs = dict(shipped)
            for (bv, n), lib in built.items():
                if bv == v:
                    libs[n] = ctypes.CDLL(lib)
                    wf._setup(libs[n], n)
            wf.build_kernels = lambda: libs  # noqa: B023
            if spec.get("tile", True):
                wf.tile_rows = tile_rows
            else:
                wf.tile_rows = lambda static, arr: (tile_rows(static, arr)[0],
                                                    0)
            at2.pop("_wf_layout", None)
            for k in ("_wf_tgt_units", "_wf_tgt_est"):
                at2.pop(k, None)
            for k, val in shipped_consts.items():
                setattr(wf, k, spec.get(k, val))
            rec = {"variant": v, **spec,
                   "ptxas": {n: tgt_ptxas(log) for (bv, n), log in
                             logs.items() if bv == v}}
            route = cs.OnePass(wf) if spec.get("one_pass") else \
                contextlib.nullcontext()
            with route:
                for key, (name, st, x) in forms.items():
                    def call():
                        return getattr(wf, name)(  # noqa: B023
                            st, at2, x, seed, spp)  # noqa: B023
                    out = call()
                    torch.cuda.synchronize()
                    if v == "shipped":
                        ref[key] = out
                    if name == "wf_bwd":
                        cmp = {"bitwise_vs_shipped": torch_equal(out,
                                                                 ref[key])}
                        if not cmp["bitwise_vs_shipped"]:
                            raise AssertionError(f"{v} {key}: differs from "
                                                 "the shipped build's")
                    else:
                        cmp = cs.channel_compare(f"{v} {key}", out, ref[key],
                                                 st.sensor.channels, False)
                    del out
                    rec[key] = {"ms": cs.cuda_ms(call, 3, torch), **cmp,
                                "launch": wf.kernel_info(name, st, at2)}
                    if v == "shipped":
                        stats, times = {}, {}
                        getattr(wf, name)(st, at2, x, seed, spp, stats)
                        if name == "wf_fwd":
                            wf.wf_fwd(st, at2, x, seed, spp, times=times)
                        if name == "wf_fwd" and cell == "b":
                            rec[key]["walk_launch"] = wf.kernel_info(
                                "wf_tgt_walk", st, at2)
                        rec[key].update(counts=stats, **times)
            if v == "shipped" and cell == "b":
                rec["mesh off"] = {
                    n: cs.cuda_ms(lambda: getattr(wf, n)(  # noqa: B023
                        st0, at0, x, seed, spp), 3, torch)  # noqa: B023
                    for n, x in (("wf_fwd", data),
                                 ("wf_bwd", dL.reshape(-1, 2)[:, 0]
                                  .contiguous()))}
            print(json.dumps(rec), flush=True)


# name: {WF_RTP_* constants of a wf_res_target.cu build;
# RES_TGT_SMEM_LIMIT of ops/render.py; "one_pass": the one-pass
# instantiation (wf_res_path with the target)}
RTP_VARIANTS = {
    "shipped": {},
    "one_pass": {"one_pass": True},
    "global_banks": {"RES_TGT_SMEM_LIMIT": 0},
    "threads256": {"WF_RTP_THREADS": 256, "WF_RTP_MIN_CTAS": 3},
    "threads512": {"WF_RTP_THREADS": 512, "WF_RTP_MIN_CTAS": 2},
    "threads512x1": {"WF_RTP_THREADS": 512, "WF_RTP_MIN_CTAS": 1},
    "chunk8": {"WF_RTP_CHUNK": 8},
    "chunk128": {"WF_RTP_CHUNK": 128},
}
# optimize() steps on cell (a) before its final render's inputs are taken
RTP_STEPS = 3


def rtp_build(work, names):
    """One nvcc per variant build of wf_res_target.cu, all started
    together; returns the running jobs."""
    from drtvam_tpu_torch.native import CUDA_SRC_DIR, nvcc_path
    jobs = []
    for v in names:
        defs = [f"-D{k}={val}" for k, val in RTP_VARIANTS[v].items()
                if k.startswith("WF_")]
        if not defs:
            continue
        lib = os.path.join(work, f"libwf_res_target_{v}.so")
        cmd = [nvcc_path(), "-gencode", "arch=compute_90a,code=sm_90a",
               "-std=c++17", "-O3", "-Xptxas", "-v", "-shared",
               "-Xcompiler", "-fPIC", "--fmad=false", "-I", CUDA_SRC_DIR,
               *defs, os.path.join(CUDA_SRC_DIR, "wf_res_target.cu"), "-o",
               lib]
        jobs.append((v, lib, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    return jobs


def rtp_ptxas(log, path_pass):
    """Registers and spill bytes of the dda first-scatter path pass's
    instantiation with the target (not counting): the target form's with
    its banks staged or (path_pass "global") in global memory, or
    (path_pass "one_pass") the one-pass res_kernel's."""
    import chip_smoke as cs
    want = {"staged": "residual target path pass, DDA, FIRST_SCATTER, "
                      "staged",
            "global": "residual target path pass, DDA, FIRST_SCATTER, "
                      "global banks",
            "one_pass": "residual DDA, FIRST_SCATTER, path pass, "
                        "target"}[path_pass]
    for part in log.split("Compiling entry function '")[1:]:
        if cs.instantiation(part.split("'")[0]) != want:
            continue
        regs = re.search(r"Used (\d+) registers", part)
        spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                          r"loads", part)
        return {"registers": int(regs.group(1)),
                "spill_store_bytes": int(spill.group(1)),
                "spill_load_bytes": int(spill.group(2))}
    return None


def rtp_run(torch, cs, wf, static, at, data, seed, spp):
    """The forward's counting launch, then one timed launch with its
    passes apart; returns (dose, record)."""
    stats, times = {}, {}
    wf.wf_res_fwd(static, at, data, seed, spp, stats)
    torch.cuda.synchronize()
    ms, dose = cs.event_ms(lambda: wf.wf_res_fwd(static, at, data, seed, spp,
                                                 times=times), torch)
    ms_overlapped, _ = cs.event_ms(lambda: wf.wf_res_fwd(
        static, at, data, seed, spp), torch)
    rec = {"ms": ms, "ms_overlapped": ms_overlapped, **times,
           "counts": stats,
           "launch": wf.kernel_info("wf_res_fwd", static, at)}
    for key, slots in (("iterations", "iteration_slots"),
                       ("triangles", "triangle_slots")):
        rec[f"{key}_simt_efficiency"] = (stats.get(key, 0) / stats[slots]
                                         if stats.get(slots) else None)
    lanes = static.projector.n_active * spp
    rec["per_lane"] = {k: stats.get(k, 0) / lanes for k in (
        "iterations", "records", "walks", "cells", "triangles")}
    if stats.get("walks"):
        rec["triangles_per_walk"] = stats["triangles"] / stats["walks"]
    return dose, rec


def main_res_target(names):
    import torch
    import chip_smoke as cs
    from drtvam_tpu_torch.native import BUILD_DIR
    from drtvam_tpu_torch.ops import render as wf
    dev = torch.device("cuda:0")
    torch.zeros(1, device=dev)  # create the context before the memory stats
    with tempfile.TemporaryDirectory() as work:
        jobs = rtp_build(work, names)
        shipped = wf.build_kernels()
        built, logs = {}, {}
        for v, lib, proc in jobs:
            log, _ = proc.communicate(timeout=900)
            if proc.returncode != 0:
                raise RuntimeError(f"{v}: nvcc failed\n{log}")
            built[v], logs[v] = lib, log
        for n, v in ((wf.RES_TGT_LIB, "shipped"), ("wf_res_fwd", "one_pass")):
            with open(os.path.join(BUILD_DIR, f"lib{n}.so.log")) as f:
                logs[v] = f.read()
        cfg = cs.sa_cell_config(work, "a")
        cfg["n_steps"] = RTP_STEPS
        with cs.CallSpy(wf) as spy:
            cs.optimize_on_card(torch, dev, cfg)
        st, at, data, seed, spp = spy.calls["wf_res_fwd:target1"]
        ref = None
        for v in names:
            spec = RTP_VARIANTS[v]
            libs = dict(shipped)
            if v in built:
                libs[wf.RES_TGT_LIB] = ctypes.CDLL(built[v])
                wf._setup(libs[wf.RES_TGT_LIB], wf.RES_TGT_LIB)
            wf.build_kernels = lambda: libs  # noqa: B023
            wf.RES_TGT_SMEM_LIMIT = spec.get("RES_TGT_SMEM_LIMIT", 1 << 30)
            route = cs.OnePass(wf) if spec.get("one_pass") else \
                contextlib.nullcontext()
            with route:
                dose, rec = rtp_run(torch, cs, wf, st, at, data, seed, spp)
            if ref is None:
                ref = dose
                cmp = {"max_abs_err_vs_shipped": 0.0}
            else:
                cmp = cs.channel_compare(f"{v} final render", dose, ref, 1,
                                         False)
            del dose
            rec = {"variant": v, **spec, **rec, **cmp,
                   "ptxas": rtp_ptxas(logs.get(v, logs["shipped"]),
                                      "one_pass" if spec.get("one_pass")
                                      else "global" if "RES_TGT_SMEM_LIMIT"
                                      in spec else "staged")}
            if v == "shipped":
                st0, at0 = cs.strip_to_one_channel(st, at)
                _, rec["mesh off"] = rtp_run(torch, cs, wf, st0, dict(at0),
                                             data, seed, spp)
            print(json.dumps(rec), flush=True)
            torch.cuda.empty_cache()


def telecentric_check(cs, wf, static, arr, img, spp):
    """The telecentric radon image against the plain march on the pixels
    of every cs.RADON_CHECK_STRIDE-th angle: pixels that differ, the
    largest difference, the image's max there."""
    import torch
    p = static.projector
    per_angle = p.resy * p.resx
    pix = (torch.arange(0, p.n_patterns, cs.RADON_CHECK_STRIDE,
                        device=img.device)[:, None] * per_angle +
           torch.arange(per_angle, device=img.device)).reshape(-1)
    ref = cs.radon_plain_pixels(torch, static, arr, pix, 0, spp)
    got = img[pix]
    return {"pixels": pix.numel(), "differ": int((got != ref).sum()),
            "max_abs_err": float((got - ref).abs().max()),
            "max_abs_plain": float(ref.abs().max())}


# name: {WF_MED_* constants of a wf_med.cu build}
MED_VARIANTS = {
    "shipped": {},
    "threads512": {"WF_MED_THREADS": 512},
    "threads1024": {"WF_MED_THREADS": 1024},
    "staged1024": {"WF_MED_STAGED_THREADS": 1024},
}
# the medium the variants' dL is taken at, against the dose recorded at
# chip_smoke.MED_ST_TRUE
MED_ST = 0.025


def med_build(work, names):
    """One nvcc per variant library (wf_med.cu with the variant's
    constants), all started together; returns the jobs."""
    from drtvam_tpu_torch.native import CUDA_SRC_DIR, nvcc_path
    jobs = []
    for v in names:
        spec = MED_VARIANTS[v]
        if not spec:
            continue
        lib = os.path.join(work, f"libwf_med_{v}.so")
        cmd = [nvcc_path(), "-gencode", "arch=compute_90a,code=sm_90a",
               "-std=c++17", "-O3", "-Xptxas", "-v", "-shared",
               "-Xcompiler", "-fPIC", "--fmad=false"] + [
            f"-D{k}={val}" for k, val in spec.items()] + [
            "-I", CUDA_SRC_DIR, os.path.join(CUDA_SRC_DIR, "wf_med.cu"),
            "-o", lib]
        jobs.append((v, lib, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    return jobs


def med_ptxas(log, want):
    """Registers and spill bytes of the instantiation named want
    (chip_smoke.instantiation's spelling; a staged one by its start) in an
    nvcc -Xptxas -v log."""
    import chip_smoke as cs
    for part in log.split("Compiling entry function '")[1:]:
        name = cs.instantiation(part.split("'")[0])
        if name != want and not (want.endswith("staged") and
                                 name.startswith(want + ",")):
            continue
        regs = re.search(r"Used (\d+) registers", part)
        spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                          r"loads", part)
        return {"registers": int(regs.group(1)),
                "spill_store_bytes": int(spill.group(1)) if spill else 0,
                "spill_load_bytes": int(spill.group(2)) if spill else 0}
    raise AssertionError(f"{want} not in the build log")


def med_name(P, staged=False):
    """chip_smoke.instantiation's name of the medium adjoint's
    instantiation for P (staged: its start, the threads follow)."""
    import chip_smoke as cs
    return ("medium adjoint"
            + f", {cs.WF_EST[P.estimator]}, "
            f"{'' if P.has_scattering else '!'}SCAT, "
            f"{'' if P.transmission_only else '!'}TONLY"
            + (", target" if P.target else "") + (", staged" if staged
                                                  else ""))


def med_variant_libs(wf, shipped, built, v):
    """The shipped libraries with variant v's wf_med in its place."""
    libs = dict(shipped)
    if v in built:
        libs[wf.MED_LIB] = ctypes.CDLL(built[v])
        wf._setup(libs[wf.MED_LIB], wf.MED_LIB)
    return libs


def med_logs(wf, jobs):
    """{variant: library} and {variant: nvcc log} of the builds, the
    shipped build's log beside them."""
    from drtvam_tpu_torch.native import BUILD_DIR
    built, logs = {}, {}
    for v, lib, proc in jobs:
        log, _ = proc.communicate(timeout=900)
        if proc.returncode != 0:
            raise RuntimeError(f"{v}: nvcc failed\n{log}")
        built[v], logs[v] = lib, log
    with open(os.path.join(BUILD_DIR, f"lib{wf.MED_LIB}.so.log")) as f:
        logs["shipped"] = f.read()
    return built, logs


def main_med_cell_c(names):
    """The medium adjoint staged and one-pass on cell (c)'s loop inputs
    (its optimize() run, the last depth-6 calls) with medium_grads, for
    each variant: times (median of 5), the sums of both routes bitwise
    equal, registers and spills."""
    import torch
    import chip_smoke as cs
    from drtvam_tpu_torch.ops import render as wf
    dev = torch.device("cuda:0")
    torch.zeros(1, device=dev)  # create the context before the memory stats
    with tempfile.TemporaryDirectory() as work:
        jobs = med_build(work, names)
        shipped = wf.build_kernels()
        with cs.CallSpy(wf, by_depth=True) as spy:
            cs.optimize_on_card(torch, dev, cs.custom_cell_config(work))
        st, at, data, seed, spp = spy.calls["wf_fwd:target1:depth6"]
        dL = spy.calls["wf_bwd:target1:depth6"][2]
        sm = cs.med_static(st)
        built, logs = med_logs(wf, jobs)
        P = wf.make_params(sm, at, 0, 1)
        print(json.dumps({"record": "cell (c)", "n_active": data.numel(),
                          "zero_share": float((data == 0).float().mean()),
                          "wf_bwd_ms": cs.cuda_ms(lambda: wf.wf_bwd(
                              st, at, dL, seed, spp), 5, torch)}),
              flush=True)
        for v in names:
            libs = med_variant_libs(wf, shipped, built, v)
            rec, sums = {"variant": v, **MED_VARIANTS[v]}, {}
            for staged in (True, False):
                route = contextlib.nullcontext() if staged else \
                    cs.OnePass(wf)
                with route:
                    def call():
                        return wf.med_adjoint(  # noqa: B023
                            libs, sm, at, dL, data, seed, spp)
                    stg, ssg = call()
                    torch.cuda.synchronize()
                    ms = cs.cuda_ms(call, 5, torch)
                sums[staged] = (float(stg), float(ssg))
                rec["staged" if staged else "one-pass"] = {
                    "ms": ms, "ptxas": med_ptxas(logs[v],
                                                 med_name(P, staged))}
            if sums[True] != sums[False]:
                raise AssertionError(f"{v}: staged sums {sums}")
            rec.update(stg=sums[True][0], ssg=sums[True][1])
            print(json.dumps(rec), flush=True)


def main_med(names, share_only):
    import torch
    import chip_smoke as cs
    from drtvam_tpu_torch.models.scene import Scene
    from drtvam_tpu_torch.ops import backproject as bp
    from drtvam_tpu_torch.ops import render as wf
    from drtvam_tpu_torch.ops.march import scene_tensors
    from drtvam_tpu_torch.opt.loss import losses
    dev = torch.device("cuda:0")
    torch.zeros(1, device=dev)  # create the context before the memory stats
    with tempfile.TemporaryDirectory() as work:
        jobs = [] if share_only else med_build(work, names)
        wf.build_kernels()
        cs.phase_wf_bench(torch, wf, bp, dev, work)
        torch.cuda.empty_cache()
        cfg = cs.bench_config(work, "cylindrical")
        proj = {k: v for k, v in cfg["projector"].items()
                if k not in ("n_patterns", "resx", "resy")}
        cfg["projector"] = dict(proj, patterns=os.path.join(
            work, "bench_wavefront", "patterns.npz"))
        scenes = {}
        for st_v in (cs.MED_ST_TRUE, MED_ST):
            c = json.loads(json.dumps(cfg))
            c["vial"]["medium"]["extinction"] = st_v
            sc = Scene(c)
            static, arr = sc.build(mode="volume", include_target=False)
            scenes[st_v] = (cs.med_static(static), scene_tensors(arr, dev))
        data = torch.as_tensor(sc.projector.active_data, device=dev)
        inv_vol = float(sc.sensor.inv_volume(None))
        counts, share = cs.emitting_counts(torch, wf, *scenes[MED_ST], data)
        rec = {"record": "patterns", "n_active": data.numel(),
               "zero_share": float((data == 0).float().mean()),
               "emitting_share": share, "ctas": counts.numel(),
               "tasks_all_pixels": wf.med_tasks(*scenes[MED_ST])[1],
               "tasks_emitting": int(((counts + 31) // 32).sum())}
        print(json.dumps(rec), flush=True)
        if share_only:
            return
        built, logs = med_logs(wf, jobs)
        static, at = scenes[MED_ST]
        with torch.no_grad():
            measured = wf.render(*scenes[cs.MED_ST_TRUE], data, inv_vol, 0, 1)
            v = wf.render(static, at, data, inv_vol, 0, 1)
        v.requires_grad_(True)
        with torch.enable_grad():
            (dvol,) = torch.autograd.grad(
                losses["l2"]({})(v, measured, data), v)
        dL = (dvol * inv_vol).reshape(-1).contiguous()
        del measured, v, dvol, scenes
        torch.cuda.empty_cache()
        bwd_ms = cs.cuda_ms(lambda: wf.wf_bwd(static, at, dL, 0, 1), 5, torch)
        P = wf.make_params(static, at, 0, 1)
        shipped = wf.build_kernels()
        ref = None
        for v in names:
            libs = med_variant_libs(wf, shipped, built, v)

            def call():
                return wf.med_adjoint(libs, static, at, dL,  # noqa: B023
                                      data, 0, 1)
            stg, ssg = call()
            torch.cuda.synchronize()
            if ref is None:
                ref = (float(stg), float(ssg))
            r = {"variant": v, **MED_VARIANTS[v], "wf_bwd_ms": bwd_ms,
                 "ms": cs.cuda_ms(call, 5, torch),
                 "stg": float(stg), "ssg": float(ssg),
                 "stg_rel_vs_shipped": cs.med_rel(stg, ref[0]),
                 "ssg_rel_vs_shipped": cs.med_rel(ssg, ref[1]),
                 "ptxas": med_ptxas(logs[v], med_name(P))}
            if not (r["stg_rel_vs_shipped"] <= cs.MED_TOL and
                    r["ssg_rel_vs_shipped"] <= cs.MED_TOL):
                raise AssertionError(f"{v}: {r}")
            print(json.dumps(r), flush=True)


def main():
    if sys.argv[1:2] == ["med"]:
        args = sys.argv[2:]
        flag = args[0] if args[:1] in (["--share"], ["--cell-c"]) else None
        names = (args[1:] if flag else args) or list(MED_VARIANTS)
        unknown = [n for n in names if n not in MED_VARIANTS]
        if unknown:
            sys.exit(f"med variants: {list(MED_VARIANTS)}; unknown "
                     f"{unknown}")
        names = ["shipped"] + [n for n in names if n != "shipped"]
        smi = subprocess.run(["nvidia-smi", "-i", "0",
                              "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=60, check=True)
        print(smi.stdout.strip(), flush=True)
        if flag == "--cell-c":
            main_med_cell_c(names)
        else:
            main_med(names, flag == "--share")
        return
    if sys.argv[1:2] == ["res_target"]:
        names = sys.argv[2:] or list(RTP_VARIANTS)
        unknown = [n for n in names if n not in RTP_VARIANTS]
        if unknown:
            sys.exit(f"res_target variants: {list(RTP_VARIANTS)}; unknown "
                     f"{unknown}")
        names = ["shipped"] + [n for n in names if n != "shipped"]
        smi = subprocess.run(["nvidia-smi", "-i", "0",
                              "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=60, check=True)
        print(smi.stdout.strip(), flush=True)
        main_res_target(names)
        return
    if sys.argv[1:2] == ["target"]:
        global TGT_PARENT
        args = sys.argv[2:]
        if args[:1] == ["--parent"]:
            TGT_PARENT, args = os.path.abspath(args[1]), args[2:]
        cell = "b"
        if args[:1] == ["--cell-d"]:
            cell, args = "d", args[1:]
        names = args or [v for v in TGT_VARIANTS
                         if TGT_PARENT or "tree" not in TGT_VARIANTS[v]]
        unknown = [n for n in names if n not in TGT_VARIANTS]
        if unknown:
            sys.exit(f"target variants: {list(TGT_VARIANTS)}; unknown "
                     f"{unknown}")
        names = ["shipped"] + [n for n in names if n != "shipped"]
        smi = subprocess.run(["nvidia-smi", "-i", "0",
                              "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=60, check=True)
        print(smi.stdout.strip(), flush=True)
        main_target(names, cell)
        return
    if sys.argv[1:2] == ["cull"]:
        args = sys.argv[2:]
        parent = None
        if args[:1] == ["--parent"]:
            parent, args = os.path.abspath(args[1]), args[2:]
        names = args or list(CULL_VARIANTS)
        unknown = [n for n in names if n not in CULL_VARIANTS]
        if unknown:
            sys.exit(f"cull variants: {list(CULL_VARIANTS)}; unknown "
                     f"{unknown}")
        names = ["shipped"] + [n for n in names if n != "shipped"]
        smi = subprocess.run(["nvidia-smi", "-i", "0",
                              "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=60, check=True)
        print(smi.stdout.strip(), flush=True)
        main_cull(names, parent)
        return
    if sys.argv[1:2] == ["residual"]:
        names = sys.argv[2:] or list(RES_VARIANTS)
        unknown = [n for n in names if n not in RES_VARIANTS]
        if unknown:
            sys.exit(f"residual variants: {list(RES_VARIANTS)}; unknown "
                     f"{unknown}")
        names = ["shipped"] + [n for n in names if n != "shipped"]
        smi = subprocess.run(["nvidia-smi", "-i", "0",
                              "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=60, check=True)
        print(smi.stdout.strip(), flush=True)
        main_residual(names)
        return
    names = sys.argv[1:] or list(VARIANTS)
    unknown = [n for n in names if n not in VARIANTS]
    if unknown or "shipped" not in names:
        sys.exit(f"variants: {list(VARIANTS)} (shipped first, always); "
                 f"unknown {unknown}")
    names = ["shipped"] + [n for n in names if n != "shipped"]
    import torch
    if not torch.cuda.is_available():
        sys.exit("wf_variants: torch.cuda.is_available() is false")
    import chip_smoke as cs
    from drtvam_tpu_torch.models.scene import Scene
    from drtvam_tpu_torch.ops import render as wf
    from drtvam_tpu_torch.ops.march import scene_tensors
    global SHIPPED_ANGLES, SHIPPED_TILE_ROWS
    SHIPPED_ANGLES, SHIPPED_TILE_ROWS = wf.ANGLES_PER_GROUP, wf.tile_rows

    smi = subprocess.run(["nvidia-smi", "-i", "0",
                          "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    print(smi.stdout.strip(), flush=True)
    dev = torch.device("cuda:0")
    with tempfile.TemporaryDirectory() as work:
        logs = build(work, names)
        static, arr = Scene(cs.bench_config(work, "cylindrical")).build(
            mode="volume", include_target=False)
        at = scene_tensors(arr, dev)
        rng = np.random.default_rng(3)  # phase 8's inputs
        data = torch.from_numpy(rng.uniform(
            0.0, 1.0, static.projector.n_active).astype(np.float32)).to(dev)
        dL = torch.from_numpy(rng.uniform(
            0.0, 1.0, static.sensor.n_cells).astype(np.float32)).to(dev)
        # the final render's launch: spp 16 on the scene as optimize()
        # builds it for the final render (max_depth 16, rr_depth 8)
        static_f, arr_f = Scene(cs.bench_config(work, "cylindrical")).build(
            mode="volume", include_target=False, max_depth=16, rr_depth=8)
        at_f = scene_tensors(arr_f, dev)
        ref = {}
        for v in names:
            libs = {}
            vdir = source_dir(work, VARIANTS[v])
            for n in ("wf_fwd", "wf_bwd"):
                lib = ctypes.CDLL(os.path.join(vdir, f"lib{n}.so"))
                wf._setup(lib, n)
                libs[n] = lib
            patched(wf, VARIANTS[v], libs)
            at.pop("_wf_layout", None)
            at_f.pop("_wf_layout", None)
            rec = {"variant": v, **VARIANTS[v]}
            for n, x in (("wf_fwd", data), ("wf_bwd", dL)):
                call = getattr(wf, n)
                stats = {}
                out = call(static, at, x, 0, 1, stats)
                torch.cuda.synchronize()
                if v == "shipped":
                    ref[n] = out
                    err = 0.0
                else:
                    err = float((out - ref[n]).abs().max())
                    lim = 1e-5 * float(ref[n].abs().max()) \
                        if n == "wf_fwd" else 0.0
                    if not err <= lim:
                        raise AssertionError(f"{v} {n}: off the shipped "
                                             f"pair by {err}")
                rec[n] = {
                    "ms": cs.cuda_ms(lambda: call(static, at, x, 0, 1), 5,
                                     torch),
                    "max_abs_err_vs_shipped": err,
                    "tile_share": stats["tile_deposits"] / (
                        stats["tile_deposits"] + stats["global_deposits"]),
                    "simt_efficiency": stats["steps"] / stats["lane_slots"],
                    "launch": wf.kernel_info(n, static, at),
                    "ptxas": bench_ptxas(logs[(vdir, n)])}
                del out
            if v in SPP16:
                rec["wf_fwd"]["spp16_ms"] = cs.cuda_ms(
                    lambda: wf.wf_fwd(static_f, at_f, data, 0, 16), 3, torch)
            rec["wf_fwd"]["bench_scene_spp_ms"] = {
                spp: cs.cuda_ms(lambda: wf.wf_fwd(static, at, data, 0, spp),
                                3, torch)
                for spp in SPP_SWEEP.get(v, ())}
            print(json.dumps(rec), flush=True)


if __name__ == "__main__":
    main()
