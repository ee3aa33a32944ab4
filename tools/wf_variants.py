#!/usr/bin/env python3
"""Variants of the wavefront kernel pair, timed on one card.

    python3 tools/wf_variants.py [VARIANT ...]   (default: all; "shipped"
                                                  always runs, first)

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
"""
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
      trace_lane<EST, SCAT, TONLY, RES>(
          P, G, (uint32_t)aidx * (uint32_t)P.spp + (uint32_t)k, aidx,
          active_pixels, em, S, chords);
    }"""
FORWARD_NEW = {
    "pixel_lanes": """    if (em == 0.0f) return aidx;
    for (int k = 0; k < P.spp; ++k)
      trace_lane<EST, SCAT, TONLY, RES>(
          P, G, (uint32_t)aidx * (uint32_t)P.spp + (uint32_t)k, aidx,
          active_pixels, em, S, chords);""",
    "straight_call": """    if (em == 0.0f) return aidx;
    trace_lane<EST, SCAT, TONLY, RES>(
        P, G, (uint32_t)aidx * (uint32_t)P.spp + (uint32_t)(t % P.spp),
        aidx, active_pixels, em, S, chords);"""}
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


def main():
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
