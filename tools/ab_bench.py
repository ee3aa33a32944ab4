#!/usr/bin/env python3
"""Bench phases of two trees on one card, in turns.

    python3 tools/ab_bench.py PARENT_ROOT [ballistic|wavefront|hybrid|cull|
                                           target [dda|delta]] [--pairs N]

run from the root of the changed tree, on a machine with one NVIDIA GPU.
PARENT_ROOT is an unpacked copy of the parent commit (`git archive`).
Each turn (parent, change, change, parent) is a fresh process that
builds that tree's kernels and runs its own chip_smoke.py code:

  ballistic (the default): phases 4 and 5, optimize() on the bench
    scene with the cylindrical and the index-matched vial;
  wavefront: phase 8's two full-width kernel timings (wf_fwd and
    wf_bwd on the bench scene, 64 M lanes, the same numpy-seeded
    inputs, CUDA events, median of 5), wf_fwd as the final render
    launches it (spp 16, 1.02 G lanes, median of 3), and phase 9,
    optimize() on the bench scene with engine 'wavefront';
  hybrid: the residual pair on the bench scattering scene (albedo 0.5)
    at full width, the delta fast loop at spp 1 each way (64 M lanes,
    phase 8b's inputs, median of 20) and the dda first-scatter forward
    as the final render launches it (spp 16, 1.02 G lanes, median of 3),
    then phase 10, optimize() on that scene under 'auto' (the hybrid
    engine: its loop and its final render). Six turns (parent, change,
    change, parent, parent, change): three each way;
  cull: phase 11's three full-width culling renders (the bench scene's
    radon render, regular sampling, spp 1, 64 M lanes; the square bench
    vial's corner render, 64 M lanes; the telecentric bench scene's
    radon render at spp 4, 256 M lanes; CUDA events, median of 5, 5 and
    3), then phase 11's culled optimize() runs (filter_radon on the
    bench scene, filter_corner on the square bench vial, filter_radon on
    the telecentric bench scene). Six turns, as hybrid;
  target: chip_smoke.py phase 13's cells through optimize() (cell (b):
    the bench scene with a surface-aware film on the wavefront; cell (a):
    the surface-aware square scattering cell, the hybrid engine), their
    wall split and IoU, then the loop kernels' target forms on each
    cell's own last inputs (CUDA events): cell (b)'s two-channel wf_fwd
    and wf_bwd and its wf_fwd with the film cut to one channel (median
    of 5), and cell (a)'s final-render dda residual with the target at
    spp 16 (median of 3, with its path and walk passes apart: their
    means over the four launches; then as the render calls it, without
    the passes' timers, median of 3). Six turns, as hybrid. With the
    estimator delta: chip_smoke.py's cell (d) instead (cell (c)'s
    custom cuvette and occlusion with a scattering resin, albedo 0.5,
    depths 6, the delta sensor, spp 1, spp_ref 16, engine auto; its
    configuration built from cell (c)'s, which a parent tree has too)
    through optimize(), its wall split and form launches, then its loop
    forward on the last loop inputs (median of 5). Six turns.

--pairs N: N turns each way instead (parent, change, change, parent,
repeated and cut to 2 N turns).

Every JSON record a turn prints is tagged with the turn; the last line
is each tree's median over its turns of every timed number, and for
each the change's turns less the parent's, taken in turn order as pairs
(the i-th change turn less the i-th parent turn): their mean, its
standard error and the pairs. Compares two versions only within one
call, as timings move from card to card.
"""
import json
import os
import subprocess
import sys

import numpy as np

BALLISTIC = """
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

WAVEFRONT = """
import json, os, sys, tempfile
sys.path.insert(0, os.getcwd())
import numpy as np
import torch
import chip_smoke as cs
from drtvam_tpu_torch.models.scene import Scene
from drtvam_tpu_torch.ops import backproject as bp
from drtvam_tpu_torch.ops import render as wf
from drtvam_tpu_torch.ops.march import scene_tensors
dev = torch.device("cuda:0")
wf.build_kernels()
torch.zeros(1, device=dev)  # create the context before the memory stats
with tempfile.TemporaryDirectory() as tmp:
    static, arr = Scene(cs.bench_config(tmp, "cylindrical")).build(
        mode="volume", include_target=False)
    at = scene_tensors(arr, dev)
    rng = np.random.default_rng(3)  # phase 8's inputs
    data = torch.from_numpy(rng.uniform(
        0.0, 1.0, static.projector.n_active).astype(np.float32)).to(dev)
    dL = torch.from_numpy(rng.uniform(
        0.0, 1.0, static.sensor.n_cells).astype(np.float32)).to(dev)
    for name, fn in (("wf_fwd", lambda: wf.wf_fwd(static, at, data, 0, 1)),
                     ("wf_bwd", lambda: wf.wf_bwd(static, at, dL, 0, 1))):
        print(json.dumps({"phase": "wf_full_width", "name": name,
                          "ms": cs.cuda_ms(fn, 5, torch)}), flush=True)
    # the final render's launch: spp 16 on the scene built as optimize()
    # builds it for the final render (max_depth 16, rr_depth 8)
    static_f, arr_f = Scene(cs.bench_config(tmp, "cylindrical")).build(
        mode="volume", include_target=False, max_depth=16, rr_depth=8)
    at_f = scene_tensors(arr_f, dev)
    print(json.dumps({"phase": "wf_full_width", "name": "wf_fwd_spp16",
                      "ms": cs.cuda_ms(lambda: wf.wf_fwd(
                          static_f, at_f, data, 0, 16), 3, torch)}),
          flush=True)
    del at, at_f, data, dL
    torch.cuda.empty_cache()
    cs.phase_wf_bench(torch, wf, bp, dev, tmp)
"""

HYBRID = """
import json, os, sys, tempfile
sys.path.insert(0, os.getcwd())
import numpy as np
import torch
import chip_smoke as cs
from drtvam_tpu_torch.models.scene import Scene
from drtvam_tpu_torch.ops import backproject as bp
from drtvam_tpu_torch.ops import render as wf
from drtvam_tpu_torch.ops.hybrid import ScatteringEngine
dev = torch.device("cuda:0")
wf.build_kernels()
bp.build_kernels()
torch.zeros(1, device=dev)  # create the context before the memory stats


def emit(name, ms):
    print(json.dumps({"phase": "res_full_width", "name": name, "ms": ms}),
          flush=True)


with tempfile.TemporaryDirectory() as tmp:
    sc = Scene(cs.bench_scattering_config(tmp))
    static, arr = sc.build(mode="volume", include_target=False, max_depth=6,
                           rr_depth=6)
    eng = ScatteringEngine(static, arr, dev, spp=1, estimator="delta")
    st, at = eng.static_s, eng.arr
    rng = np.random.default_rng(3)  # phase 8b's inputs
    data = torch.from_numpy(rng.uniform(
        0.0, 1.0, st.projector.n_active).astype(np.float32)).to(dev)
    dL = torch.from_numpy(rng.uniform(
        0.0, 1.0, st.sensor.n_cells).astype(np.float32)).to(dev)
    emit("wf_res_fwd", cs.cuda_ms(lambda: wf.wf_res_fwd(st, at, data, 0, 1),
                                  20, torch))
    emit("wf_res_bwd", cs.cuda_ms(lambda: wf.wf_res_bwd(st, at, dL, 0, 1),
                                  20, torch))
    # the final render's launch: the scene's dda at spp 16, built as
    # optimize() builds it for the final render (max_depth 16, rr_depth 8)
    static_f, arr_f = sc.build(mode="volume", include_target=False,
                               max_depth=16, rr_depth=8)
    eng_f = ScatteringEngine(static_f, arr_f, dev, spp=16)
    emit("wf_res_fwd_spp16", cs.cuda_ms(lambda: wf.wf_res_fwd(
        eng_f.static_s, eng_f.arr, data, 0, 16), 3, torch))
    del eng, eng_f, at, data, dL
    torch.cuda.empty_cache()
    cs.phase_hybrid_bench(torch, wf, bp, dev, tmp)
"""

CULL = """
import json, os, sys, tempfile
sys.path.insert(0, os.getcwd())
import torch
import chip_smoke as cs
from drtvam_tpu_torch.models.scene import Scene
from drtvam_tpu_torch.ops import backproject as bp
from drtvam_tpu_torch.ops import render as wf
from drtvam_tpu_torch.ops.march import scene_tensors
dev = torch.device("cuda:0")
wf.build_kernels()
bp.build_kernels()
torch.zeros(1, device=dev)  # create the context before the memory stats


def emit(name, ms):
    print(json.dumps({"phase": "cull_full_width", "name": name, "ms": ms}),
          flush=True)


with tempfile.TemporaryDirectory() as tmp:
    radon = dict(mode="radon", include_target=True, max_depth=5,
                 rr_depth=6, print_time=1.0)
    st, arr = Scene(cs.bench_config(tmp, "cylindrical")).build(
        regular_sampling=True, **radon)
    at = scene_tensors(arr, dev)
    emit("wf_radon", cs.cuda_ms(lambda: wf.wf_radon(st, at, 0, 1), 5,
                                torch))
    st, arr = Scene(cs.square_bench_config(tmp)).build(
        mode="volume", include_target=True, max_depth=1, rr_depth=6,
        print_time=1.0, regular_sampling=True)
    at = scene_tensors(arr, dev)
    emit("wf_corner", cs.cuda_ms(lambda: wf.wf_corner(st, at, 3.6, 0.2), 5,
                                 torch))
    st, arr = Scene(cs.telecentric_bench_config(tmp)).build(**radon)
    at = scene_tensors(arr, dev)
    emit("wf_radon_telecentric_spp4", cs.cuda_ms(
        lambda: wf.wf_radon(st, at, 0, 4), 3, torch))
    del st, arr, at
    torch.cuda.empty_cache()
    cs.phase_cull_bench(torch, wf, bp, dev, tmp)
    torch.cuda.empty_cache()
    cs.phase_cull_bench(torch, wf, bp, dev, tmp, square=True)
    torch.cuda.empty_cache()
    cs.phase_cull_telecentric(torch, wf, bp, dev, tmp)
"""

TARGET = """
import json, os, sys, tempfile
sys.path.insert(0, os.getcwd())
import numpy as np
import torch
import chip_smoke as cs
from drtvam_tpu_torch.ops import backproject as bp
from drtvam_tpu_torch.ops import render as wf
dev = torch.device("cuda:0")
wf.build_kernels()
bp.build_kernels()
torch.zeros(1, device=dev)  # create the context before the memory stats


def emit(rec):
    print(json.dumps(rec), flush=True)


def cell(tmp, name):
    cfg = cs.sa_cell_config(tmp, name)
    with cs.CallSpy(wf) as spy:
        vol, timings, wall, peak = cs.optimize_on_card(torch, dev, cfg)
    binary = np.load(os.path.join(cfg["output"], "target_binary.npy"))
    iou, _ = cs.bench_iou(vol, binary)
    emit({"phase": "target_cell", "name": name, **cs.phase_times(timings,
                                                                  wall),
          "best_iou": iou, "peak_mem_gb": peak})
    del vol
    torch.cuda.empty_cache()
    return spy.calls


with tempfile.TemporaryDirectory() as tmp:
    calls = cell(tmp, "b")
    st2, at2, data, seed, spp = calls["wf_fwd:target2"]
    st1 = cs.one_channel_target(st2)
    dL = torch.rand(st2.sensor.n_cells, generator=torch.Generator(
        dev).manual_seed(5), device=dev)
    for name, fn in (
            ("wf_fwd:target2", lambda: wf.wf_fwd(st2, at2, data, seed, spp)),
            ("wf_fwd:target1", lambda: wf.wf_fwd(st1, at2, data, seed, spp)),
            ("wf_bwd:target2", lambda: wf.wf_bwd(st2, at2, dL, seed, spp))):
        emit({"phase": "target_form", "name": name,
              "ms": cs.cuda_ms(fn, 5, torch)})
    del calls, st2, at2, data, dL
    torch.cuda.empty_cache()
    calls = cell(tmp, "a")
    st, at, data, seed, spp = calls["wf_res_fwd:target1"]
    times = {}
    ms = cs.cuda_ms(lambda: wf.wf_res_fwd(st, at, data, seed, spp,
                                          times=times), 3, torch)
    emit({"phase": "target_form", "name": "wf_res_fwd:target1", "ms": ms})
    emit({"phase": "target_form", "name": "wf_res_path:target1",
          "ms": times["path_ms"] / 4})
    emit({"phase": "target_form", "name": "wf_res_walk:target1",
          "ms": times["walk_ms"] / 4})
    # as the render calls it: no times (a tree that overlaps its batches
    # does so here)
    emit({"phase": "target_form", "name": "wf_res_fwd:target1, as called",
          "ms": cs.cuda_ms(lambda: wf.wf_res_fwd(st, at, data, seed, spp), 3,
                           torch)})
"""

TARGET_DELTA = """
import json, os, sys, tempfile
sys.path.insert(0, os.getcwd())
import torch
import chip_smoke as cs
from drtvam_tpu_torch.ops import backproject as bp
from drtvam_tpu_torch.ops import render as wf
dev = torch.device("cuda:0")
wf.build_kernels()
bp.build_kernels()
torch.zeros(1, device=dev)  # create the context before the memory stats


def emit(rec):
    print(json.dumps(rec), flush=True)


with tempfile.TemporaryDirectory() as tmp:
    cfg = cs.custom_cell_config(tmp)
    cfg["vial"]["medium"] = dict(cfg["vial"]["medium"], albedo=0.5)
    cfg["sensor"] = dict(cfg["sensor"], type="delta")
    cfg.update(max_depth=6, rr_depth=6, spp=1, spp_ref=16)
    wf.reset_launches()
    with cs.CallSpy(wf, by_depth=True) as spy:
        vol, timings, wall, peak = cs.optimize_on_card(torch, dev, cfg)
    emit({"phase": "target_cell", "name": "d",
          **cs.phase_times(timings, wall), "peak_mem_gb": peak,
          "form_launches": {k: v for k, v in wf.form_launches.items() if v}})
    del vol
    st, at, data, seed, spp = spy.calls["wf_fwd:target1:depth6"]
    emit({"phase": "target_form", "name": "wf_fwd:target1 delta",
          "ms": cs.cuda_ms(lambda: wf.wf_fwd(st, at, data, seed, spp), 5,
                           torch)})
"""

MODES = {"ballistic": BALLISTIC, "wavefront": WAVEFRONT, "hybrid": HYBRID,
         "cull": CULL, "target": TARGET}
# the turns of each mode: parent and change in alternation
TURNS = {"ballistic": ("parent", "change", "change", "parent"),
         "wavefront": ("parent", "change", "change", "parent"),
         "hybrid": ("parent", "change", "change", "parent", "parent",
                    "change"),
         "cull": ("parent", "change", "change", "parent", "parent",
                  "change"),
         "target": ("parent", "change", "change", "parent", "parent",
                    "change")}


def timed(rec):
    """The record's timed numbers, under names unique across phases."""
    tag = rec.get("name") or rec.get("vial") or ""
    return {f"{rec['phase']}:{tag}:{k}": v for k, v in rec.items()
            if k == "ms" or (k.endswith("_s") and isinstance(v, float))}


def paired(seen):
    """Each timed number's change turns less its parent turns, in pairs."""
    out = {}
    for k in seen["parent"].keys() & seen["change"].keys():
        n = min(len(seen["parent"][k]), len(seen["change"][k]))
        d = np.subtract(seen["change"][k][:n], seen["parent"][k][:n])
        out[k] = {"mean": float(d.mean()), "pairs": n,
                  "se": float(d.std(ddof=1) / np.sqrt(n)) if n > 1 else None}
    return out


def main():
    argv = sys.argv
    pairs = None
    if "--pairs" in argv:
        i = argv.index("--pairs")
        if i + 1 >= len(argv) or not argv[i + 1].isdigit():
            sys.exit(__doc__)
        pairs, argv = int(argv[i + 1]), argv[:i] + argv[i + 2:]
    if len(argv) not in (2, 3, 4) or (
            len(argv) >= 3 and argv[2] not in MODES) or (
            len(argv) == 4 and (argv[2] != "target" or
                                argv[3] not in ("dda", "delta"))):
        sys.exit(__doc__)
    mode = argv[2] if len(argv) >= 3 else "ballistic"
    bench = TARGET_DELTA if argv[3:] == ["delta"] else MODES[mode]
    trees = {"parent": os.path.abspath(argv[1]), "change": os.getcwd()}
    turns = TURNS[mode] if pairs is None else (
        ("parent", "change", "change", "parent") * pairs)[:2 * pairs]
    smi = subprocess.run(["nvidia-smi", "-i", "0",
                          "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    print(smi.stdout.strip(), flush=True)
    seen = {"parent": {}, "change": {}}
    for turn, tree in enumerate(turns):
        out = subprocess.run([sys.executable, "-c", bench],
                             cwd=trees[tree], capture_output=True, text=True,
                             timeout=900)
        if out.returncode != 0:
            sys.exit(f"{tree} (turn {turn}) failed:\n{out.stderr[-4000:]}")
        for line in out.stdout.splitlines():
            if line.startswith('{"phase"'):
                rec = json.loads(line)
                print(json.dumps({"turn": turn, "tree": tree, **rec}),
                      flush=True)
                for k, v in timed(rec).items():
                    seen[tree].setdefault(k, []).append(v)
    print(json.dumps({"medians": {
        tree: {k: float(np.median(v)) for k, v in vals.items()}
        for tree, vals in seen.items()}, "change_less_parent": paired(seen)}),
        flush=True)


if __name__ == "__main__":
    main()
