"""The wavefront kernels' per-lane template (csrc/wf_trace.cuh) built
with the host compiler and held to the plain version, on the CPU: the
analog pair's instantiations and the residual pair's (the hybrid
engine's scattered-only, first-scatter and fast-residual modes).

Everything of the template above its `__global__` kernel is plain C++
once a few CUDA names are stubbed (below), so g++ builds it into a
library whose loop over pixels calls `trace_lane` exactly as the kernel
does, minus the threads: one check of the kernel source here, where
there is no nvcc. The card's chip_smoke.py phase 7 holds the real
kernels to the same plain version.

Tolerance: the paths must be the same paths, so the bounce iterations
and estimator steps counted by both are equal exactly. Values agree to
1e-4 of the max: glibc's expf / logf / powf / sinf / cosf against
torch's CPU ones differ by an ulp or two (on the card both use CUDA's,
and agree more closely); a ratio or delta deposit is a point, so there
up to 0.2 % of the nonzero values may be off by more."""
import ctypes
import dataclasses
import shutil
import subprocess

import numpy as np
import pytest
import torch

from drtvam_tpu_torch.models.geometry import DIFFUSE
from drtvam_tpu_torch.models.scene import Scene
from drtvam_tpu_torch.native import CUDA_SRC_DIR
from drtvam_tpu_torch.ops import render as wf
from drtvam_tpu_torch.ops.hybrid import ScatteringEngine
from drtvam_tpu_torch.ops.march import scene_tensors
from drtvam_tpu_torch.ops.mesh import make_box, save_ply


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: the plain wavefront's many small ops gain
    nothing from more, and the suite runs several workers on one host,
    where spinning thread pools slow every worker down."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

STUB = r"""
#pragma once
#include <cmath>
#include <cstdint>
#include <cstring>
#define __device__
#define __forceinline__ inline
#define __restrict__
struct float2 { float x, y; };
struct int4 { int x, y, z, w; };
inline float2 make_float2(float a, float b) { return {a, b}; }
inline float __int_as_float(int i) {
  float f;
  std::memcpy(&f, &i, 4);
  return f;
}
inline float atomicAdd(float* p, float v) { float o = *p; *p = o + v; return o; }
inline float __ldg(const float* p) { return *p; }
using std::isfinite;
"""

HARNESS = r"""
#include <vector>
#include "wf_trace.cuh"
using namespace wf;
static std::vector<int> traced;

// the kernel's launch order on one thread: block by block, each block's
// range task by task (task_position); the forward's home-slice tile
// zeroed first and flushed last (the adjoint and the residual take none)
template <int EST, bool SCAT, bool TONLY, int RES, bool PRIMAL>
void run_blocks(const WfParams& P, const float* in, const int* ap,
                const int* order, const int* starts, const int4* rows,
                const float* chords, float* out, unsigned long long* c) {
  Grid G;
  G.init(P);
  std::vector<float> tile(P.tile_n);
  Sink<PRIMAL, true> S{out, in, tile.data(), rows, -1, 0.0f, 0, 0, 0, 0};
  unsigned long long slots = 0;
  for (int b = 0; b < P.resy * P.n_groups; ++b) {
    int lo, hi, py;
    block_range(P, starts, b, lo, hi, py);
    S.home = P.tile_n > 0 ? home_slice(P, G, py) : -1;
    const int slice0 = S.home * G.res[0] * G.res[1];
    for (int y = 0; PRIMAL && S.home >= 0 && y < G.res[1]; ++y)
      for (int x = rows[y].x; x < rows[y].x + rows[y].y; ++x)
        tile[rows[y].z + x] = 0.0f;
    for (int t = 0; t < task_count<PRIMAL>(P, lo, hi); ++t) {
      unsigned long long longest = 0;
      for (int l = 0; l < 32; ++l) {
        const unsigned long long s0 = S.steps;
        const int aidx = trace_task<EST, SCAT, TONLY, RES>(
            P, G, order, lo, hi, t, l, in, ap, out, S, chords);
        if (aidx >= 0) traced.push_back(aidx);
        if (S.steps - s0 > longest) longest = S.steps - s0;
      }
      slots += 32 * longest;
    }
    for (int y = 0; PRIMAL && S.home >= 0 && y < G.res[1]; ++y)
      for (int x = rows[y].x; x < rows[y].x + rows[y].y; ++x)
        if (tile[rows[y].z + x] != 0.0f)
          atomicAdd(out + slice0 + y * G.res[0] + x, tile[rows[y].z + x]);
  }
  const unsigned long long k[5] = {S.iters, S.steps, S.n_tile, S.n_global,
                                   slots};
  for (int i = 0; i < 5; ++i) c[i] += k[i];
}

// lane order, no tile: active pixel 0, 1, 2, ..., each pixel's lanes
// in lane order on one thread
template <int EST, bool SCAT, bool TONLY, int RES, bool PRIMAL>
void run_lanes(const WfParams& P, const float* in, const int* ap,
               const int*, const int*, const int4*, const float* chords,
               float* out, unsigned long long* c) {
  Grid G;
  G.init(P);
  Sink<PRIMAL, true> S{out, in, nullptr, nullptr, -1, 0.0f, 0, 0, 0, 0};
  for (int aidx = 0; aidx < P.n_active; ++aidx) {
    const float em = PRIMAL ? in[aidx] * P.ray_w : 1.0f;
    if (em == 0.0f) continue;
    float gsum = 0.0f;
    for (int k = 0; k < P.spp; ++k) {
      S.g = 0.0f;
      trace_lane<EST, SCAT, TONLY, RES>(
          P, G, (uint32_t)aidx * (uint32_t)P.spp + (uint32_t)k, aidx, ap,
          em, S, chords);
      gsum = k == 0 ? S.g : gsum + S.g;
    }
    if (!PRIMAL) out[aidx] = gsum * P.ray_w;
  }
  const unsigned long long k[4] = {S.iters, S.steps, S.n_tile, S.n_global};
  for (int i = 0; i < 4; ++i) c[i] += k[i];
}

template <bool PRIMAL, bool BLOCKS>
int dispatch(const WfParams* p, const float* in, const int* ap,
             const int* order, const int* starts, const int4* rows,
             float* out, unsigned long long* c) {
  traced.clear();
  const int key = p->estimator * 4 + (p->has_scattering ? 2 : 0) +
                  (p->transmission_only ? 1 : 0);
#define C(E, S, T)                                                       \
  case E * 4 + (S ? 2 : 0) + (T ? 1 : 0):                                \
    (BLOCKS ? run_blocks<E, S, T, ANALOG, PRIMAL>                        \
            : run_lanes<E, S, T, ANALOG, PRIMAL>)(                       \
        *p, in, ap, order, starts, rows, nullptr, out, c);               \
    break;
  switch (key) {
    C(0, 0, 0) C(0, 0, 1) C(0, 1, 0) C(0, 1, 1) C(1, 0, 0) C(1, 0, 1)
    C(1, 1, 0) C(1, 1, 1) C(2, 0, 0) C(2, 0, 1) C(2, 1, 0) C(2, 1, 1)
    default: return 1;
  }
  return 0;
}

// the residual pair's instantiations (scattering, transmission only),
// by estimator and residual mode, as csrc/wf_trace.cuh pick
template <bool PRIMAL, bool BLOCKS>
int res_dispatch(const WfParams* p, const float* in, const int* ap,
                 const int* order, const int* starts, const float* chords,
                 float* out, unsigned long long* c) {
  traced.clear();
#define R(E, M)                                                            \
  case E * 4 + M:                                                          \
    (BLOCKS ? run_blocks<E, true, true, M, PRIMAL>                         \
            : run_lanes<E, true, true, M, PRIMAL>)(                        \
        *p, in, ap, order, starts, nullptr, chords, out, c);               \
    break;
  switch (p->estimator * 4 + p->residual) {
    R(DDA, SCAT_ONLY) R(DDA, FIRST_SCATTER) R(RATIO, SCAT_ONLY)
    R(RATIO, FIRST_SCATTER) R(DELTA, SCAT_ONLY) R(DELTA, FIRST_SCATTER)
    R(DELTA, FAST_RESIDUAL)
    default: return 1;
  }
  return 0;
}
#define ENTRY(NAME, PRIMAL, BLOCKS)                                          \
  extern "C" int NAME(const WfParams* p, const float* in, const int* ap,   \
                      const int* order, const int* starts, const int4* rows,\
                      float* out, unsigned long long* c, void*) {          \
    return dispatch<PRIMAL, BLOCKS>(p, in, ap, order, starts, rows, out, c);\
  }
ENTRY(wf_fwd, true, true)
ENTRY(wf_bwd, false, true)
ENTRY(wf_fwd_lanes, true, false)
ENTRY(wf_bwd_lanes, false, false)
#define RES_ENTRY(NAME, PRIMAL, BLOCKS)                                     \
  extern "C" int NAME(const WfParams* p, const float* in, const int* ap,   \
                      const int* order, const int* starts,                 \
                      const float* chords, float* out,                     \
                      unsigned long long* c, void*) {                      \
    return res_dispatch<PRIMAL, BLOCKS>(p, in, ap, order, starts, chords,  \
                                        out, c);                           \
  }
RES_ENTRY(wf_res_fwd, true, true)
RES_ENTRY(wf_res_bwd, false, true)
RES_ENTRY(wf_res_fwd_lanes, true, false)
RES_ENTRY(wf_res_bwd_lanes, false, false)
// the active indices the last call traced, in its order
extern "C" int wf_traced(int* out) {
  for (size_t i = 0; i < traced.size(); ++i) out[i] = traced[i];
  return (int)traced.size();
}
"""


@pytest.fixture(scope="module")
def template_lib(tmp_path_factory):
    gxx = shutil.which("g++")
    assert gxx is not None, "the port's host code is built with g++"
    work = tmp_path_factory.mktemp("wf_template")
    (work / "stub").mkdir()
    (work / "stub" / "cuda_runtime.h").write_text(STUB)
    (work / "harness.cpp").write_text(HARNESS)
    lib = work / "libwf_template.so"
    # IEEE float32 op by op, as nvcc --fmad=false
    build = subprocess.run([gxx, "-std=c++17", "-O2", "-ffp-contract=off",
                            "-shared", "-fPIC", "-I", str(work / "stub"),
                            "-I", CUDA_SRC_DIR, str(work / "harness.cpp"),
                            "-o", str(lib)], capture_output=True, text=True)
    assert build.returncode == 0, build.stderr
    lib = ctypes.CDLL(str(lib))
    for name in wf.KERNELS + wf.RES_KERNELS + (
            "wf_fwd_lanes", "wf_bwd_lanes", "wf_res_fwd_lanes",
            "wf_res_bwd_lanes"):
        wf._setup(lib, name)
    lib.wf_traced.argtypes = [ctypes.c_void_p]
    lib.wf_traced.restype = ctypes.c_int
    path = work / "t.ply"
    save_ply(make_box((0.5, 0.5, 0.5)), str(path))
    return lib, str(path)


def _scene(path, estimator, albedo, projector, vial, tonly, diffuse=False,
           n_patterns=6, store="identity"):
    """store: "identity", "crop" (a cropped DMD window) or "subset" (a
    numpy-seeded random half of the pixels, in random order)."""
    med = {"ior": 1.4849, "extinction": 0.1, "albedo": albedo,
           "phase": {"type": "rayleigh"}}
    vials = {"cylindrical": {"type": "cylindrical", "r_ext": 8.385,
                             "r_int": 7.665, "height": 20.0, "ior": 1.514,
                             "medium": med},
             "square": {"type": "square", "w_int": 12.0, "w_ext": 14.0,
                        "ior": 1.24, "medium": med},
             "index_matched": {"type": "index_matched", "r": 7.665,
                               "medium": med},
             "double_cylindrical": {
                 "type": "double_cylindrical", "r_ext_outer": 8.3,
                 "r_int_outer": 7.9, "r_ext_inner": 3.0, "r_int_inner": 2.6,
                 "ior_outer": 1.54, "ior_inner": 1.52,
                 "ior_inside_inner": 1.40, "medium": med}}
    proj = {"type": projector, "n_patterns": n_patterns, "resx": 16,
            "resy": 12, "pixel_size": 16.77 / 16, "motion": "circular",
            "distance": 25.0}
    if projector == "telecentric":
        proj.update(aperture_radius=0.3, focus_distance=20.0)
    elif projector == "lens":
        del proj["pixel_size"]
        proj.update(fov=30.0, aperture_radius=0.3, focus_distance=25.0,
                    motion={"type": "circular", "clockwise": True})
    if store == "crop":
        proj.update(cropx=11, cropy=9, crop_offset_x=3, crop_offset_y=2)
    cfg = {"vial": vials[vial], "projector": proj,
           "sensor": {"type": estimator, "scalex": 16.77, "scaley": 16.77,
                      "scalez": 16.77, "majorant": 10.0,
                      "film": {"type": "vfilm", "resx": 20, "resy": 20,
                               "resz": 20}},
           "target": {"filename": path, "size": 4.0}, "output": "."}
    scene = Scene(cfg)
    if store == "subset":
        n = n_patterns * 16 * 12
        pick = np.random.default_rng(11).permutation(n)[:n // 2]
        scene.projector.set_active(pick.astype(np.int32),
                                   np.ones(pick.size, np.float32))
    static, arr = scene.build(mode="volume", include_target=False,
                              max_depth=8, rr_depth=3,
                              transmission_only=tonly, sample_time=True)
    if diffuse:
        # the inner vial's outer wall made diffuse (reflectance 0.6): the
        # occlusions' BSDF, which no analytic vial has
        surfaces = list(static.surfaces)
        surfaces[2] = dataclasses.replace(surfaces[2], bsdf=DIFFUSE)
        static = dataclasses.replace(static, surfaces=tuple(surfaces))
        arr = dict(arr, surf_refl=np.asarray([0.0, 0.0, 0.6, 0.0],
                                             np.float32))
    return static, arr


# (estimator, albedo, projector, vial, transmission_only)
CASES = [("dda", 0.0, "collimated", "cylindrical", True),
         ("ratio", 0.5, "telecentric", "square", False),
         ("delta", 0.5, "lens", "cylindrical", True),
         ("dda", 0.5, "collimated", "double_cylindrical", False),
         ("ratio", 0.0, "lens", "double_cylindrical", True),
         ("dda", 0.0, "collimated", "double_cylindrical", False, True)]


def _run(lib, name, static, at, x, n_out, seed, spp):
    P = wf.make_params(static, at, seed, spp)
    order, starts, rows, P.tile_n = wf._launch_layout(static, at)
    out = torch.zeros(n_out)
    counters = (ctypes.c_ulonglong * len(wf.COUNTERS))()
    assert getattr(lib, name)(ctypes.byref(P), x.data_ptr(),
                              at["active_pixels"].data_ptr(),
                              wf._ptr(order), wf._ptr(starts),
                              rows.data_ptr(), out.data_ptr(),
                              ctypes.addressof(counters), None) == 0
    return out, dict(zip(wf.COUNTERS, counters))


def _traced(lib, n):
    buf = torch.empty(n, dtype=torch.int32)
    assert lib.wf_traced(buf.data_ptr()) == n
    return buf.to(torch.int64)


def _close(out, ref, point):
    scale = float(ref.abs().max())
    assert scale > 0.0
    off = int(((out - ref).abs() > 1e-4 * scale).sum())
    assert off <= (2e-3 * int((ref != 0).sum()) if point else 0), off


def _deposits_add_up(stats, estimator):
    """Every dda or delta step is one deposit, into the tile or to
    global memory; a ratio-tracking step past the segment's end or
    outside the film deposits nothing."""
    deposits = stats["tile_deposits"] + stats["global_deposits"]
    if estimator == "ratio":
        assert 0 < deposits <= stats["steps"]
    else:
        assert deposits == stats["steps"]


@pytest.mark.parametrize("case", CASES)
def test_template_traces_the_plain_versions_paths(case, template_lib):
    lib, path = template_lib
    static, arr = _scene(path, *case)
    at = scene_tensors(arr, "cpu")
    rng = np.random.default_rng(4)
    data = torch.from_numpy(rng.uniform(0.5, 1.5, static.projector.n_active)
                            .astype(np.float32))
    dL = torch.from_numpy(rng.uniform(0.0, 1.0, static.sensor.n_cells)
                          .astype(np.float32))
    seed, spp = 9, 3
    ref_stats, ref_g_stats = {}, {}
    dose_ref = wf._forward(static, at, data, seed, spp, wf.DEFAULT_CHUNK,
                           ref_stats)
    grad_ref = wf._adjoint(static, at, seed, spp, wf.DEFAULT_CHUNK, dL,
                           ref_g_stats)
    dose, stats = _run(lib, "wf_fwd", static, at, data,
                       static.sensor.n_cells, seed, spp)
    grad, g_stats = _run(lib, "wf_bwd", static, at, dL,
                         static.projector.n_active, seed, spp)
    for ours, ref in ((stats, ref_stats), (g_stats, ref_g_stats)):
        assert {k: ours[k] for k in ref} == ref
        _deposits_add_up(ours, static.sensor.estimator)
        assert ours["lane_slots"] >= ours["steps"]
    assert g_stats["tile_deposits"] == 0  # the adjoint gathers from dL
    if case[2] == "collimated" and static.sensor.estimator == "dda":
        assert stats["tile_deposits"] > 0
    point = static.sensor.estimator in ("ratio", "delta")
    _close(dose, dose_ref, point)
    _close(grad, grad_ref, point)


# the block order against lane order: the bench-like collimated dda
# scene, and every estimator, on the three pattern stores and with more
# than one angle group (30 angles: 2 groups of 15)
ORDER_CASES = [(CASES[0], 6, "identity"), (CASES[0], 30, "identity"),
               (CASES[0], 30, "crop"), (CASES[0], 30, "subset"),
               (CASES[1], 6, "subset"), (CASES[2], 6, "identity"),
               (CASES[3], 30, "identity"), (CASES[5], 6, "crop")]


@pytest.mark.parametrize("case,n_patterns,store", ORDER_CASES)
def test_block_order_changes_no_value(case, n_patterns, store,
                                      template_lib):
    """Traced block by block through the forward's home-slice tile, the
    adjoint is bitwise equal to lane order and the forward agrees to
    1e-4 of the max (its sums regroup); the same paths, step for step,
    in the order block_order gives."""
    lib, path = template_lib
    static, arr = _scene(path, *case, n_patterns=n_patterns, store=store)
    at = scene_tensors(arr, "cpu")
    n = static.projector.n_active
    assert static.projector.identity == (store == "identity")
    rng = np.random.default_rng(6)
    data = torch.from_numpy(rng.uniform(0.5, 1.5, n).astype(np.float32))
    dL = torch.from_numpy(rng.uniform(0.0, 1.0, static.sensor.n_cells)
                          .astype(np.float32))
    seed, spp, n_cells = 3, 2, static.sensor.n_cells
    dose, stats = _run(lib, "wf_fwd", static, at, data, n_cells, seed, spp)
    lanes = _traced(lib, n * spp)  # the forward: one lane a thread
    dose_l, stats_l = _run(lib, "wf_fwd_lanes", static, at, data, n_cells,
                           seed, spp)
    grad, g_stats = _run(lib, "wf_bwd", static, at, dL, n, seed, spp)
    order = _traced(lib, n)  # the adjoint: one pixel a thread
    grad_l, g_stats_l = _run(lib, "wf_bwd_lanes", static, at, dL, n, seed,
                             spp)
    # the adjoint traced block_order's pixels in its order; the forward
    # each of their spp lanes once, block by block
    ref, starts = wf.block_order(static, at)
    assert torch.equal(order, ref)
    for b in range(len(starts) - 1):
        lo, hi = int(starts[b]), int(starts[b + 1])
        assert torch.equal(torch.sort(lanes[lo * spp:hi * spp]).values,
                           torch.sort(ref[lo:hi].repeat(spp)).values)
    assert torch.equal(grad, grad_l)
    _close(dose, dose_l, False)
    for ours, lanes in ((stats, stats_l), (g_stats, g_stats_l)):
        assert ours["iterations"] == lanes["iterations"]
        assert ours["steps"] == lanes["steps"]
        _deposits_add_up(ours, static.sensor.estimator)
    if case[2] == "collimated":
        assert stats["tile_deposits"] > 0
    if case == CASES[0]:  # horizontal rays only: most stay in the slice
        assert stats["tile_deposits"] > stats["global_deposits"]


# the residual pair: (estimator, residual mode, vial, projector). The
# scenes' rr_depth 3 makes Russian roulette fire in the fast loop
RES_CASES = [("dda", "first_scatter", "cylindrical", "collimated"),
             ("ratio", "first_scatter", "square", "collimated"),
             ("delta", "fast_residual", "cylindrical", "collimated"),
             ("delta", "fast_residual", "square", "collimated"),
             ("delta", "first_scatter", "index_matched", "collimated"),
             ("dda", "scattered_only", "cylindrical", "collimated"),
             ("delta", "scattered_only", "index_matched", "collimated")]


def _residual(path, estimator, mode, vial, projector):
    """The hybrid engine's residual static and tensors on a small
    scattering scene: its chord bank, its mode."""
    static, arr = _scene(path, estimator, 0.5, projector, vial, True)
    eng = ScatteringEngine(static, arr, "cpu",
                           first_scatter=mode != "scattered_only")
    st = dataclasses.replace(eng.static_s,
                             fast_residual=mode == "fast_residual")
    assert wf.make_params(st, eng.arr, 0, 1).residual == \
        ("scattered_only", "first_scatter", "fast_residual").index(mode) + 1
    return st, eng.arr


def _run_res(lib, name, static, at, x, n_out, seed, spp):
    P, order, starts, bank = wf._family_params(name.replace("_lanes", ""),
                                               static, at, seed, spp)
    out = torch.zeros(n_out)
    counters = (ctypes.c_ulonglong * len(wf.COUNTERS))()
    assert getattr(lib, name)(ctypes.byref(P), x.data_ptr(),
                              at["active_pixels"].data_ptr(),
                              wf._ptr(order), wf._ptr(starts), wf._ptr(bank),
                              out.data_ptr(), ctypes.addressof(counters),
                              None) == 0
    return out, dict(zip(wf.COUNTERS, counters))


@pytest.mark.parametrize("case", RES_CASES)
def test_residual_template_traces_the_plain_residual(case, template_lib):
    """The residual pair's template in its launch order against the
    plain residual: the same bounce iterations and deposits, values to
    1e-4 of the max (a delta deposit is a point), every deposit to
    global memory; the adjoint bitwise equal to lane order."""
    lib, path = template_lib
    static, at = _residual(path, *case)
    rng = np.random.default_rng(8)
    n, n_cells = static.projector.n_active, static.sensor.n_cells
    data = torch.from_numpy(rng.uniform(0.5, 1.5, n).astype(np.float32))
    dL = torch.from_numpy(rng.uniform(0.0, 1.0, n_cells).astype(np.float32))
    seed, spp = 5, 3
    ref_stats, ref_g_stats = {}, {}
    dose_ref = wf._forward(static, at, data, seed, spp, wf.DEFAULT_CHUNK,
                           ref_stats)
    grad_ref = wf._adjoint(static, at, seed, spp, wf.DEFAULT_CHUNK, dL,
                           ref_g_stats)
    dose, stats = _run_res(lib, "wf_res_fwd", static, at, data, n_cells,
                           seed, spp)
    grad, g_stats = _run_res(lib, "wf_res_bwd", static, at, dL, n, seed,
                             spp)
    grad_l, _ = _run_res(lib, "wf_res_bwd_lanes", static, at, dL, n, seed,
                         spp)
    for ours, ref in ((stats, ref_stats), (g_stats, ref_g_stats)):
        assert ref["steps"] > 0
        assert {k: ours[k] for k in ref} == ref
        assert ours["tile_deposits"] == 0
        _deposits_add_up(ours, static.sensor.estimator)
    point = static.sensor.estimator in ("ratio", "delta")
    _close(dose, dose_ref, point)
    _close(grad, grad_ref, point)
    assert torch.equal(grad, grad_l)
