"""The wavefront kernels' per-lane template (csrc/wf_trace.cuh) built
with the host compiler and held to the plain version, on the CPU.

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
#include "wf_trace.cuh"
using namespace wf;
template <int EST, bool SCAT, bool TONLY, bool PRIMAL>
void run(const WfParams& P, const float* in, const int* ap, float* out,
         unsigned long long* c) {
  Grid G;
  G.init(P);
  for (int aidx = 0; aidx < P.n_active; ++aidx) {
    Sink<PRIMAL> S{out, in, 0.0f};
    const float em = PRIMAL ? in[aidx] * P.ray_w : 1.0f;
    if (PRIMAL && em == 0.0f) continue;
    float gsum = 0.0f;
    for (int k = 0; k < P.spp; ++k) {
      S.g = 0.0f;
      trace_lane<EST, SCAT, TONLY, PRIMAL>(
          P, G, (uint32_t)aidx * (uint32_t)P.spp + (uint32_t)k, aidx, ap,
          em, S, c[0], c[1]);
      gsum = k == 0 ? S.g : gsum + S.g;
    }
    if (!PRIMAL) out[aidx] = gsum * P.ray_w;
  }
}
template <bool PRIMAL>
int dispatch(const WfParams* p, const float* in, const int* ap, float* out,
             unsigned long long* c) {
  const int key = p->estimator * 4 + (p->has_scattering ? 2 : 0) +
                  (p->transmission_only ? 1 : 0);
#define C(E, S, T) \
  case E * 4 + (S ? 2 : 0) + (T ? 1 : 0): run<E, S, T, PRIMAL>(*p, in, ap, out, c); break;
  switch (key) {
    C(0, 0, 0) C(0, 0, 1) C(0, 1, 0) C(0, 1, 1) C(1, 0, 0) C(1, 0, 1)
    C(1, 1, 0) C(1, 1, 1) C(2, 0, 0) C(2, 0, 1) C(2, 1, 0) C(2, 1, 1)
    default: return 1;
  }
  return 0;
}
extern "C" int wf_fwd(const WfParams* p, const float* in, const int* ap,
                      float* out, unsigned long long* c, void*) {
  return dispatch<true>(p, in, ap, out, c);
}
extern "C" int wf_bwd(const WfParams* p, const float* in, const int* ap,
                      float* out, unsigned long long* c, void*) {
  return dispatch<false>(p, in, ap, out, c);
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
    subprocess.run([gxx, "-std=c++17", "-O2", "-ffp-contract=off",
                    "-shared", "-fPIC", "-I", str(work / "stub"),
                    "-I", CUDA_SRC_DIR, str(work / "harness.cpp"), "-o",
                    str(lib)], check=True, capture_output=True, text=True)
    lib = ctypes.CDLL(str(lib))
    for name in wf.KERNELS:
        wf._setup(lib, name)
    path = work / "t.ply"
    save_ply(make_box((0.5, 0.5, 0.5)), str(path))
    return lib, str(path)


def _scene(path, estimator, albedo, projector, vial, tonly, diffuse=False):
    med = {"ior": 1.4849, "extinction": 0.1, "albedo": albedo,
           "phase": {"type": "rayleigh"}}
    vials = {"cylindrical": {"type": "cylindrical", "r_ext": 8.385,
                             "r_int": 7.665, "height": 20.0, "ior": 1.514,
                             "medium": med},
             "square": {"type": "square", "w_int": 12.0, "w_ext": 14.0,
                        "ior": 1.24, "medium": med},
             "double_cylindrical": {
                 "type": "double_cylindrical", "r_ext_outer": 8.3,
                 "r_int_outer": 7.9, "r_ext_inner": 3.0, "r_int_inner": 2.6,
                 "ior_outer": 1.54, "ior_inner": 1.52,
                 "ior_inside_inner": 1.40, "medium": med}}
    proj = {"type": projector, "n_patterns": 6, "resx": 16, "resy": 12,
            "pixel_size": 16.77 / 16, "motion": "circular",
            "distance": 25.0}
    if projector == "telecentric":
        proj.update(aperture_radius=0.3, focus_distance=20.0)
    elif projector == "lens":
        del proj["pixel_size"]
        proj.update(fov=30.0, aperture_radius=0.3, focus_distance=25.0,
                    motion={"type": "circular", "clockwise": True})
    cfg = {"vial": vials[vial], "projector": proj,
           "sensor": {"type": estimator, "scalex": 16.77, "scaley": 16.77,
                      "scalez": 16.77, "majorant": 10.0,
                      "film": {"type": "vfilm", "resx": 20, "resy": 20,
                               "resz": 20}},
           "target": {"filename": path, "size": 4.0}, "output": "."}
    static, arr = Scene(cfg).build(mode="volume", include_target=False,
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
    out = torch.zeros(n_out)
    counters = (ctypes.c_ulonglong * 2)()
    assert getattr(lib, name)(ctypes.byref(P), x.data_ptr(),
                              at["active_pixels"].data_ptr(),
                              out.data_ptr(), ctypes.addressof(counters),
                              None) == 0
    return out, {"iterations": counters[0], "steps": counters[1]}


def _close(out, ref, point):
    scale = float(ref.abs().max())
    assert scale > 0.0
    off = int(((out - ref).abs() > 1e-4 * scale).sum())
    assert off <= (2e-3 * int((ref != 0).sum()) if point else 0), off


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
    assert stats == ref_stats and g_stats == ref_g_stats
    point = static.sensor.estimator in ("ratio", "delta")
    _close(dose, dose_ref, point)
    _close(grad, grad_ref, point)
