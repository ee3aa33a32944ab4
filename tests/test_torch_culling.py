"""DMD-pixel culling in the port against the JAX package, on the CPU.

  * render_radon (the plain march in its radon mode) against the JAX
    package's on tests/test_radon_cull.py's scene: albedo 0 and 0.5 at
    regular sampling, spp 1, and random sampling at spp 4 with the same
    seed (both replay the same paths): the image to 1e-4 of its max (the
    two packages' transcendentals and fused products differ by an ulp or
    two), the same kept set;
  * radon_active_ballistic: the same index set as the JAX package's, on
    the identity store and on a sparse store (dense indices back);
  * render_corner: the same keep image;
  * the port's ballistic cull against its own radon render: at most 2 %
    of the pixels differ, each a boundary pixel (test_radon_cull.py's
    criterion);
  * the culling kernels' template (csrc/wf_trace.cuh in its RADON and
    CORNER lane modes, csrc/wf_mesh.cuh) built with g++ on the stubbed
    CUDA names of tests/test_torch_wf_template.py and run in the
    kernels' pixel order: the mesh hits bitwise against the plain
    ray_triangles / ray_triangles_grid (up to a tie in t), the radon
    image to 1e-4 of its max with the same bounce iterations and kept
    set, the corner image equal;
  * both CLIs with filter_radon (the ballistic cull, and the radon
    render's fallback on a telecentric scene) and filter_corner: the same
    kept set, the loss history to 1e-4, the same artifact files."""
import ctypes
import json
import os
import shutil
import subprocess

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from drtvam_tpu.models import projector as jprojector
from drtvam_tpu.models.scene import Scene as JScene
from drtvam_tpu.ops.ballistic import radon_active_ballistic as jcull
from drtvam_tpu.ops.mesh import (make_box, make_box_tube,
                                 make_box_with_hole, make_hollow_gear,
                                 save_ply)
from drtvam_tpu.ops.render import render_corner as jcorner
from drtvam_tpu.ops.render import render_radon as jradon
from drtvam_tpu.opt.optimize import main as jmain
from drtvam_tpu_torch.models import projector as tprojector
from drtvam_tpu_torch.models.scene import Scene as TScene
from drtvam_tpu_torch.native import CUDA_SRC_DIR
from drtvam_tpu_torch.ops import render as wf
from drtvam_tpu_torch.ops.ballistic import radon_active_ballistic as tcull
from drtvam_tpu_torch.ops.intersect import ray_triangles
from drtvam_tpu_torch.ops.march import scene_tensors
from drtvam_tpu_torch.ops.mesh_grid import build_tri_grid, \
    ray_triangles_grid
from drtvam_tpu_torch.opt.optimize import main as tmain

from test_torch_wf_template import STUB
from torch_threads import one_torch_thread  # noqa: F401
from torch_jax_native import jax_native_libraries  # noqa: F401


@pytest.fixture(scope="module")
def box_hole(tmp_path_factory):
    """tests/conftest.py's box_hole_mesh: the box with a through-hole
    (792 triangles: the grid)."""
    path = tmp_path_factory.mktemp("cull") / "box_hole.ply"
    save_ply(make_box_with_hole((2.0, 2.0, 1.0), 0.5, segments=99),
             str(path))
    # the custom vial's walls beside it (_config): a cuvette that every
    # lane crosses
    save_ply(make_box_tube(2.9, 2.9, -5.0, 5.0),
             str(path.parent / "cuv_outer.ply"))
    save_ply(make_box_tube(2.6, 2.5, -5.0, 5.0),
             str(path.parent / "cuv_inner.ply"))
    return str(path)


def _config(mesh, albedo=0.0, vial="cylindrical", projector=None,
            n_patterns=32, resx=64, resy=16, film=(48, 48, 24)):
    """tests/test_radon_cull.py's scene (its defaults); vial "custom":
    mesh walls (box_hole's directory) about the cylindrical vial's."""
    meshes = os.path.dirname(mesh)
    vials = {"cylindrical": {"type": "cylindrical", "r_int": 2.6,
                             "r_ext": 2.9, "ior": 1.54},
             "square": {"type": "square", "w_int": 4.6, "w_ext": 5.0,
                        "ior": 1.54},
             "custom": {"type": "custom", "ior": 1.54,
                        "filename_vial_outer": f"{meshes}/cuv_outer.ply",
                        "filename_vial_inner": f"{meshes}/cuv_inner.ply"}}
    proj = {"type": "collimated", "n_patterns": n_patterns, "resx": resx,
            "resy": resy, "pixel_size": 5.0 / resx, "motion": "circular",
            "distance": 20}
    proj.update(projector or {})
    return {
        "vial": dict(vials[vial], medium={
            "ior": 1.40, "phase": {"type": "rayleigh"}, "extinction": 0.1,
            "albedo": albedo}),
        "projector": proj,
        "sensor": {"type": "dda", "scalex": 5, "scaley": 5, "scalez": 1.25,
                   "film": {"type": "vfilm", "resx": film[0],
                            "resy": film[1], "resz": film[2]}},
        "target": {"filename": mesh, "size": 1.5},
        "output": "/tmp"}


def _radon_builds(cfg, **kw):
    kw = dict(mode="radon", include_target=True, max_depth=5, rr_depth=6,
              **kw)
    return JScene(cfg).build(**kw), TScene(cfg).build(**kw)


def _jnp(arr):
    return {k: jnp.asarray(v) for k, v in arr.items()}


# (albedo, regular sampling, spp)
RADON_CASES = [(0.0, True, 1), (0.5, True, 1), (0.5, False, 4)]


@pytest.mark.parametrize("case", RADON_CASES)
def test_render_radon_matches_jax(case, box_hole):
    albedo, regular, spp = case
    (js, ja), (ts, ta) = _radon_builds(_config(box_hole, albedo),
                                       regular_sampling=regular)
    ref = np.asarray(jradon(js, _jnp(ja), seed=3, spp=spp))
    img = wf.render_radon(ts, scene_tensors(ta, "cpu"), seed=3,
                          spp=spp).numpy()
    assert img.shape == ref.shape == (32 * 16 * 64,)
    assert 0 < (ref > 0).sum() < ref.size
    np.testing.assert_allclose(img, ref, rtol=0, atol=1e-4 * ref.max())
    np.testing.assert_array_equal(img > 0, ref > 0)


@pytest.mark.parametrize("store", ["identity", "sparse"])
def test_radon_active_ballistic_matches_jax(store, box_hole):
    """test_radon_cull.py's two culls: the identity store, and every
    other dense pixel (test_analytic_cull_sparse_store_dense_indices):
    dense indices back in both."""
    cfg = _config(box_hole)
    js, ts = JScene(cfg), TScene(cfg)
    mask = np.asarray(js.sensor.discretize(js.target_bank()))
    if store == "sparse":
        n = int(np.prod(js.projector.size()))
        sub = np.arange(0, n, 2, dtype=np.int32)
        for sc in (js, ts):
            sc.projector.set_active(sub, np.zeros(sub.size, np.float32))
    kw = dict(mode="volume", include_target=False, max_depth=5, rr_depth=6)
    ref = jcull(*js.build(**kw), mask)
    idx = tcull(*ts.build(**kw), mask, "cpu")
    assert idx.dtype == np.int32 and idx.size > 0
    np.testing.assert_array_equal(idx, ref)
    if store == "sparse":
        assert np.all(idx % 2 == 0)


def _corner_builds(cfg):
    kw = dict(mode="volume", include_target=True, max_depth=1, rr_depth=6,
              regular_sampling=True)
    return JScene(cfg).build(**kw), TScene(cfg).build(**kw)


@pytest.mark.parametrize("target", ["box_hole", "box"])
def test_render_corner_matches_jax(target, box_hole, tmp_path):
    """The square vial's corners at (|x|, |y|) = (2.5, 2.5), radius 0.3;
    the box-with-hole target walks its grid, a small box brute force."""
    mesh = box_hole
    if target == "box":
        mesh = str(tmp_path / "box.ply")
        save_ply(make_box((0.5, 0.5, 0.5)), mesh)
    (js, ja), (ts, ta) = _corner_builds(_config(mesh, vial="square"))
    ref = np.asarray(jcorner(js, _jnp(ja), dist=2.5, radius=0.3))
    img = wf.render_corner(ts, scene_tensors(ta, "cpu"), dist=2.5,
                           radius=0.3).numpy()
    assert 0 < (ref > 0).sum() < ref.size
    np.testing.assert_array_equal(img, ref)


def test_ballistic_cull_against_radon_render(box_hole):
    """The port's two culls of one scene, held to test_radon_cull.py's
    criterion: at most 2 % of the pixels differ, each a boundary pixel
    (a neighbour in its DMD row kept by both)."""
    cfg = _config(box_hole)
    ts = TScene(cfg)
    mask = ts.sensor.discretize(ts.target_bank())
    a = set(tcull(*ts.build(mode="volume", include_target=False,
                            max_depth=5, rr_depth=6), mask, "cpu").tolist())
    st, at = ts.build(mode="radon", include_target=True, max_depth=5,
                      rr_depth=6, regular_sampling=True)
    img = wf.render_radon(st, scene_tensors(at, "cpu"), seed=0, spp=1)
    r = set(np.nonzero(img.numpy() > 0.0)[0].tolist())
    n = ts.projector.active_size()
    assert 0 < len(a) < n and 0 < len(r) < n
    diff = a.symmetric_difference(r)
    assert len(diff) <= 0.02 * n
    both, resx = a & r, ts.projector.resx
    for i in diff:
        col = i % resx
        assert (col + 1 < resx and i + 1 in both) or \
            (col >= 1 and i - 1 in both), i


# --------------------------------------------------------------------------
# the culling kernels' template under g++

HARNESS = r"""
#include <algorithm>
#include <vector>
#include "wf_cull.cuh"
using namespace wf;

// the culling kernel (cull_kernel) on one thread: the banks staged into a
// buffer standing for the CTA's shared memory (STAGED) or read from the
// global copies, the frame table (cull_frames), then the tasks of 32
// active pixels in order, each pixel's lanes in lane order, the pixel
// written once; the counters as the kernel counts them
template <int RES, bool TONLY, bool STAGED>
void run(const WfParams& P, const WfMesh& M, const CullArgs& A) {
  std::vector<float4> smem(STAGED ? (stage_bytes(A) + 15) / 16 : 0);
  const MeshBanks B = cull_banks<STAGED>(M, A, smem.data(), 0, 1);
  for (int a = 0; !P.sample_time && a < P.n_patterns; ++a)
    put_frame(A.frames + 3 * a, angle_frame(P, a));
  Grid G;
  G.init(P);
  MeshSink<true, STAGED> S{&M, B, A.dist, A.radius, 0.0f, 0,
                          {0, 0, 0, 0}};
  const float4* frames = P.sample_time ? nullptr : A.frames;
  unsigned long long slots = 0, boxed = 0;
  for (int t = 0; 32 * t < P.n_active; ++t) {
    unsigned long long most = 0;
    for (int l = 0; l < 32; ++l) {
      const unsigned long long c0 = S.mc.tris;
      cull_task<RES, TONLY>(P, G, A, frames, S, t, l, &boxed);
      most = std::max(most, S.mc.tris - c0);
    }
    slots += 32 * most;
  }
  const unsigned long long c[7] = {S.iters, S.mc.cells, S.mc.tris, slots,
                                   S.mc.walks, boxed, S.mc.repeats};
  for (int k = 0; k < 7; ++k) A.counters[k] += c[k];
}

// staged where the banks fit A.smem_limit (the kernel also caps it by the
// SM's shared memory)
template <int RES, bool TONLY>
void dispatch(const WfParams& P, const WfMesh& M, const CullArgs& A) {
  if (stage_bytes(A) <= (size_t)std::max(A.smem_limit, 0))
    run<RES, TONLY, true>(P, M, A);
  else
    run<RES, TONLY, false>(P, M, A);
}

extern "C" int wf_radon(const WfParams* P, const WfMesh* M,
                        const CullArgs* A, void*) {
  if (P->transmission_only)
    dispatch<RADON, true>(*P, *M, *A);
  else
    dispatch<RADON, false>(*P, *M, *A);
  return 0;
}

extern "C" int wf_corner(const WfParams* P, const WfMesh* M,
                         const CullArgs* A, void*) {
  dispatch<CORNER, true>(*P, *M, *A);
  return 0;
}

// the staged banks as cull_banks lays them out in shared memory
extern "C" int stage_banks(const WfMesh* M, const CullArgs* A, float4* out) {
  cull_banks<true>(*M, *A, out, 0, 1);
  return 0;
}

// the nearest hits of n rays on mesh surface s (ray_mesh), the banks read
// as staged (1) or global (0)
extern "C" int mesh_hits(const WfMesh* M, const float4* rows, int staged,
                         int s, const float* o, const float* d, int n,
                         float* t, int* tri) {
  const MeshBanks B{rows, M->cell_start, M->tri_ids};
  for (int i = 0; i < n; ++i) {
    MeshCount mc{0, 0, 0, 0};
    const V3 oi{o[3 * i], o[3 * i + 1], o[3 * i + 2]};
    const V3 di{d[3 * i], d[3 * i + 1], d[3 * i + 2]};
    t[i] = staged ? ray_mesh<false, true>(*M, B, s, oi, di, tri[i], mc)
                  : ray_mesh<false, false>(*M, B, s, oi, di, tri[i], mc);
  }
  return 0;
}
"""


def _build_harness(work, flags=()):
    """The harness built with g++ on the stubbed CUDA names (flags: extra
    compiler definitions), loaded, its entry points declared."""
    gxx = shutil.which("g++")
    assert gxx is not None, "the port's host code is built with g++"
    (work / "stub").mkdir()
    (work / "stub" / "cuda_runtime.h").write_text(STUB)
    (work / "harness.cpp").write_text(HARNESS)
    lib = work / "libcull_template.so"
    # IEEE float32 op by op, as nvcc --fmad=false; fmaf stays fused
    build = subprocess.run([gxx, "-std=c++17", "-O2", "-ffp-contract=off",
                            "-shared", "-fPIC", *flags, "-I",
                            str(work / "stub"), "-I", CUDA_SRC_DIR,
                            str(work / "harness.cpp"), "-o", str(lib)],
                           capture_output=True, text=True)
    assert build.returncode == 0, build.stderr
    lib = ctypes.CDLL(str(lib))
    for name in wf.CULL_KERNELS:
        wf._setup(lib, name)
    lib.mesh_hits.argtypes = [ctypes.POINTER(wf.WfMesh), ctypes.c_void_p,
                              ctypes.c_int, ctypes.c_int] + \
        [ctypes.c_void_p] * 2 + [ctypes.c_int] + [ctypes.c_void_p] * 2
    lib.mesh_hits.restype = ctypes.c_int
    lib.stage_banks.argtypes = [ctypes.POINTER(wf.WfMesh),
                                ctypes.POINTER(wf.CullArgs), ctypes.c_void_p]
    lib.stage_banks.restype = ctypes.c_int
    return lib


@pytest.fixture(scope="module")
def cull_lib(tmp_path_factory):
    return _build_harness(tmp_path_factory.mktemp("cull_template"))


@pytest.fixture(scope="module")
def cull_lib_no_early(tmp_path_factory):
    """The harness built with the triangle test's early returns off
    (WF_MESH_EARLY_EXIT 0: the test without a branch)."""
    return _build_harness(tmp_path_factory.mktemp("cull_no_early"),
                          ["-DWF_MESH_EARLY_EXIT=0"])


def test_early_rejection_keeps_every_hit(cull_lib, cull_lib_no_early):
    """The triangle test's early returns (csrc/wf_mesh.cuh moller_trumbore
    with EARLY) against the test without a branch, on random triangle
    soups from 1e-4 to 1e3 in scale: slivers, near-degenerate triangles
    (e2 nearly parallel to e1), triangles in a z-plane, horizontal rays,
    aimed inside the triangles and at their vertices and edges: the same
    t bitwise and the same triangle ids."""
    rng = np.random.default_rng(11)
    hits = 0
    for _ in range(12):
        T, n = 64, 8192
        scale = 10.0 ** rng.uniform(-4, 3)
        v0 = rng.normal(size=(T, 3)) * scale
        e1 = rng.normal(size=(T, 3)) * scale * \
            10.0 ** rng.uniform(-6, 1, (T, 1))
        e2 = rng.normal(size=(T, 3)) * scale * \
            10.0 ** rng.uniform(-6, 1, (T, 1))
        k = rng.integers(0, T, 16)
        e2[k] = e1[k] * rng.uniform(-2, 2, (16, 1)) + \
            rng.normal(size=(16, 3)) * scale * 1e-6
        e1[:8, 2] = 0.0
        e2[:8, 2] = 0.0
        v0, e1, e2 = (torch.from_numpy(x.astype(np.float32))
                      for x in (v0, e1, e2))
        o = rng.normal(size=(n, 3)).astype(np.float32) * np.float32(2 * scale)
        # aim at barycentrics (u, v) inside the triangles and at their
        # bounds: near each vertex and edge, from within and without
        u = rng.uniform(0, 1, n)
        v = rng.uniform(0, 1, n) * (1 - u)
        off = 10.0 ** rng.uniform(-7, -2, n) * rng.choice([-1, 1], n)
        kind = rng.integers(0, 5, n)
        u = np.select([kind == 1, kind == 2, kind == 3],
                      [1 - off, off, u], u)
        v = np.select([kind == 1, kind == 2, kind == 3, kind == 4],
                      [np.abs(off), 1 - off, 1 - u - off, off], v)
        j = rng.integers(0, T, n)
        d = (v0.numpy()[j] + u[:, None] * e1.numpy()[j] +
             v[:, None] * e2.numpy()[j] - o)
        d[:n // 4, 2] = 0.0
        d /= np.maximum(np.linalg.norm(d, axis=-1, keepdims=True), 1e-30)
        d = d.astype(np.float32)
        M = wf.WfMesh()
        M.tri_start[1], M.tri_count[1] = 0, T
        rows = wf.cull_rows({"tri_v0": v0, "tri_e1": e1, "tri_e2": e2})
        t, i = _mesh_hits(cull_lib, M, rows, False, o, d)
        t0, i0 = _mesh_hits(cull_lib_no_early, M, rows, False, o, d)
        assert torch.equal(t.view(torch.int32), t0.view(torch.int32))
        assert torch.equal(i, i0)
        hits += int(torch.isfinite(t).sum())
    assert hits > 0.1 * 12 * 8192


@pytest.mark.parametrize("mesh", ["gear", "box_hole", "box"])
def test_mesh_template_matches_plain(mesh, cull_lib):
    """ray_mesh (csrc/wf_mesh.cuh) against ray_triangles_grid (the gear,
    the box with a hole: grids) and ray_triangles (a 12-triangle box:
    brute force) on tests/test_mesh_grid.py's rays: t bitwise (fmaf
    against the plain version's float64 product and sum rounded once),
    the ids equal but for ties in t."""
    make = {"gear": lambda: make_hollow_gear(segments=240),
            "box_hole": lambda: make_box_with_hole((2.0, 2.0, 1.0), 0.6,
                                                   segments=99),
            "box": lambda: make_box((1.5, 1.5, 1.5))}[mesh]
    v0, e1, e2, nrm = (np.ascontiguousarray(a) for a in
                       make().triangle_bank())
    rng = np.random.default_rng(3)
    n = 4096
    o = rng.uniform(-3.0, 3.0, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    T = lambda x: torch.from_numpy(np.ascontiguousarray(x))  # noqa: E731
    tmin = torch.full((n,), 1e-4)
    keep = [T(a) for a in (v0, e1, e2, nrm)]
    M = wf.WfMesh()
    M.v0, M.e1, M.e2, M.n = (t.data_ptr() for t in keep)
    M.tri_start[1], M.tri_count[1] = 0, v0.shape[0]
    if mesh != "box":
        res, cs, ids, b0, b1 = build_tri_grid(v0, e1, e2)
        grid = [T(cs), T(ids), T(np.stack([b0, b1]))]
        keep += grid
        M.cell_start, M.tri_ids, M.grid_bbox = (t.data_ptr() for t in grid)
        M.grid_res[3:6] = list(res)
        M.n_ids[1] = ids.shape[0]
        ref_t, ref_i = ray_triangles_grid(T(o), T(d), tmin, *keep[:3],
                                          *grid[:2], grid[2][0], grid[2][1],
                                          res)
    else:
        ref_t, ref_i = ray_triangles(T(o), T(d), tmin, *keep[:3])
    rows = wf.cull_rows({"tri_v0": keep[0], "tri_e1": keep[1],
                         "tri_e2": keep[2]})
    t, i = _mesh_hits(cull_lib, M, rows, False, o, d)
    ref_t, ref_i = ref_t.numpy(), ref_i.numpy()
    assert np.isfinite(ref_t).mean() > 0.05
    np.testing.assert_array_equal(t.numpy(), ref_t)
    for k in np.nonzero(i.numpy() != ref_i)[0]:
        for tri in (int(i[k]), int(ref_i[k])):
            tk, _ = ray_triangles(T(o[k:k + 1]), T(d[k:k + 1]),
                                  tmin[:1], *(x[tri:tri + 1]
                                              for x in keep[:3]))
            assert float(tk[0]) == ref_t[k]


def _small(mesh_path, vial, albedo, projector):
    cfg = _config(mesh_path, albedo, vial, projector, n_patterns=8, resx=16,
                  resy=8, film=(24, 24, 12))
    return TScene(cfg)


def _mesh_hits(lib, M, rows, staged, o, d):
    """ray_mesh on surface 1 of M for rays o, d (n, 3): (t, triangle)."""
    n = o.shape[0]
    t = torch.empty(n)
    i = torch.empty(n, dtype=torch.int32)
    o, d = (torch.from_numpy(np.ascontiguousarray(x)) for x in (o, d))
    assert lib.mesh_hits(ctypes.byref(M), rows.data_ptr(), int(staged), 1,
                         o.data_ptr(), d.data_ptr(), n, t.data_ptr(),
                         i.data_ptr()) == 0
    return t, i


def _cull_run(lib, name, static, at, seed, spp, dist=0.0, radius=0.0,
              staged=True):
    """The culling kernel `name` under g++, launched as the wrapper
    launches it (its WfParams, WfMesh and CullArgs): (image, counters)."""
    P = wf._cull_params(name, static, at, seed, spp)
    M = wf.make_mesh(name, static, at)
    A, keep = wf._cull_args(name, static, at, dist, radius, staged=staged,
                            stats={})
    assert getattr(lib, name)(ctypes.byref(P), ctypes.byref(M),
                              ctypes.byref(A), None) == 0
    return keep["img"], dict(zip(wf.CULL_COUNTERS,
                                 keep["counter"].tolist()))


# (vial, albedo, projector, regular sampling, spp, transmission only,
# target: the box with a hole (grid) or a box (brute force))
TELE = {"type": "telecentric", "aperture_radius": 0.1,
        "focus_distance": 20.0}
TEMPLATE_CASES = [
    ("cylindrical", 0.0, None, True, 1, True, "box_hole"),
    ("square", 0.5, TELE, False, 2, False, "box"),
    ("cylindrical", 0.5, TELE, False, 2, True, "box_hole"),
    # a mesh vial, its walls in the banks beside the target's
    ("custom", 0.0, None, True, 1, True, "box_hole"),
    ("custom", 0.5, TELE, False, 2, False, "box_hole"),
]


@pytest.mark.parametrize("case", TEMPLATE_CASES)
def test_radon_template_traces_the_plain_radon(case, cull_lib, box_hole,
                                               tmp_path):
    """The RADON lane mode against the plain march's radon mode: the same
    bounce iterations, the image to 1e-4 of its max (glibc's expf against
    torch's), the same kept set; the target's grid cells and triangles
    counted."""
    vial, albedo, proj, regular, spp, tonly, target = case
    mesh = box_hole
    if target == "box":
        mesh = str(tmp_path / "box.ply")
        save_ply(make_box((0.5, 0.5, 0.5)), mesh)
    static, arr = _small(mesh, vial, albedo, proj).build(
        mode="radon", include_target=True, max_depth=5, rr_depth=3,
        regular_sampling=regular, transmission_only=tonly)
    at = scene_tensors(arr, "cpu")
    stats = {}
    ref = wf._radon(static, at, 7, spp, 512, stats)
    img, c = _cull_run(cull_lib, "wf_radon", static, at, 7, spp)
    assert c["iterations"] == stats["iterations"]
    assert c["triangles"] > 0
    assert (c["cells"] > 0) == (target == "box_hole")
    assert 0 < int((ref > 0).sum()) < ref.numel()
    np.testing.assert_allclose(img.numpy(), ref.numpy(), rtol=0,
                               atol=1e-4 * float(ref.max()))
    np.testing.assert_array_equal(img.numpy() > 0, ref.numpy() > 0)


@pytest.mark.parametrize("projector", ["collimated", "telecentric"])
def test_corner_template_matches_plain(projector, cull_lib, box_hole):
    static, arr = _small(box_hole, "square", 0.0,
                         TELE if projector == "telecentric" else None).build(
        mode="volume", include_target=True, max_depth=1, rr_depth=6,
        regular_sampling=True)
    at = scene_tensors(arr, "cpu")
    ref = wf.render_corner(static, at, dist=2.5, radius=0.3)
    img, c = _cull_run(cull_lib, "wf_corner", static, at, 0, 1, 2.5, 0.3)
    assert 0 < int((ref > 0).sum()) < ref.numel()
    np.testing.assert_array_equal(img.numpy(), ref.numpy())


@pytest.mark.parametrize("case", TEMPLATE_CASES + ["corner"])
def test_staged_banks_equal_global_banks(case, cull_lib, box_hole,
                                         tmp_path):
    """The culling kernel with the mesh banks staged (a budget that holds
    them) and read from the global copies (a budget of 0 bytes, as a
    100k-triangle mesh takes): the same image bitwise and the same
    counts."""
    if case == "corner":
        static, arr = _small(box_hole, "square", 0.0, None).build(
            mode="volume", include_target=True, max_depth=1, rr_depth=6,
            regular_sampling=True)
        name, seed, spp, extra = "wf_corner", 0, 1, (2.5, 0.3)
    else:
        vial, albedo, proj, regular, spp, tonly, target = case
        mesh = box_hole
        if target == "box":
            mesh = str(tmp_path / "box.ply")
            save_ply(make_box((0.5, 0.5, 0.5)), mesh)
        static, arr = _small(mesh, vial, albedo, proj).build(
            mode="radon", include_target=True, max_depth=5, rr_depth=3,
            regular_sampling=regular, transmission_only=tonly)
        name, seed, extra = "wf_radon", 7, ()
    at = scene_tensors(arr, "cpu")
    staged, c_s = _cull_run(cull_lib, name, static, at, seed, spp, *extra)
    glob, c_g = _cull_run(cull_lib, name, static, at, seed, spp, *extra,
                          staged=False)
    assert torch.equal(staged, glob) and c_s == c_g
    assert c_s["triangles"] > 0 and float(staged.abs().max()) > 0


def test_cull_rows_hold_the_banks(cull_lib, box_hole):
    """The triangle rows (v0, e1, e2 padded to 16 bytes) hold the scene's
    banks' values, and the staged banks (cull_banks) are the rows, the
    cell starts and the triangle ids, in that order, bytewise."""
    static, arr = _small(box_hole, "cylindrical", 0.0, None).build(
        mode="radon", include_target=True, max_depth=5, rr_depth=3)
    at = scene_tensors(arr, "cpu")
    rows = wf.cull_rows(at).reshape(-1, 3, 4)
    for k, key in enumerate(("tri_v0", "tri_e1", "tri_e2")):
        assert torch.equal(rows[:, k, :3], at[key])
    assert not bool(rows[:, :, 3].any())
    assert wf.cull_rows(at) is wf.cull_rows(at)
    M = wf.make_mesh("wf_radon", static, at)
    A, keep = wf._cull_args("wf_radon", static, at)
    cs, ids = at["grid_cell_start"], at["grid_tri_ids"]
    out = torch.full((rows.numel() + cs.numel() + ids.numel(),), -1.0)
    assert cull_lib.stage_banks(ctypes.byref(M), ctypes.byref(A),
                                out.data_ptr()) == 0
    assert A.n_rows == 3 * at["tri_v0"].shape[0]
    n = rows.numel()
    assert torch.equal(out[:n], rows.reshape(-1))
    assert torch.equal(out[n:].view(torch.int32), torch.cat([cs, ids]))


@pytest.mark.parametrize("mesh", ["gear", "box_hole", "box"])
def test_mesh_staged_equals_global(mesh, cull_lib):
    """ray_mesh reading its banks as staged and as global: the same t and
    triangle ids bitwise, on tests/test_mesh_grid.py's rays."""
    make = {"gear": lambda: make_hollow_gear(segments=240),
            "box_hole": lambda: make_box_with_hole((2.0, 2.0, 1.0), 0.6,
                                                   segments=99),
            "box": lambda: make_box((1.5, 1.5, 1.5))}[mesh]
    banks = [torch.from_numpy(np.ascontiguousarray(a))
             for a in make().triangle_bank()]
    M = wf.WfMesh()
    M.tri_start[1], M.tri_count[1] = 0, banks[0].shape[0]
    if mesh != "box":
        res, cs, ids, b0, b1 = build_tri_grid(*(b.numpy() for b in
                                                banks[:3]))
        grid = [torch.from_numpy(x) for x in (cs, ids, np.stack([b0, b1]))]
        banks += grid
        M.cell_start, M.tri_ids, M.grid_bbox = (t.data_ptr() for t in grid)
        M.grid_res[3:6] = list(res)
    rows = wf.cull_rows({"tri_v0": banks[0], "tri_e1": banks[1],
                         "tri_e2": banks[2]})
    rng = np.random.default_rng(3)
    o = rng.uniform(-3.0, 3.0, (4096, 3)).astype(np.float32)
    d = rng.normal(size=(4096, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    t_s, i_s = _mesh_hits(cull_lib, M, rows, True, o, d)
    t_g, i_g = _mesh_hits(cull_lib, M, rows, False, o, d)
    assert np.isfinite(t_s.numpy()).mean() > 0.05
    assert torch.equal(t_s, t_g) and torch.equal(i_s, i_g)


# --------------------------------------------------------------------------
# both CLIs


def _cli_config(work, out, vial="cylindrical", projector=None):
    v = {"cylindrical": {"type": "cylindrical", "r_int": 4.0, "r_ext": 4.4,
                         "ior": 1.54},
         "square": {"type": "square", "w_int": 8.0, "w_ext": 8.8,
                    "ior": 1.54}}[vial]
    proj = {"type": "collimated", "n_patterns": 24, "resx": 32, "resy": 8,
            "pixel_size": 0.3, "motion": "circular", "distance": 20}
    proj.update(projector or {})
    return {"vial": dict(v, medium={"ior": 1.40, "extinction": 0.05,
                                    "albedo": 0.0}),
            "projector": proj,
            "sensor": {"type": "dda", "scalex": 9.6, "scaley": 9.6,
                       "scalez": 2.4,
                       "film": {"type": "vfilm", "resx": 32, "resy": 32,
                                "resz": 8}},
            "target": {"filename": str(work / "box_hole.ply"),
                       "size": 4.0},
            "loss": {"type": "threshold", "tl": 0.85, "tu": 0.95},
            "n_steps": 3, "output": str(work / out)}


CLI_CASES = {
    "filter_radon": ({"filter_radon": True}, {}),
    "filter_radon_telecentric": (
        {"filter_radon": True, "spp": 1, "spp_ref": 1, "n_steps": 2,
         "spp_filter_radon": 2},
        {"projector": {"type": "telecentric", "aperture_radius": 0.05,
                       "focus_distance": 20.0}}),
    "filter_corner": ({"filter_corner": {"dist": 4.4, "radius": 0.6}},
                      {"vial": "square"}),
}


def _files(root):
    return sorted(os.path.relpath(os.path.join(dr, f), root)
                  for dr, _, fs in os.walk(root) for f in fs)


@pytest.mark.parametrize("case", list(CLI_CASES))
def test_clis_agree_with_culling(case, tmp_path, monkeypatch):
    save_ply(make_box_with_hole((2.0, 2.0, 0.5), 1.0,
                                hole_center_xy=(-1.0, 0.0)),
             str(tmp_path / "box_hole.ply"))
    extra, kw = CLI_CASES[case]
    kept = {}
    for name, mod in (("jax", jprojector), ("torch", tprojector)):
        orig = mod.Projector.set_active

        def record(self, pixels, data, orig=orig, name=name):
            kept[name] = np.asarray(pixels).copy()
            return orig(self, pixels, data)
        monkeypatch.setattr(mod.Projector, "set_active", record)
    paths = {}
    for name in ("jax", "torch"):
        cfg = dict(_cli_config(tmp_path, name, **kw), **extra)
        paths[name] = tmp_path / f"{name}.json"
        paths[name].write_text(json.dumps(cfg))
    jmain([str(paths["jax"]), "--backend", "cpu"])
    tmain([str(paths["torch"]), "--device", "cpu"])
    n_dense = 24 * 8 * 32
    assert 0 < kept["torch"].size < n_dense
    np.testing.assert_array_equal(kept["torch"], kept["jax"])
    j, t = tmp_path / "jax", tmp_path / "torch"
    assert _files(t) == _files(j)
    np.testing.assert_allclose(np.load(t / "loss.npy"),
                               np.load(j / "loss.npy"), rtol=1e-4)


@pytest.mark.parametrize("case", ["radon_empty", "corner_empty",
                                  "dose_volume"])
def test_culling_errors(case, tmp_path):
    """The JAX driver's three culling errors: a filter that removes every
    DMD pixel, and a filter on a recorded dose volume (no target mesh)."""
    save_ply(make_box_with_hole((2.0, 2.0, 0.5), 1.0,
                                hole_center_xy=(-1.0, 0.0)),
             str(tmp_path / "box_hole.ply"))
    cfg = _cli_config(tmp_path, "out", vial="square")
    if case == "radon_empty":
        # the target far outside the film: its occupancy is empty
        cfg.update(filter_radon=True)
        cfg["target"]["box_center_x"] = 100.0
        match = "Radon culling removed every DMD pixel"
    elif case == "corner_empty":
        cfg["filter_corner"] = {"dist": 0.0, "radius": 100.0}
        match = "Corner culling removed every DMD pixel"
    else:
        dose = tmp_path / "dose.npy"
        np.save(dose, np.zeros((8, 32, 32), np.float32))
        cfg.update(filter_radon=True, target={"dose_npy": str(dose)})
        match = "need a target mesh"
    path = tmp_path / "cfg.json"
    path.write_text(json.dumps(cfg))
    with pytest.raises(ValueError, match=match):
        tmain([str(path), "--device", "cpu"])
