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
from drtvam_tpu.ops.mesh import (make_box, make_box_with_hole,
                                 make_hollow_gear, save_ply)
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


@pytest.fixture(scope="module")
def box_hole(tmp_path_factory):
    """tests/conftest.py's box_hole_mesh: the box with a through-hole
    (792 triangles: the grid)."""
    path = tmp_path_factory.mktemp("cull") / "box_hole.ply"
    save_ply(make_box_with_hole((2.0, 2.0, 1.0), 0.5, segments=99),
             str(path))
    return str(path)


def _config(mesh, albedo=0.0, vial="cylindrical", projector=None,
            n_patterns=32, resx=64, resy=16, film=(48, 48, 24)):
    """tests/test_radon_cull.py's scene (its defaults)."""
    vials = {"cylindrical": {"type": "cylindrical", "r_int": 2.6,
                             "r_ext": 2.9, "ior": 1.54},
             "square": {"type": "square", "w_int": 4.6, "w_ext": 5.0,
                        "ior": 1.54}}
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
#include "wf_trace.cuh"
using namespace wf;

// the culling kernels' loop (cull_kernel) on one thread: pixel by pixel
// in active order, each pixel's lanes in lane order, the pixel written once
template <int RES, bool TONLY>
void run(const WfParams& P, const WfMesh& M, const int* ap, float dist,
         float radius, float* img, unsigned long long* c) {
  Grid G;
  G.init(P);
  MeshSink<true> S{&M, dist, radius, 0.0f, 0, {0, 0}};
  for (int aidx = 0; aidx < P.n_active; ++aidx) {
    float sum = 0.0f;
    for (int k = 0; k < P.spp; ++k) {
      S.L = 0.0f;
      trace_lane<DDA, false, TONLY, RES>(
          P, G, (uint32_t)aidx * (uint32_t)P.spp + (uint32_t)k, aidx, ap,
          1.0f, S);
      sum = k == 0 ? S.L : sum + S.L;
    }
    img[P.identity ? aidx : ap[aidx]] = sum * P.ray_w;
  }
  c[0] += S.iters;
  c[1] += S.mc.cells;
  c[2] += S.mc.tris;
}

extern "C" int wf_radon(const WfParams* P, const WfMesh* M, const int* ap,
                        float* img, unsigned long long* c, void*) {
  if (P->transmission_only)
    run<RADON, true>(*P, *M, ap, 0.0f, 0.0f, img, c);
  else
    run<RADON, false>(*P, *M, ap, 0.0f, 0.0f, img, c);
  return 0;
}

extern "C" int wf_corner(const WfParams* P, const WfMesh* M, const int* ap,
                         float dist, float radius, float* img,
                         unsigned long long* c, void*) {
  run<CORNER, true>(*P, *M, ap, dist, radius, img, c);
  return 0;
}

// the nearest hits of n rays on mesh surface s (ray_mesh)
extern "C" int mesh_hits(const WfMesh* M, int s, const float* o,
                         const float* d, int n, float* t, int* tri) {
  for (int i = 0; i < n; ++i) {
    MeshCount mc{0, 0};
    t[i] = ray_mesh<false>(*M, s, V3{o[3 * i], o[3 * i + 1], o[3 * i + 2]},
                           V3{d[3 * i], d[3 * i + 1], d[3 * i + 2]}, tri[i],
                           mc);
  }
  return 0;
}
"""


@pytest.fixture(scope="module")
def cull_lib(tmp_path_factory):
    gxx = shutil.which("g++")
    assert gxx is not None, "the port's host code is built with g++"
    work = tmp_path_factory.mktemp("cull_template")
    (work / "stub").mkdir()
    (work / "stub" / "cuda_runtime.h").write_text(STUB)
    (work / "harness.cpp").write_text(HARNESS)
    lib = work / "libcull_template.so"
    # IEEE float32 op by op, as nvcc --fmad=false; fmaf stays fused
    build = subprocess.run([gxx, "-std=c++17", "-O2", "-ffp-contract=off",
                            "-shared", "-fPIC", "-I", str(work / "stub"),
                            "-I", CUDA_SRC_DIR, str(work / "harness.cpp"),
                            "-o", str(lib)], capture_output=True, text=True)
    assert build.returncode == 0, build.stderr
    lib = ctypes.CDLL(str(lib))
    for name in wf.CULL_KERNELS:
        wf._setup(lib, name)
    lib.mesh_hits.argtypes = [ctypes.POINTER(wf.WfMesh), ctypes.c_int] + \
        [ctypes.c_void_p] * 2 + [ctypes.c_int] + [ctypes.c_void_p] * 2
    lib.mesh_hits.restype = ctypes.c_int
    return lib


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
    t = torch.empty(n)
    i = torch.empty(n, dtype=torch.int32)
    assert cull_lib.mesh_hits(ctypes.byref(M), 1, T(o).data_ptr(),
                              T(d).data_ptr(), n, t.data_ptr(),
                              i.data_ptr()) == 0
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


def _cull_run(lib, name, static, at, seed, spp, corner=False, *args):
    P = wf.make_params(static, at, seed, spp, corner=corner)
    if corner:
        P.regular_sampling, P.sample_time = 1, 0
    M = wf.make_mesh(name, static, at)
    p = static.projector
    img = torch.zeros(p.n_patterns * p.resy * p.resx)
    c = (ctypes.c_ulonglong * 3)()
    assert getattr(lib, name)(ctypes.byref(P), ctypes.byref(M),
                              at["active_pixels"].data_ptr(), *args,
                              img.data_ptr(), ctypes.addressof(c),
                              None) == 0
    return img, dict(zip(wf.CULL_COUNTERS, c))


# (vial, albedo, projector, regular sampling, spp, transmission only,
# target: the box with a hole (grid) or a box (brute force))
TELE = {"type": "telecentric", "aperture_radius": 0.1,
        "focus_distance": 20.0}
TEMPLATE_CASES = [
    ("cylindrical", 0.0, None, True, 1, True, "box_hole"),
    ("square", 0.5, TELE, False, 2, False, "box"),
    ("cylindrical", 0.5, TELE, False, 2, True, "box_hole"),
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
    img, c = _cull_run(cull_lib, "wf_corner", static, at, 0, 1, True,
                       2.5, 0.3)
    assert 0 < int((ref > 0).sum()) < ref.numel()
    np.testing.assert_array_equal(img.numpy(), ref.numpy())


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
