"""Mesh ('custom') vials on the port against the JAX package, on the CPU.

  * parsing: CustomVial's surfaces (two dielectric meshes, the medium
    inside the inner one) and its errors, as the JAX package's;
  * the mesh builders the tests and chip_smoke.py build with
    (make_open_box, make_box_tube, make_hollow_gear, make_cylinder_shell,
    TriMesh.transformed_matrix): vertices and faces bitwise the JAX
    package's;
  * the scene arrays of a custom vial, an occlusion, both, and both
    with a surface-aware target: the static description equal and the
    arrays key for key, bitwise;
  * the dose and pattern gradient through a cuvette at the same seed:
    dda at albedo 0 to 1e-4 of the largest |value| with none off (the
    wavefront's same-seed tolerance, tests/test_torch_wavefront.py),
    delta at albedo 0.5 with at most 0.2 % of the nonzero values off
    (a delta deposit is a point: a position an ulp off can land in the
    next voxel), the totals to 1e-5 (delta 2e-3);
  * the mesh cuvette against the port's analytic square vial with the
    same walls (tube height past the film, so a collimated ray meets
    the side walls only): the total dose within 1e-5 relative and at
    most 1 % of the voxels off by more than 1e-3 of the max (the two
    intersections round the same hit an ulp apart, and a dda walk that
    starts an ulp on the other side of a voxel boundary takes another
    voxel first);
  * the culling renders through a cuvette with an occlusion (the radon
    render at spp 2; the corner render at the cuvette's corners): the
    radon image to 1e-4 of its max with the same kept set, the corner
    keep image equal, as tests/test_torch_culling.py holds them;
  * the home-slice tile (ops/render.py tile_rows) of a mesh vial laid
    out from its triangles: the analytic square vial's rows, within a
    column a row;
  * engine selection: auto runs the wavefront on a mesh vial or an
    occlusion, at albedo 0 and 0.5; "ballistic" and "hybrid" raise in
    both drivers (the JAX package's assertion, the port's ValueError);
  * both CLIs on tests/test_e2e_scenes.py's smoke configs (the
    occlusion in a square vial with filter_radon, the custom cuvette
    with a telecentric projector): the same step count, the loss
    history to 1e-4, the same artifact files, the same kept pixels;
  * both drivers on a small cut of chip_smoke.py's cell (d) (a
    scattering resin in the mesh cuvette beside the occlusion, the delta
    sensor, filter_radon; the port's forward on the delta target form):
    the loss history and the final dose at the delta tolerance above.
"""
import ctypes
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from drtvam_tpu.models import projector as jprojector
from drtvam_tpu.models.scene import Scene as JScene
from drtvam_tpu.ops import mesh as jmesh
from drtvam_tpu.ops.render import _adjoint as j_adjoint
from drtvam_tpu.ops.render import render as j_render
from drtvam_tpu.ops.render import render_corner as j_corner
from drtvam_tpu.ops.render import render_radon as j_radon
from drtvam_tpu.opt.optimize import main as jmain
from drtvam_tpu.opt.optimize import optimize as joptimize
from drtvam_tpu_torch.convert import scene_from_jax
from drtvam_tpu_torch.models import projector as tprojector
from drtvam_tpu_torch.models.geometry import (DIELECTRIC, MESH,
                                              CustomVial, IOR_AIR)
from drtvam_tpu_torch.models.scene import Scene as TScene
from drtvam_tpu_torch.ops import mesh as tmesh
from drtvam_tpu_torch.ops import render as tr
from drtvam_tpu_torch.ops.march import scene_tensors
from drtvam_tpu_torch.opt.optimize import main as tmain
from drtvam_tpu_torch.opt.optimize import optimize as toptimize
from drtvam_tpu_torch.opt.optimize import select_engine
from test_e2e_scenes import smoke_config
from torch_jax_native import jax_native_libraries  # noqa: F401
from torch_threads import one_torch_thread  # noqa: F401

TOL = 1e-4
POINT_SHARE = 2e-3
CHUNK = 1 << 15
MEDIUM = {"ior": 1.33, "phase": {"type": "rayleigh"}, "extinction": 0.06,
          "albedo": 0.0}


@pytest.fixture(scope="module")
def work(tmp_path_factory):
    """tests/test_e2e_scenes.py's meshes: the box with a hole (the
    target), the occlusion box and the cuvette's tubes; and the square
    bench vial's walls as tubes."""
    path = tmp_path_factory.mktemp("cuvette")
    meshes = {
        "box_hole.ply": tmesh.make_box_with_hole(
            (2.0, 2.0, 0.5), 1.0, hole_center_xy=(-1.0, 0.0), segments=99),
        "occ.ply": tmesh.make_box((1.0, 0.5, 0.25)),
        "cuv_outer.ply": tmesh.make_box_tube(3.765, 3.71, -5.0, 5.0),
        "cuv_inner.ply": tmesh.make_box_tube(2.5, 2.41, -5.0, 5.0),
        "sq_outer.ply": tmesh.make_box_tube(3.6, 3.6, -50.0, 50.0),
        "sq_inner.ply": tmesh.make_box_tube(3.4, 3.4, -45.0, 45.0),
    }
    for name, m in meshes.items():
        tmesh.save_ply(m, str(path / name))
    return path


def _cuvette(work, outer="cuv_outer.ply", inner="cuv_inner.ply",
             medium=None, **extra):
    return dict({"type": "custom", "filename_vial_outer": str(work / outer),
                 "filename_vial_inner": str(work / inner), "ior": 1.4702,
                 "medium": dict(MEDIUM, **(medium or {}))}, **extra)


def _config(work, vial, estimator="dda", surface_aware=False, n_patterns=12,
            resx=24, resy=10, pixel_size=0.32, film=(24, 24, 12)):
    cfg = {"vial": vial,
           "projector": {"type": "collimated", "n_patterns": n_patterns,
                         "resx": resx, "resy": resy,
                         "pixel_size": pixel_size, "motion": "circular",
                         "distance": 20},
           "sensor": {"type": estimator, "scalex": 5, "scaley": 5,
                      "scalez": 1.25, "majorant": 1.0,
                      "film": {"type": "vfilm", "resx": film[0],
                               "resy": film[1], "resz": film[2]}},
           "target": {"filename": str(work / "box_hole.ply"), "size": 4.0},
           "output": str(work)}
    if surface_aware:
        cfg["final_sensor"] = json.loads(json.dumps(cfg["sensor"]))
        cfg["sensor"]["film"]["surface_aware"] = True
    return cfg


# --------------------------------------------------------------------------
# parsing and the builders


def test_custom_vial_surfaces_and_errors(work):
    vial = _cuvette(work, occlusions=[{"filename": str(work / "occ.ply")}])
    surfaces = CustomVial(vial).surfaces()
    assert [s.kind for s in surfaces] == [MESH] * 3
    outer, inner, occ = surfaces
    assert outer.bsdf == inner.bsdf == DIELECTRIC
    assert (outer.medium_side, inner.medium_side, occ.medium_side) == \
        (0, 1, 2)
    assert outer.eta == 1.4702 / IOR_AIR and inner.eta == 1.33 / 1.4702
    assert inner.mesh.faces.shape == (8, 3)
    for missing in ("filename_vial_outer", "filename_vial_inner"):
        bad = {k: v for k, v in vial.items() if k != missing}
        for cls in (CustomVial, JScene):
            with pytest.raises(ValueError, match="filename_vial_outer"):
                if cls is CustomVial:
                    cls(bad).surfaces()
                else:
                    cls(_config(work, bad)).build()
    no_medium = {k: v for k, v in vial.items() if k != "medium"}
    with pytest.raises(ValueError, match="Missing field 'medium'"):
        CustomVial(no_medium)


BUILDERS = {
    "open_box": lambda m: m.make_open_box((1.0, 0.8, 0.6), 0.1),
    "closed_box": lambda m: m.make_open_box((1.0, 0.8, 0.6), 0.1,
                                            open_top=False),
    "box_tube": lambda m: (m.make_box_tube(3.765, 3.71, -5.0, 5.0),
                           m.make_box_tube(2.5, 2.41, -5.0, 5.0, flip=True)),
    "hollow_gear": lambda m: m.make_hollow_gear(),
    "hollow_gear_small": lambda m: m.make_hollow_gear(
        r_out=0.9, r_root=0.7, r_hole=0.3, half_height=0.3, segments=120),
    "cylinder_shell": lambda m: (m.make_cylinder_shell(2.3, -4.0, 4.0),
                                 m.make_cylinder_shell(1.0, -1.0, 2.0, 17,
                                                       flip=True)),
    "transformed_matrix": lambda m: m.make_box(
        (0.5, 1.0, 2.0), center=(3.0, -1.0, 5.0)).transformed_matrix(
            [[0.0, -2.0, 0.0, 1.5], [2.0, 0.0, 0.0, -0.25],
             [0.0, 0.0, 2.0, 3.0], [0.0, 0.0, 0.0, 1.0]]),
}


@pytest.mark.parametrize("name", list(BUILDERS))
def test_mesh_builders_equal_jax(name):
    ours, ref = BUILDERS[name](tmesh), BUILDERS[name](jmesh)
    ours = ours if isinstance(ours, tuple) else (ours,)
    ref = ref if isinstance(ref, tuple) else (ref,)
    assert len(ours) == len(ref)
    for a, b in zip(ours, ref):
        assert a.vertices.dtype == b.vertices.dtype == np.float32
        np.testing.assert_array_equal(a.vertices, b.vertices)
        np.testing.assert_array_equal(a.faces, b.faces)
        for x, y in zip(a.triangle_bank(), b.triangle_bank()):
            np.testing.assert_array_equal(x, y)


# --------------------------------------------------------------------------
# scene arrays


def _same_scene(cfg, **build):
    """Both packages' scenes of cfg: the port's static description equal
    to the JAX package's and its arrays bitwise. Returns (JAX static, JAX
    arrays, port static, port tensors)."""
    js, ts = JScene(cfg), TScene(cfg)
    include = ts.sensor.surface_aware
    jst, jarr = js.build(mode="volume", include_target=include, **build)
    tst, tarr = ts.build(mode="volume", include_target=include, **build)
    cst, carr = scene_from_jax(jst, jarr)
    assert tst == cst
    assert sorted(tarr) == sorted(carr)
    for k in tarr:
        a = np.asarray(tarr[k])
        assert a.dtype == carr[k].dtype and a.shape == carr[k].shape, k
        np.testing.assert_array_equal(a, carr[k], err_msg=k)
    return jst, jarr, tst, scene_tensors(tarr, "cpu")


SCENES = {
    "custom": lambda w: _config(w, _cuvette(w)),
    "occlusion": lambda w: _config(w, {
        "type": "square", "w_int": 7.191, "w_ext": 7.6, "ior": 1.3,
        "medium": MEDIUM, "occlusions": [{"filename": str(w / "occ.ply")}]}),
    "custom_occlusion": lambda w: _config(w, _cuvette(w, occlusions=[
        {"filename": str(w / "occ.ply"),
         "bsdf": {"type": "diffuse", "reflectance": 0.4}}])),
    "custom_occlusion_surface_aware": lambda w: _config(w, _cuvette(
        w, occlusions=[{"filename": str(w / "occ.ply"),
                        "bsdf": {"type": "null"}}]), surface_aware=True),
}


@pytest.mark.parametrize("name", list(SCENES))
def test_scene_arrays_match_jax(name, work):
    _, _, tst, ta = _same_scene(SCENES[name](work), max_depth=8, rr_depth=4)
    meshes = [s for s in tst.surfaces if s.kind == MESH]
    assert len(meshes) == {"custom": 2, "occlusion": 1,
                           "custom_occlusion": 3,
                           "custom_occlusion_surface_aware": 4}[name]
    assert tr.target_mode(tst) == (2 if "surface_aware" in name else 1)
    # the kernels' mesh banks: each surface's slice of the merged rows
    M = tr.make_mesh("wf_fwd", tst, ta)
    for i, s in enumerate(tst.surfaces):
        if s.kind == MESH:
            assert (M.tri_start[i], M.tri_count[i]) == s.tri_slice
    assert M.n_rows == 3 * sum(s.tri_slice[1] for s in meshes)


# --------------------------------------------------------------------------
# dose and gradient at the same seed


def _inputs(static, seed):
    rng = np.random.default_rng(seed)
    data = rng.uniform(0.5, 1.5, static.projector.n_active) \
        .astype(np.float32)
    dL = rng.uniform(0.0, 1.0, static.sensor.n_cells).astype(np.float32)
    return data, dL


def _within(port, ref, point):
    assert port.shape == ref.shape and np.isfinite(port).all()
    scale = float(np.abs(ref).max())
    assert scale > 0.0
    off = int((np.abs(port - ref) > TOL * scale).sum())
    assert off <= (POINT_SHARE * np.count_nonzero(ref) if point else 0), off
    np.testing.assert_allclose(port.sum(dtype=np.float64),
                               ref.sum(dtype=np.float64),
                               rtol=2e-3 if point else 1e-5)


@pytest.mark.parametrize("estimator,albedo", [("dda", 0.0), ("delta", 0.5)])
def test_cuvette_dose_and_gradient_match_jax(estimator, albedo, work):
    cfg = _config(work, _cuvette(work, medium={"albedo": albedo}),
                  estimator=estimator)
    jst, jarr, tst, ta = _same_scene(cfg, max_depth=8, rr_depth=4,
                                     sample_time=True)
    data, dL = _inputs(tst, 9)
    seed, spp = 5, 2
    vj = np.asarray(jax.jit(lambda d: j_render(
        jst, jarr, d, 1.0, seed=seed, spp=spp, chunk=CHUNK))(
            jnp.asarray(data)))
    gj = np.asarray(jax.jit(lambda dl: j_adjoint(
        jst, jarr, jnp.uint32(seed), spp, CHUNK, dl)[0])(jnp.asarray(dL)))
    vt = tr.render(tst, ta, torch.from_numpy(data), 1.0, seed=seed,
                   spp=spp).numpy()
    gt = tr.adjoint(tst, ta, seed, spp, tr.DEFAULT_CHUNK,
                    torch.from_numpy(dL)).numpy()
    point = estimator == "delta"
    _within(vt, vj, point)
    _within(gt, gj, point)


@pytest.mark.parametrize("render", ["radon", "corner"])
def test_culling_renders_match_jax(render, work):
    cfg = _config(work, _cuvette(work, occlusions=[
        {"filename": str(work / "occ.ply"),
         "bsdf": {"type": "dielectric"}}]))
    kw = (dict(mode="radon", max_depth=5, rr_depth=6) if render == "radon"
          else dict(mode="volume", max_depth=1, rr_depth=6,
                    regular_sampling=True))
    jst, jarr = JScene(cfg).build(include_target=True, **kw)
    tst, tarr = TScene(cfg).build(include_target=True, **kw)
    ta = scene_tensors(tarr, "cpu")
    jarr = {k: jnp.asarray(v) for k, v in jarr.items()}
    if render == "radon":
        ref = np.asarray(j_radon(jst, jarr, seed=3, spp=2))
        img = tr.render_radon(tst, ta, seed=3, spp=2).numpy()
        np.testing.assert_allclose(img, ref, rtol=0, atol=1e-4 * ref.max())
        np.testing.assert_array_equal(img > 0, ref > 0)
    else:
        ref = np.asarray(j_corner(jst, jarr, dist=3.7, radius=0.3))
        img = tr.render_corner(tst, ta, dist=3.7, radius=0.3).numpy()
        np.testing.assert_array_equal(img, ref)
    assert 0 < (ref > 0).sum() < ref.size


def _square_pair(work, **kw):
    """The square vial of w_ext 7.2, w_int 6.8 (height 100) and the same
    walls as meshes (tubes of z +-50 and +-45), on the port."""
    med = dict(MEDIUM, extinction=0.1)
    out = []
    for vial in ({"type": "square", "w_ext": 7.2, "w_int": 6.8,
                  "ior": 1.54, "medium": med},
                 _cuvette(work, "sq_outer.ply", "sq_inner.ply",
                          medium=med, ior=1.54)):
        cfg = _config(work, vial, n_patterns=16, resx=32, resy=8,
                      pixel_size=0.25, film=(32, 32, 8), **kw)
        cfg["sensor"].update(scalex=7.0, scaley=7.0, scalez=1.5)
        out.append(TScene(cfg))
    return out


def test_mesh_cuvette_equals_analytic_square_vial(work):
    """Two intersections of one geometry: the mesh vial through the mesh
    branch, the analytic vial through ray_box; the same lanes, seed and
    patterns."""
    doses = []
    for sc in _square_pair(work):
        static, arr = sc.build(mode="volume", include_target=False,
                               max_depth=8, rr_depth=8)
        data = torch.from_numpy(_inputs(static, 11)[0])
        doses.append(tr.render(static, scene_tensors(arr, "cpu"), data, 1.0,
                               seed=2, spp=2).numpy())
    square, mesh = doses
    assert square.sum() > 0
    np.testing.assert_allclose(mesh.sum(dtype=np.float64),
                               square.sum(dtype=np.float64), rtol=1e-5)
    off = np.abs(mesh - square) > 1e-3 * np.abs(square).max()
    assert off.mean() <= 0.01, off.mean()


def test_mesh_vial_tile_rows_equal_the_analytic_vial(work):
    """The home-slice tile of the mesh vial (its inner wall's triangles
    within each film row) against the analytic square vial's: the same
    rows meet the medium, and each keeps the same columns within one; the
    tile's voxel count within one a row. Without the mesh layout the
    mesh wall was read as a box of half-widths 0 (surf_params (0, 0, 0)):
    a tile of 3 columns a row about x = 0."""
    rows = []
    for sc in _square_pair(work):
        static, arr = sc.build(mode="volume", include_target=False)
        rows.append(tr.tile_rows(static, scene_tensors(arr, "cpu")))
    (r_sq, n_sq), (r_mesh, n_mesh) = rows
    assert int((r_sq[:, 1] > 0).sum()) == int((r_mesh[:, 1] > 0).sum()) > 0
    assert int((r_sq[:, :2] - r_mesh[:, :2]).abs().max()) <= 1
    assert abs(n_sq - n_mesh) <= r_sq.shape[0]
    assert int(r_mesh[:, 1].max()) > 3 * 8


@pytest.mark.parametrize("engine", ["ballistic", "hybrid"])
def test_forced_engines_raise_on_mesh_scenes(engine, work, tmp_path):
    for albedo in (0.0, 0.5):
        cfg = _config(work, _cuvette(work, medium={"albedo": albedo}))
        static, _ = TScene(cfg).build()
        assert select_engine("auto", static) == "wavefront"
        cfg.update(engine=engine, n_steps=1, spp=1, spp_ref=1,
                   output=str(tmp_path / f"out{albedo}"))
        with pytest.raises(ValueError, match=f"engine '{engine}' needs"):
            toptimize(cfg, device="cpu")
        with pytest.raises(AssertionError, match="eligible"):
            joptimize(cfg)


# --------------------------------------------------------------------------
# both CLIs


def _files(root):
    return sorted(os.path.relpath(os.path.join(dr, f), root)
                  for dr, _, fs in os.walk(root) for f in fs)


CLI_CASES = {
    # test_smoke_occlusion's config, filter_radon on (the radon render:
    # a square vial with an occlusion is not transport-eligible)
    "occlusion_filter_radon": lambda w: (
        {"type": "square", "w_int": 7.191, "w_ext": 7.6, "ior": 1.3,
         "medium": MEDIUM, "occlusions": [{"filename": str(w / "occ.ply")}]},
        {"filter_radon": True, "spp_filter_radon": 2,
         "loss": {"type": "threshold", "tl": 0.9, "tu": 0.97}}, None),
    # test_smoke_custom_cuvette_telecentric's config
    "custom_cuvette_telecentric": lambda w: (
        _cuvette(w), {"loss": {"type": "threshold", "tl": 0.9,
                               "tu": 0.97}},
        {"type": "telecentric", "focus_distance": 20,
         "aperture_radius": 0.01}),
}


@pytest.mark.parametrize("case", list(CLI_CASES))
def test_clis_agree(case, work, tmp_path, monkeypatch):
    """tests/test_e2e_scenes.py's smoke configs cut to 3 steps (progressive:
    depth 3 throughout) at spp 1 on both CLIs."""
    vial, extra, proj = CLI_CASES[case](work)
    kept = {}
    for name, mod in (("jax", jprojector), ("torch", tprojector)):
        orig = mod.Projector.set_active

        def record(self, pixels, data, orig=orig, name=name):
            kept[name] = np.asarray(pixels).copy()
            return orig(self, pixels, data)
        monkeypatch.setattr(mod.Projector, "set_active", record)
    paths = {}
    for name in ("jax", "torch"):
        cfg = smoke_config(str(work / "box_hole.ply"), str(tmp_path / name),
                           vial, **extra)
        cfg["projector"].update(n_patterns=24)
        cfg["sensor"]["film"].update(resx=32, resy=32, resz=12)
        if proj is not None:
            cfg["projector"].update(proj)
        cfg.update(n_steps=3, spp=1, spp_ref=1)
        paths[name] = tmp_path / f"{name}.json"
        paths[name].write_text(json.dumps(cfg))
    jmain([str(paths["jax"]), "--backend", "cpu"])
    tmain([str(paths["torch"]), "--device", "cpu"])
    j, t = tmp_path / "jax", tmp_path / "torch"
    assert _files(t) == _files(j)
    lj, lt = np.load(j / "loss.npy"), np.load(t / "loss.npy")
    steps = [int(np.count_nonzero(np.load(d / "timing.npy").sum(1)))
             for d in (j, t)]
    assert steps[0] == steps[1] > 0
    np.testing.assert_allclose(lt, lj, rtol=1e-4)
    if "filter_radon" in case:
        n_dense = 24 * 10 * 48
        assert 0 < kept["torch"].size < n_dense
        np.testing.assert_array_equal(kept["torch"], kept["jax"])


# --------------------------------------------------------------------------
# both drivers on a cut of chip_smoke.py's cell (d)


class _BanksFit:
    """Stands in for the card's csrc/wf_target.cu library in
    ops/render.py tgt_route: the scene's mesh banks fit a CTA."""

    @staticmethod
    def wf_tgt_fits(P, M, fits):
        fits._obj.value = 1
        return 0


def test_scattering_cuvette_cell_matches_jax(work, tmp_path):
    """chip_smoke.py's cell (d) cut to 8 angles of 32x8 pixels, a 32^3
    film and 2 steps: the square bench vial's walls as a mesh cuvette,
    the occlusion box, a scattering resin (albedo 0.5, depths 6), the
    delta sensor, filter_radon. auto picks the wavefront (a mesh vial is
    never hybrid-eligible) and the forward takes the target forms' route
    (ops/render.py tgt_route: the delta form where the banks fit); both
    drivers give the same loss history and final dose, to the delta
    tolerance (1e-4 of the max with at most 0.2 % of the nonzero values
    off, totals to 2e-3; the loss history 1e-4, as the CLIs')."""
    vial = _cuvette(work, "sq_outer.ply", "sq_inner.ply", ior=1.54,
                    medium={"albedo": 0.5, "extinction": 0.1},
                    occlusions=[{"filename": str(work / "occ.ply")}])
    cfg = _config(work, vial, estimator="delta", n_patterns=8, resx=32,
                  resy=8, pixel_size=0.25, film=(32, 32, 32))
    cfg["sensor"].update(scalex=7.0, scaley=7.0, scalez=2.0)
    cfg.update(filter_radon=True, spp_filter_radon=2, n_steps=2, spp=1,
               spp_ref=8, max_depth=6, rr_depth=6,
               loss={"type": "threshold", "tl": 0.9, "tu": 0.97})
    static, arr = TScene(cfg).build(mode="volume", include_target=False,
                                    max_depth=6, rr_depth=6)
    assert select_engine("auto", static) == "wavefront"
    at = scene_tensors(arr, "cpu")
    assert tr.target_mode(static) == 1
    assert tr.tgt_route({tr.TGT_LIB: _BanksFit}, "wf_fwd", static, at)
    vols = {}
    for name, run in (("jax", lambda c: joptimize(c)),
                      ("torch", lambda c: toptimize(c, device="cpu"))):
        c = dict(cfg, output=str(tmp_path / name))
        vols[name] = np.asarray(run(c))
    lj, lt = (np.load(tmp_path / n / "loss.npy") for n in ("jax", "torch"))
    assert lj.shape == lt.shape and np.count_nonzero(lj) > 0
    np.testing.assert_allclose(lt, lj, rtol=1e-4)
    _within(vols["torch"], vols["jax"], True)
