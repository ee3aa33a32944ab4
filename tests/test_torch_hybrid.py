"""The port's hybrid scattering engine (ops/hybrid.py: the unscattered
transport plus the first-scatter residual) against the JAX package's
(drtvam_tpu/ops/hybrid.py), on the CPU, on tests/test_hybrid.py's
scattering scene (16 angles, 24x8 DMD, 32x32x16 film, albedo 0.5) with
numpy-seeded patterns.

Tolerances, with their reasons:
  * the chord bank: 1e-6 of each array's largest |value| (measured 3e-7:
    the same float32 trace, XLA's and torch's sin / cos an ulp apart);
    `chord_pack`'s layout exactly;
  * the unscattered fields: bitwise (the same host C++);
  * the engine's dose and pattern gradient at the same seed, dda and
    delta, against the JAX engine: 1e-4 of the largest |value|, the
    wavefront's same-seed tolerance (tests/test_torch_wavefront.py).
    A delta or analog deposit is a point: an event an ulp off can land
    in the next voxel, so there up to 0.2 % of the nonzero values may be
    off by more (measured: none for the first-scatter residual; 2 of
    16,194 voxels for the analog scattered-only dda residual);
  * ratio tracking: each lane has its own random stream in the port,
    the JAX package's depend on the chunk (ROADMAP queue 3), so the
    means over 8 seeds agree within 5 standard errors (a film block the
    residual never reaches: to the unscattered part's 1e-5);
  * the fast event loop against the general first-scatter loop of the
    port: bitwise, as the JAX package's own test holds its pair (the
    same draws in the same order);
  * the explicit adjoint against autograd: rtol 1e-5, atol 1e-6 of the
    max (tests/test_hybrid.py's);
  * both CLIs on a small scattering config (auto runs the hybrid
    engine): the loss history to 1e-4 (measured 2.1e-5) and the same
    artifact set.
"""
import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from drtvam_tpu.models.scene import Scene as JScene
from drtvam_tpu.ops.ballistic import BallisticEngine as JBallistic
from drtvam_tpu.ops.hybrid import ScatteringEngine as JEngine
from drtvam_tpu.ops.hybrid import hybrid_eligible as j_hybrid_eligible
from drtvam_tpu.ops.mesh import make_box_with_hole, save_ply
from drtvam_tpu.ops.transport2d import build_chords as j_build_chords
from drtvam_tpu.ops.transport2d import strip_target as j_strip_target
from drtvam_tpu.opt.optimize import main as jmain
from drtvam_tpu_torch.convert import scene_from_jax
from drtvam_tpu_torch.ops import render as tr
from drtvam_tpu_torch.ops.ballistic import BallisticEngine
from drtvam_tpu_torch.ops.hybrid import ScatteringEngine, hybrid_eligible
from drtvam_tpu_torch.ops.march import scene_tensors
from drtvam_tpu_torch.ops.transport2d import build_chords, chord_pack, \
    strip_target
from drtvam_tpu_torch.opt.optimize import main as tmain
from drtvam_tpu_torch.opt.optimize import select_engine
from torch_threads import one_torch_thread  # noqa: F401
from torch_jax_native import jax_native_libraries  # noqa: F401

SAME_SEED_TOL = 1e-4
POINT_SHARE = 2e-3
CHUNK = 1 << 15


def _config(mesh_path, vial="cylindrical", albedo=0.5, projector=None):
    med = {"ior": 1.40, "phase": {"type": "rayleigh"}, "extinction": 0.1,
           "albedo": albedo}
    vials = {
        "cylindrical": {"type": "cylindrical", "r_int": 7, "r_ext": 8,
                        "ior": 1.54, "medium": med},
        "square": {"type": "square", "w_int": 12.0, "w_ext": 14.0,
                   "ior": 1.24, "medium": med},
        "index_matched": {"type": "index_matched", "r": 7.0,
                          "medium": med},
        "double_cylindrical": {
            "type": "double_cylindrical", "r_ext_outer": 8.0,
            "r_int_outer": 7.6, "r_ext_inner": 3.0, "r_int_inner": 2.6,
            "ior_outer": 1.54, "ior_inner": 1.52,
            "ior_inside_inner": 1.40, "medium": med}}
    return {
        "vial": vials[vial],
        "projector": projector or {
            "type": "collimated", "n_patterns": 16, "resx": 24, "resy": 8,
            "pixel_size": 5.0 / 24, "motion": "circular", "distance": 20},
        "sensor": {"type": "dda", "scalex": 5, "scaley": 5, "scalez": 1.25,
                   "film": {"type": "vfilm", "resx": 32, "resy": 32,
                            "resz": 16}},
        "target": {"filename": mesh_path, "size": 4.0},
        "output": os.path.dirname(mesh_path)}


@pytest.fixture(scope="module")
def mesh_path(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("hy") / "box_hole.ply")
    save_ply(make_box_with_hole((2.0, 2.0, 0.5), 1.0,
                                hole_center_xy=(-1.0, 0.0), segments=49),
             path)
    return path


@pytest.fixture(scope="module")
def scat_scene(mesh_path):
    """tests/test_hybrid.py's scene: (JAX static, arr, inv_vol, the
    port's static and arr, data, dvol)."""
    sc = JScene(_config(mesh_path))
    static, arr = sc.build(mode="volume", include_target=False,
                           max_depth=6, rr_depth=6)
    inv_vol = float(np.float32(1.0 / sc.sensor.voxel_volume))
    ts, ta = scene_from_jax(static, arr)
    n = sc.projector.active_size()
    data = np.random.default_rng(0).uniform(0.2, 1.0, n).astype(np.float32)
    dvol = np.random.default_rng(1).uniform(
        0.0, 1.0, static.sensor.shape).astype(np.float32)
    return static, arr, inv_vol, ts, ta, data, dvol


def _scale_close(port, ref, tol, point=False):
    scale = float(np.abs(ref).max())
    assert scale > 0.0 and np.isfinite(port).all()
    off = int((np.abs(port - ref) > tol * scale).sum())
    allowed = POINT_SHARE * np.count_nonzero(ref) if point else 0
    assert off <= allowed, (off, float(np.abs(port - ref).max()) / scale)


def test_chord_bank_matches_jax(scat_scene):
    static, arr, _, ts, ta, *_ = scat_scene
    st2, arr2 = j_strip_target(static, arr)
    jb = [np.asarray(b) for b in
          jax.jit(j_build_chords, static_argnums=(0, 2))(st2, arr2)]
    ts2, ta2 = strip_target(ts, ta)
    tb = [b.numpy() for b in build_chords(ts2, scene_tensors(ta2, "cpu"))]
    for t, j in zip(tb, jb):
        assert t.shape == j.shape and t.dtype == np.float32
        _scale_close(t, j, 1e-6)
    # the packed record: the JAX engine's layout, exactly
    jeng = JEngine(static, arr, spp=1, chunk=CHUNK)
    np.testing.assert_array_equal(
        chord_pack(*(torch.tensor(b) for b in jb)).numpy(),
        np.asarray(jeng._arr["chord_pack"]))
    teng = ScatteringEngine(ts, ta, "cpu", spp=1)
    np.testing.assert_array_equal(
        teng.arr["chord_pack"].numpy(),
        chord_pack(*(torch.tensor(b) for b in tb)).numpy())


def test_unscattered_fields_match_jax_bitwise(scat_scene):
    static, arr, _, ts, ta, *_ = scat_scene
    je = JBallistic(static, arr, impl="xla", unscattered=True)
    te = BallisticEngine(ts, ta, "cpu", unscattered=True)
    np.testing.assert_array_equal(te.W_host, np.asarray(je.W))
    np.testing.assert_array_equal(te.U_host, np.asarray(je.Umap))
    with pytest.raises(ValueError, match="ballistic-eligible"):
        BallisticEngine(ts, ta, "cpu")


def _engines(scat_scene, estimator, first_scatter=True, spp=2):
    static, arr, inv_vol, ts, ta, *_ = scat_scene
    je = JEngine(static, arr, spp=spp, chunk=CHUNK, estimator=estimator,
                 first_scatter=first_scatter)
    te = ScatteringEngine(ts, ta, "cpu", spp=spp, estimator=estimator,
                          first_scatter=first_scatter)
    assert te.static_s.fast_residual == je.static_s.fast_residual
    return je, te


def _jax_pair(je, inv_vol, data, dvol, seed):
    ep = je.params()
    vol = jax.jit(lambda d, p: je.render_vol(d, inv_vol, seed=seed,
                                             params=p))(jnp.asarray(data), ep)
    grad = jax.jit(lambda v, p: je.pattern_grad(v, inv_vol, seed=seed,
                                                params=p))(jnp.asarray(dvol),
                                                           ep)
    return np.asarray(vol), np.asarray(grad)


@pytest.mark.parametrize("estimator,first_scatter", [
    ("dda", True), ("delta", True), ("dda", False), ("delta", False)])
def test_engine_matches_jax_at_the_same_seed(scat_scene, estimator,
                                             first_scatter):
    """render_vol and pattern_grad: the first-scatter residual (delta
    through the fast event loop) and the analog scattered-only one."""
    _, _, inv_vol, _, _, data, dvol = scat_scene
    je, te = _engines(scat_scene, estimator, first_scatter)
    vj, gj = _jax_pair(je, inv_vol, data, dvol, 3)
    vt = te.render_vol(torch.from_numpy(data), inv_vol, 3).numpy()
    gt = te.pattern_grad(torch.from_numpy(dvol), inv_vol, 3).numpy()
    assert vt.shape == vj.shape and gt.shape == gj.shape
    point = estimator == "delta" or not first_scatter
    _scale_close(vt, vj, SAME_SEED_TOL, point)
    _scale_close(gt, gj, SAME_SEED_TOL, point)
    np.testing.assert_allclose(vt.sum(dtype=np.float64),
                               vj.sum(dtype=np.float64), rtol=2e-3)


def _block_sums(vol):
    z, y, x = vol.shape[:3]
    return vol[..., 0].reshape(2, z // 2, 2, y // 2, 2, x // 2) \
        .sum((1, 3, 5)).ravel()


def test_ratio_engine_matches_statistically(scat_scene):
    static, _, inv_vol, _, _, data, dvol = scat_scene
    je, te = _engines(scat_scene, "ratio")
    ep = je.params()
    fj = jax.jit(lambda d, p, s: je.render_vol(d, inv_vol, seed=s,
                                               params=p))
    gjf = jax.jit(lambda v, p, s: je.pattern_grad(v, inv_vol, seed=s,
                                                  params=p))
    A = static.projector.n_patterns
    stats = {"jax": [], "port": []}
    for seed in range(8):
        vj = np.asarray(fj(jnp.asarray(data), ep, jnp.uint32(seed)))
        gj = np.asarray(gjf(jnp.asarray(dvol), ep, jnp.uint32(seed)))
        vt = te.render_vol(torch.from_numpy(data), inv_vol, seed).numpy()
        gt = te.pattern_grad(torch.from_numpy(dvol), inv_vol, seed).numpy()
        for key, v, g in (("jax", vj, gj), ("port", vt, gt)):
            stats[key].append(np.concatenate([
                [v.sum()], _block_sums(v), [g.sum()],
                g.reshape(A, -1).sum(1)]))
    j, t = np.asarray(stats["jax"]), np.asarray(stats["port"])
    se = np.sqrt(j.var(0, ddof=1) / len(j) + t.var(0, ddof=1) / len(t))
    assert se[0] > 0 and se[9] > 0  # the dose and gradient totals vary
    # a block the residual never reaches holds the deterministic
    # unscattered dose alone (se 0): the ballistic engine's 1e-5
    diff = np.abs(t.mean(0) - j.mean(0))
    assert (diff <= 5.0 * se + 1e-5 * np.abs(j.mean(0))).all(), diff / se


def test_fast_residual_matches_general_bitwise(scat_scene):
    """The port's fast event loop draws in its general loop's order:
    the same seed replays the same paths, render and adjoint alike."""
    _, _, inv_vol, ts, ta, data, dvol = scat_scene
    te = ScatteringEngine(ts, ta, "cpu", estimator="delta")
    st_fast = te.static_s
    assert st_fast.fast_residual and st_fast.first_scatter
    st_gen = dataclasses.replace(st_fast, fast_residual=False)
    p = torch.from_numpy(data)
    for seed in (3, 11):
        a = tr.render(st_gen, te.arr, p, inv_vol, seed=seed, spp=4)
        b = tr.render(st_fast, te.arr, p, inv_vol, seed=seed, spp=4)
        assert torch.equal(a, b)
    dL = torch.from_numpy(dvol).reshape(-1)
    ga = tr.adjoint(st_gen, te.arr, 7, 2, tr.DEFAULT_CHUNK, dL)
    gb = tr.adjoint(st_fast, te.arr, 7, 2, tr.DEFAULT_CHUNK, dL)
    assert torch.equal(ga, gb)


@pytest.mark.parametrize("estimator", ["dda", "delta", "ratio"])
def test_pattern_grad_matches_autograd(scat_scene, estimator):
    _, _, inv_vol, ts, ta, data, dvol = scat_scene
    te = ScatteringEngine(ts, ta, "cpu", spp=2, estimator=estimator)
    p = torch.from_numpy(data).requires_grad_(True)
    w = torch.from_numpy(dvol)
    (g_auto,) = torch.autograd.grad(te.render_vol(p, inv_vol, 3), p, w)
    g_expl = te.pattern_grad(w, inv_vol, 3)
    np.testing.assert_allclose(g_expl.numpy(), g_auto.numpy(), rtol=1e-5,
                               atol=1e-6 * float(g_auto.abs().max()))


def test_kernel_families_take_their_own_statics(scat_scene):
    """The residual pair's launch parameters: the residual mode, the
    fast loop's medium surface, no tile, the chord bank in place of the
    tile's row table; each pair refuses the other's static."""
    _, _, _, ts, ta, *_ = scat_scene
    te = ScatteringEngine(ts, ta, "cpu", spp=1, estimator="delta")
    P, _, _, bank = tr._family_params("wf_res_fwd", te.static_s, te.arr,
                                      0, 1)
    med = [i for i, s in enumerate(ts.surfaces) if s.medium_side == 1]
    assert (P.residual, P.res_surf, P.tile_n) == (3, med[0], 0)
    assert bank is te.arr["chord_pack"]
    with pytest.raises(ValueError, match="residual"):
        tr._family_params("wf_fwd", te.static_s, te.arr, 0, 1)
    with pytest.raises(ValueError, match="residual"):
        tr._family_params("wf_res_bwd", ts, scene_tensors(ta, "cpu"), 0, 1)


@pytest.mark.parametrize("vial", ["cylindrical", "square", "index_matched",
                                  "double_cylindrical"])
def test_engine_selection(mesh_path, vial):
    """hybrid_eligible as the JAX package's; auto runs the hybrid engine
    on a scattering scene, the ballistic one without scattering, the
    wavefront with a telecentric projector; the fast loop only where
    the medium region is one convex volume."""
    for albedo, auto in ((0.5, "hybrid"), (0.0, "ballistic")):
        sc = JScene(_config(mesh_path, vial, albedo))
        static, arr = sc.build(mode="volume", include_target=False)
        ts, ta = scene_from_jax(static, arr)
        assert hybrid_eligible(ts) == j_hybrid_eligible(static) == \
            (albedo > 0)
        assert select_engine("auto", ts) == auto
        assert select_engine("wavefront", ts) == "wavefront"
        if albedo > 0:
            assert select_engine("hybrid", ts) == "hybrid"
        else:
            with pytest.raises(ValueError, match="hybrid"):
                select_engine("hybrid", ts)
    tele = {"type": "telecentric", "n_patterns": 16, "resx": 24, "resy": 8,
            "pixel_size": 5.0 / 24, "aperture_radius": 0.05,
            "focus_distance": 20.0, "motion": "circular", "distance": 20}
    sc = JScene(_config(mesh_path, vial, 0.5, tele))
    static, arr = sc.build(mode="volume", include_target=False)
    ts, ta = scene_from_jax(static, arr)
    assert not hybrid_eligible(ts) and not j_hybrid_eligible(static)
    assert select_engine("auto", ts) == "wavefront"
    sc = JScene(_config(mesh_path, vial, 0.5))
    static, arr = sc.build(mode="volume", include_target=False)
    ts, ta = scene_from_jax(static, arr)
    je = JEngine(static, arr, spp=1, estimator="delta")
    te = ScatteringEngine(ts, ta, "cpu", spp=1, estimator="delta")
    assert te.static_s.fast_residual == je.static_s.fast_residual == \
        (vial != "double_cylindrical")


def _files(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


def test_clis_agree_on_a_scattering_scene(tmp_path):
    """The verify recipe's scene, shrunk (30 angles, 48x12 DMD, 40x40x20
    film, 3 steps, spp 2), with albedo 0.5: auto runs the hybrid engine
    in both packages, the final render at spp_ref 2."""
    save_ply(make_box_with_hole((2.0, 2.0, 0.5), 1.0,
                                hole_center_xy=(-1.0, 0.0)),
             str(tmp_path / "box_hole.ply"))

    def config(out):
        cfg = _config("box_hole.ply", projector={
            "type": "collimated", "n_patterns": 30, "resx": 48, "resy": 12,
            "pixel_size": 0.104, "motion": "circular", "distance": 20})
        cfg["sensor"]["film"] = {"type": "vfilm", "resx": 40, "resy": 40,
                                 "resz": 20}
        cfg.update(loss={"type": "threshold", "tl": 0.85, "tu": 0.95},
                   n_steps=3, spp=2, spp_ref=2, output=str(tmp_path / out))
        path = tmp_path / f"{out}.json"
        path.write_text(json.dumps(cfg))
        return str(path)

    jmain([config("jax"), "--backend", "cpu"])
    tmain([config("torch"), "--device", "cpu"])
    j, t = tmp_path / "jax", tmp_path / "torch"
    assert _files(t) == _files(j)
    lj, lt = np.load(j / "loss.npy"), np.load(t / "loss.npy")
    np.testing.assert_allclose(lt, lj, rtol=1e-4)
    assert lt[-1] < lt[0]
    fj, ft = np.load(j / "final.npy"), np.load(t / "final.npy")
    assert ft.shape == fj.shape == (20, 40, 40, 1)
    np.testing.assert_allclose(ft, fj, rtol=1e-3, atol=1e-3 * fj.max())


def test_engine_hybrid_runs_training_and_final_render(mesh_path, capsys):
    """engine 'hybrid' named in the config: the same engine as under
    auto, through optimize(), with the delta residual's fast loop in
    training and the scene's dda in the final render."""
    from drtvam_tpu_torch.opt.optimize import optimize
    cfg = _config(mesh_path)
    cfg.update(engine="hybrid", hybrid_estimator="delta", n_steps=2,
               spp=1, spp_ref=1,
               loss={"type": "threshold", "tl": 0.85, "tu": 0.95},
               output=os.path.join(os.path.dirname(mesh_path), "eh"))
    vol = optimize(cfg, device="cpu")
    assert "Hybrid engine on cpu" in capsys.readouterr().out
    assert vol.shape == (16, 32, 32, 1) and np.isfinite(vol).all()
    assert vol.max() > 0
