"""The first-scatter residual without a chord bank (the geometric
prologue, drtvam_tpu/ops/march.py:198-325; the port's plain version
ops/march.py `_first_scatter_prologue`) against the JAX package, on the
CPU, on tests/test_hybrid.py's scattering scene (16 angles, 24x8 DMD,
32x32x16 film, albedo 0.5), a surface-aware square vial keeping its
target, and a mesh cuvette, with numpy-seeded patterns. The JAX march is
plain XLA: no interpret mode.

Tolerances, with their reasons:
  * the prologue's segments (origin, direction, length, amplitude, the
    slots written) on the same rays: 2e-6 of each array's largest
    |value| (the same float32 march; XLA's and torch's sqrt and
    divisions agree, their ray-surface roots an ulp apart);
  * the residual's dose and pattern gradient at the same seed, dda and
    delta (the fast event loop and the general one): the dose to 1e-4
    of the largest |value|, up to 0.2 % of the nonzero voxels off by
    more (a delta deposit is a point; and each package's prologue gives
    its own first scatter, the two an ulp apart, which moves a path's
    later deposits, dda's too: measured 2 of the dda's ~16,000 voxels at
    1.4e-4), the pattern gradient to 1e-4 of its largest |value|, for
    delta with the dose's share of points (measured for the dda: 10 of
    3,072 pixels beyond rtol 1e-5, at most 1.2e-5 of the largest);
  * ratio tracking: each lane has its own random stream in the port
    (ROADMAP queue 3), so the means over 8 seeds agree within 5
    standard errors;
  * a two-channel film keeping the target: 1e-4 of each channel's max;
  * the prologue's dose against the chord bank's on the same scene: the
    dda totals to rtol 1e-3 (the bank takes the chord at the pixel's
    centre column, the prologue at the lane's own jittered position; the
    same expectation), delta's over 8 seeds within 5 standard errors.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import drtvam_tpu.ops.march as jmarch
from drtvam_tpu.models.scene import Scene as JScene
from drtvam_tpu.ops.hybrid import ScatteringEngine as JEngine
from drtvam_tpu.ops.mesh import make_box, make_box_tube, \
    make_box_with_hole, save_ply
from drtvam_tpu.ops.render import _adjoint as j_adjoint
from drtvam_tpu.ops.render import render as j_render
import drtvam_tpu_torch.ops.march as tmarch
from drtvam_tpu_torch.convert import scene_from_jax
from drtvam_tpu_torch.core.rng import Sampler
from drtvam_tpu_torch.models.projector import sample_rays
from drtvam_tpu_torch.ops import render as tr
from drtvam_tpu_torch.ops.hybrid import ScatteringEngine
from drtvam_tpu_torch.ops.march import scene_tensors
from torch_threads import one_torch_thread  # noqa: F401
from torch_jax_native import jax_native_libraries  # noqa: F401

TOL = 1e-4
POINT_SHARE = 2e-3
CHUNK = 1 << 15
SEED, SPP = 3, 2
MED = {"ior": 1.40, "phase": {"type": "rayleigh"}, "extinction": 0.1,
       "albedo": 0.5}
VIALS = {
    "cylindrical": {"type": "cylindrical", "r_int": 7, "r_ext": 8,
                    "ior": 1.54, "medium": MED},
    "square": {"type": "square", "w_int": 12.0, "w_ext": 14.0, "ior": 1.24,
               "medium": MED},
    "double_cylindrical": {
        "type": "double_cylindrical", "r_ext_outer": 8.0,
        "r_int_outer": 7.6, "r_ext_inner": 3.0, "r_int_inner": 2.6,
        "ior_outer": 1.54, "ior_inner": 1.52, "ior_inside_inner": 1.40,
        "medium": MED},
}


@pytest.fixture(scope="module")
def work(tmp_path_factory):
    path = tmp_path_factory.mktemp("prologue")
    save_ply(make_box_with_hole((2.0, 2.0, 0.5), 1.0,
                                hole_center_xy=(-1.0, 0.0), segments=49),
             str(path / "box_hole.ply"))
    save_ply(make_box_tube(3.765, 3.71, -5.0, 5.0),
             str(path / "cuv_outer.ply"))
    save_ply(make_box_tube(2.5, 2.41, -5.0, 5.0), str(path / "cuv_inner.ply"))
    save_ply(make_box((1.0, 0.5, 0.25)), str(path / "occ.ply"))
    return path


def _config(work, vial, surface_aware=False, estimator="dda"):
    film = {"type": "vfilm", "resx": 32, "resy": 32, "resz": 16}
    sensor = {"type": estimator, "scalex": 5, "scaley": 5, "scalez": 1.25,
              "majorant": 1.0}
    cfg = {"vial": vial,
           "projector": {"type": "collimated", "n_patterns": 16,
                         "resx": 24, "resy": 8, "pixel_size": 5.0 / 24,
                         "motion": "circular", "distance": 20},
           "sensor": dict(sensor, film=dict(film,
                                            surface_aware=surface_aware)),
           "target": {"filename": str(work / "box_hole.ply"), "size": 4.0},
           "output": str(work)}
    if surface_aware:
        cfg["final_sensor"] = dict(sensor, film=film)
    return cfg


def _cuvette(work):
    return {"type": "custom",
            "filename_vial_outer": str(work / "cuv_outer.ply"),
            "filename_vial_inner": str(work / "cuv_inner.ply"),
            "ior": 1.4702, "occlusions": [{"filename": str(work / "occ.ply"),
                                           "bsdf": {"type": "null"}}],
            "medium": MED}


def _engines(work, vial, estimator, fast=True, surface_aware=False):
    """The residual of both packages' hybrid engines on vial's scene,
    their arrays without the chord bank: (JAX static, JAX arrays, port
    static, port tensors, data, dL)."""
    sc = JScene(_config(work, VIALS[vial], surface_aware))
    static, arr = sc.build(mode="volume", include_target=surface_aware,
                           max_depth=6, rr_depth=3)
    mask = None
    if surface_aware:
        mask = np.asarray(sc.sensor.discretize(sc.target_bank()))
    je = JEngine(static, arr, spp=SPP, chunk=CHUNK, estimator=estimator,
                 inside_mask=mask)
    ts, ta = scene_from_jax(static, arr)
    te = ScatteringEngine(ts, ta, "cpu", spp=SPP, estimator=estimator,
                          inside_mask=mask)
    jst = dataclasses.replace(je.static_s, fast_residual=fast and
                              je.static_s.fast_residual)
    tst = dataclasses.replace(te.static_s, fast_residual=jst.fast_residual)
    assert tst.first_scatter and jst.first_scatter
    jarr = {k: v for k, v in je._arr.items() if k != "chord_pack"}
    tarr = {k: v for k, v in te.arr.items() if k != "chord_pack"}
    return jst, jarr, tst, tarr, te.arr, _inputs(tst)


def _mesh_residual(work, estimator):
    """A scattering custom cuvette with a null occlusion, its static made
    a first-scatter residual (a scene no chord bank serves): (JAX static,
    JAX arrays, port static, port tensors, data, dL)."""
    sc = JScene(_config(work, _cuvette(work), estimator=estimator))
    static, arr = sc.build(mode="volume", include_target=False,
                           max_depth=6, rr_depth=3)
    jst = dataclasses.replace(static, scattered_only=True,
                              first_scatter=True)
    ts, ta = scene_from_jax(jst, arr)
    return jst, arr, ts, scene_tensors(ta, "cpu"), None, _inputs(ts)


def _inputs(static):
    rng = np.random.default_rng(0)
    data = rng.uniform(0.2, 1.0, static.projector.n_active) \
        .astype(np.float32)
    dL = rng.uniform(0.0, 1.0, static.sensor.n_cells).astype(np.float32)
    return data, dL


def _jax_pair(jst, jarr, data, dL, seed=SEED):
    vj = np.asarray(jax.jit(lambda d: j_render(
        jst, jarr, d, 1.0, seed=seed, spp=SPP, chunk=CHUNK))(
            jnp.asarray(data)))
    gj = np.asarray(jax.jit(lambda dl: j_adjoint(
        jst, jarr, jnp.uint32(seed), SPP, CHUNK, dl)[0])(jnp.asarray(dL)))
    return vj, gj


def _port_pair(tst, tarr, data, dL, seed=SEED, stats=None):
    vt = tr.render(tst, tarr, torch.from_numpy(data), 1.0, seed=seed,
                   spp=SPP).numpy()
    gt = tr._adjoint(tst, tarr, seed, SPP, tr.DEFAULT_CHUNK,
                     torch.from_numpy(dL), stats).numpy()
    return vt, gt


def _within(port, ref, tol, point):
    assert port.shape == ref.shape and np.isfinite(port).all()
    for c in range(ref.shape[-1] if ref.ndim == 4 else 1):
        p, r = (port[..., c], ref[..., c]) if ref.ndim == 4 else (port, ref)
        scale = float(np.abs(r).max())
        assert scale > 0.0
        off = int((np.abs(p - r) > tol * scale).sum())
        allowed = POINT_SHARE * np.count_nonzero(r) if point else 0
        assert off <= allowed, (c, off, float(np.abs(p - r).max()) / scale)


def _captured(monkeypatch, module):
    """Replace module's _sample_first_scatter by one that returns the
    prologue's segments."""
    def capture(static, arr, sg_o, sg_d, sg_L, sg_amp, *rest):
        return sg_o, sg_d, sg_L, sg_amp
    monkeypatch.setattr(module, "_sample_first_scatter", capture)


@pytest.mark.parametrize("vial", ["cylindrical", "square",
                                  "double_cylindrical", "custom"])
def test_prologue_segments_match_jax(vial, work, monkeypatch):
    """The segments of every lane of the scene at spp 2 (two in the
    double-cylindrical vial's medium, a null occlusion extending one in
    the cuvette): both packages march the same rays."""
    if vial == "custom":
        jst, jarr, tst, tarr, _, _ = _mesh_residual(work, "dda")
    else:
        jst, jarr, tst, tarr, *_ = _engines(work, vial, "dda")
    n = tst.projector.n_active * SPP
    lane = torch.arange(n, dtype=torch.int64)
    sampler = Sampler(SEED)
    o, d, _, _ = sample_rays(tst.projector, tarr, tarr["active_pixels"],
                             lane, SPP, sampler, sampler.init(n),
                             tst.regular_sampling, tst.sample_time,
                             tst.clockwise)
    _captured(monkeypatch, tmarch)
    _captured(monkeypatch, jmarch)
    stats = {}
    tseg = tmarch._first_scatter_prologue(tst, tarr, o, d, None, None, None,
                                          stats)
    ja = {k: jnp.asarray(v) for k, v in jarr.items()}
    jseg = jmarch._first_scatter_prologue(jst, ja, jnp.asarray(o.numpy()),
                                          jnp.asarray(d.numpy()), None, None,
                                          None)
    for t, j in zip(tseg, jseg):
        t, j = t.numpy(), np.asarray(j)
        assert t.shape == j.shape and t.dtype == np.float32
        scale = float(np.abs(j).max())
        np.testing.assert_allclose(t, j, rtol=0, atol=2e-6 * scale)
    written = (tseg[2].numpy() > 0).sum(1)
    np.testing.assert_array_equal(written, (np.asarray(jseg[2]) > 0).sum(1))
    # lanes with a chord; the double vial's medium meets most rays twice
    assert (written > 0).mean() > 0.3
    if vial == "double_cylindrical":
        assert (written == 2).sum() > 0
    assert stats["prologue_iters"] >= n


@pytest.mark.parametrize("estimator,fast", [("dda", False), ("delta", True),
                                           ("delta", False)])
def test_prologue_residual_matches_jax(estimator, fast, work):
    """The residual's dose and pattern gradient at the same seed, the
    first scatter from each package's prologue; delta through the fast
    event loop and the general one."""
    jst, jarr, tst, tarr, _, (data, dL) = _engines(
        work, "cylindrical", estimator, fast)
    assert tst.fast_residual == fast
    vj, gj = _jax_pair(jst, jarr, data, dL)
    stats = {}
    vt, gt = _port_pair(tst, tarr, data, dL, stats=stats)
    # the dda's voxels too: the two prologues' first scatters an ulp
    # apart move a path's later deposits by as much
    _within(vt, vj, TOL, True)
    _within(gt, gj, TOL, estimator == "delta")
    assert stats["prologue_iters"] > 0 and stats["steps"] > 0


def _block_sums(vol):
    z, y, x = vol.shape[:3]
    return vol[..., 0].reshape(2, z // 2, 2, y // 2, 2, x // 2) \
        .sum((1, 3, 5)).ravel()


def test_prologue_ratio_matches_statistically(work):
    jst, jarr, tst, tarr, _, (data, dL) = _engines(work, "cylindrical",
                                                   "ratio")
    A = tst.projector.n_patterns
    fj = jax.jit(lambda d, s: j_render(jst, jarr, d, 1.0, seed=s, spp=SPP,
                                       chunk=CHUNK))
    gjf = jax.jit(lambda dl, s: j_adjoint(jst, jarr, s, SPP, CHUNK, dl)[0])
    stats = {"jax": [], "port": []}
    for seed in range(8):
        vj = np.asarray(fj(jnp.asarray(data), jnp.uint32(seed)))
        gj = np.asarray(gjf(jnp.asarray(dL), jnp.uint32(seed)))
        vt, gt = _port_pair(tst, tarr, data, dL, seed)
        for key, v, g in (("jax", vj, gj), ("port", vt, gt)):
            stats[key].append(np.concatenate([
                [v.sum()], _block_sums(v), [g.sum()],
                g.reshape(A, -1).sum(1)]))
    j, t = np.asarray(stats["jax"]), np.asarray(stats["port"])
    se = np.sqrt(j.var(0, ddof=1) / len(j) + t.var(0, ddof=1) / len(t))
    assert se[0] > 0 and se[9] > 0
    diff = np.abs(t.mean(0) - j.mean(0))
    # a block the residual never reaches holds 0 in both
    assert (diff <= 5.0 * se + 1e-12).all(), diff / np.maximum(se, 1e-30)


@pytest.mark.parametrize("estimator,fast", [("delta", True), ("dda", False)])
def test_prologue_two_channel_film_matches_jax(estimator, fast, work):
    """A surface-aware film: the target mesh kept in the residual's scene
    (its crossings extend a segment in the prologue) and each lane's
    channel seeded from the inside mask at its first scatter; per
    channel."""
    jst, jarr, tst, tarr, _, (data, _) = _engines(
        work, "square", estimator, fast, surface_aware=True)
    assert tst.sensor.channels == 2 and "inside_mask" in tarr
    dL = np.random.default_rng(1).uniform(
        0.0, 1.0, tst.sensor.n_cells).astype(np.float32)
    vj, gj = _jax_pair(jst, jarr, data, dL)
    vt, gt = _port_pair(tst, tarr, data, dL)
    shape = tuple(tst.sensor.res[::-1]) + (2,)
    point = estimator == "delta"
    _within(vt.reshape(shape), vj.reshape(shape), TOL, point)
    _within(gt, gj, TOL, point)
    assert (vt.reshape(-1, 2).sum(0) > 0).all()


@pytest.mark.parametrize("estimator", ["dda", "delta"])
def test_prologue_on_a_mesh_cuvette_matches_jax(estimator, work):
    """A custom cuvette with a null occlusion: the prologue crosses the
    mesh walls and extends its segment through the occlusion."""
    jst, jarr, tst, tarr, _, (data, dL) = _mesh_residual(work, estimator)
    vj, gj = _jax_pair(jst, jarr, data, dL)
    vt, gt = _port_pair(tst, tarr, data, dL)
    point = estimator == "delta"
    _within(vt, vj, TOL, point)
    _within(gt, gj, TOL, point)


def test_prologue_dose_equals_the_bank_dose(work):
    """On a collimated scene of an analytic vial the prologue and the
    chord bank sample the same chords, the bank at the pixel's centre
    column, the prologue at the lane's own position, with the same
    draws: the dda totals agree, and the two are not the same
    realization."""
    _, _, tst, tarr, bank_arr, (data, _) = _engines(work, "cylindrical",
                                                    "dda")
    p = torch.from_numpy(data)
    prologue = tr.render(tst, tarr, p, 1.0, seed=SEED, spp=8)
    bank = tr.render(tst, bank_arr, p, 1.0, seed=SEED, spp=8)
    np.testing.assert_allclose(float(prologue.sum()), float(bank.sum()),
                               rtol=1e-3)
    assert not torch.equal(prologue, bank)


def test_prologue_delta_dose_equals_the_bank_dose_statistically(work):
    """The delta residual's events are points, and a first scatter moved
    within its pixel changes which of them fall inside the vial, so the
    two totals differ by their noise (measured 0.1-0.2 % at spp 8): over
    8 seeds their means agree within 5 standard errors."""
    _, _, tst, tarr, bank_arr, (data, _) = _engines(work, "cylindrical",
                                                    "delta")
    p = torch.from_numpy(data)
    tot = np.asarray([[float(tr.render(tst, a, p, 1.0, seed=s, spp=8).sum())
                       for a in (tarr, bank_arr)] for s in range(8)])
    se = np.sqrt(tot.var(0, ddof=1).sum() / len(tot))
    assert se > 0 and abs(tot[:, 0].mean() - tot[:, 1].mean()) <= 5 * se
