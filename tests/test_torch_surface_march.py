"""Surface-aware films on the port's march (ops/march.py, ops/render.py,
ops/hybrid.py: the target mesh kept in the scene, the lanes' inside
flag flipped at its crossings, deposits to two channels) against the
JAX package, on the CPU. The JAX march is plain XLA: no interpret mode.

Tolerances, with their reasons:
  * the wavefront dose and pattern gradient at the same seed, dda and
    delta, albedo 0 and 0.5, on tests/test_surface_aware.py's scene:
    1e-4 of each channel's largest |value|, the wavefront's same-seed
    tolerance (tests/test_torch_wavefront.py). A delta deposit is a
    point, and with scattering a path's phase samples (torch's sin / cos
    against XLA's, an ulp apart) move later deposits by an ulp: there up
    to 0.2 % of the nonzero values may be off by more, as
    tests/test_torch_hybrid.py allows its analog residual (measured: 1
    of 10,223 voxels at 1.1e-4 for the dda at albedo 0.5);
  * ratio tracking: each lane has its own random stream in the port
    (ROADMAP queue 3), so the means over 8 seeds agree within 5
    standard errors;
  * the surface-aware wavefront against the surface-aware ballistic
    engine under regular sampling: totals rtol 1e-3 and the voxels away
    from the target's surface per channel to rtol 1e-3, atol 1e-4 of
    the max (tests/test_surface_aware.py's contract for the JAX pair);
  * the hybrid engine with the inside mask against the JAX engine, and
    the final render with the target mesh (one channel): as the
    wavefront's same seed, both fed the JAX package's chord bank (the
    port's agrees to 1e-6, tests/test_torch_hybrid.py; a first scatter
    an ulp apart on a voxel boundary reads the mask of the next voxel);
    the fast residual against the general loop without the target: the
    adjoint bitwise (the same draws in the same order);
  * both CLIs on a shrunk copy of the bench's surface-aware cell: the
    same artifact files, target files bitwise, the same kept pixels, the
    loss history to 1e-3 (the hybrid engine, as
    tests/test_torch_surface_aware.py) or 1e-4 (the wavefront, as
    tests/test_torch_optimize.py).
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
from drtvam_tpu.ops.hybrid import ScatteringEngine as JEngine
from drtvam_tpu.ops.mesh import make_box, make_box_with_hole, save_ply
from drtvam_tpu.ops.render import _adjoint as j_adjoint
from drtvam_tpu.ops.render import render as j_render
from drtvam_tpu.opt.optimize import main as jmain
from drtvam_tpu_torch.convert import scene_from_jax
from drtvam_tpu_torch.ops import render as tr
from drtvam_tpu_torch.ops.ballistic import BallisticEngine
from drtvam_tpu_torch.ops.hybrid import ScatteringEngine
from drtvam_tpu_torch.ops.march import scene_tensors
from drtvam_tpu_torch.opt.optimize import main as tmain
from torch_threads import one_torch_thread  # noqa: F401
from torch_jax_native import jax_native_libraries  # noqa: F401

TOL = 1e-4
POINT_SHARE = 2e-3
CHUNK = 1 << 15
SEED, SPP = 3, 2


@pytest.fixture(scope="module")
def work(tmp_path_factory):
    path = tmp_path_factory.mktemp("sm")
    save_ply(make_box((1.0, 1.0, 0.4)), str(path / "box.ply"))
    save_ply(make_box_with_hole((1.0, 0.8, 2.0), 0.35,
                                hole_center_xy=(-0.4, 0.0), segments=49),
             str(path / "bench_target.ply"))
    return path


def _sa_config(work, estimator="dda", albedo=0.0, surface_aware=True):
    """tests/test_surface_aware.py's scene (an index-matched vial, 17
    angles of 30x12, a 30x30x12 film, a box target)."""
    film = {"type": "vfilm", "resx": 30, "resy": 30, "resz": 12}
    return {
        "vial": {"type": "index_matched", "r": 2.9,
                 "medium": {"ior": 1.347, "extinction": 0.03,
                            "albedo": albedo,
                            "phase": {"type": "rayleigh"}}},
        "projector": {"type": "collimated", "n_patterns": 17, "resx": 30,
                      "resy": 12, "pixel_size": 0.1631,
                      "motion": "circular", "distance": 20},
        "sensor": {"type": estimator, "scalex": 5.07, "scaley": 5.07,
                   "scalez": 1.29, "majorant": 1.0,
                   "film": dict(film, surface_aware=surface_aware)},
        "final_sensor": {"type": "dda", "scalex": 5.07, "scaley": 5.07,
                         "scalez": 1.29, "film": film},
        "target": {"filename": str(work / "box.ply"), "size": 2.0},
        "output": str(work)}


def _channels_close(port, ref, point):
    """1e-4 of each channel's max; point: up to POINT_SHARE of a
    channel's nonzero values off by more."""
    assert port.shape == ref.shape and np.isfinite(port).all()
    for c in range(ref.shape[-1]):
        p, r = port[..., c], ref[..., c]
        scale = float(np.abs(r).max())
        assert scale > 0.0
        off = int((np.abs(p - r) > TOL * scale).sum())
        allowed = POINT_SHARE * np.count_nonzero(r) if point else 0
        assert off <= allowed, (c, off, float(np.abs(p - r).max()) / scale)


def _render_both(static, arr, data, dL, seed=SEED):
    """(port dose, JAX dose, port gradient, JAX gradient), raw
    accumulators (inv_vol 1)."""
    vj = np.asarray(jax.jit(lambda d: j_render(
        static, arr, d, 1.0, seed=seed, spp=SPP, chunk=CHUNK))(
            jnp.asarray(data)))
    gj = np.asarray(jax.jit(lambda dl: j_adjoint(
        static, arr, jnp.uint32(seed), SPP, CHUNK, dl)[0])(jnp.asarray(dL)))
    ts, ta = scene_from_jax(static, arr)
    ta = scene_tensors(ta, "cpu")
    vt = tr.render(ts, ta, torch.from_numpy(data), 1.0, seed=seed,
                   spp=SPP).numpy()
    gt = tr.adjoint(ts, ta, seed, SPP, tr.DEFAULT_CHUNK,
                    torch.from_numpy(dL)).numpy()
    return vt, vj, gt, gj


def _inputs(static, n, seed=0):
    rng = np.random.default_rng(seed)
    data = rng.uniform(0.5, 1.5, n).astype(np.float32)
    dL = rng.uniform(0.0, 1.0, static.sensor.n_cells).astype(np.float32)
    return data, dL


@pytest.fixture(scope="module", params=[("dda", 0.0), ("dda", 0.5),
                                        ("delta", 0.5)])
def same_seed(request, work):
    estimator, albedo = request.param
    sc = JScene(_sa_config(work, estimator, albedo))
    static, arr = sc.build(mode="volume", include_target=True, max_depth=8,
                           rr_depth=3, transmission_only=True,
                           sample_time=True)
    assert static.sensor.channels == 2
    data, dL = _inputs(static, sc.projector.active_size())
    return (*_render_both(static, arr, data, dL), albedo > 0.0)


def test_surface_aware_dose_matches_jax(same_seed):
    vt, vj, _, _, point = same_seed
    assert vt.shape[-1] == 2
    _channels_close(vt, vj, point)
    # the crossings give the inside channel dose of its own
    assert vt[..., 0].sum() > 0 and vt[..., 1].sum() > 0
    np.testing.assert_allclose(vt.sum(dtype=np.float64),
                               vj.sum(dtype=np.float64), rtol=2e-3)


def test_surface_aware_gradient_matches_jax(same_seed):
    _, _, gt, gj, point = same_seed
    _channels_close(gt[:, None], gj[:, None], point)


def test_surface_aware_ratio_matches_statistically(work):
    sc = JScene(_sa_config(work, "ratio", 0.5))
    static, arr = sc.build(mode="volume", include_target=True, max_depth=8,
                           rr_depth=3, transmission_only=True,
                           sample_time=True)
    data, dL = _inputs(static, sc.projector.active_size(), 1)
    rows = {"jax": [], "port": []}
    for seed in range(8):
        vt, vj, gt, gj = _render_both(static, arr, data, dL, seed)
        for key, v, g in (("jax", vj, gj), ("port", vt, gt)):
            rows[key].append(np.concatenate([
                v.sum((0, 1, 2)), v[:6].sum((0, 1, 2)), [g.sum()],
                g.reshape(static.projector.n_patterns, -1).sum(1)]))
    j, t = np.asarray(rows["jax"]), np.asarray(rows["port"])
    se = np.sqrt(j.var(0, ddof=1) / len(j) + t.var(0, ddof=1) / len(t))
    assert (se > 0).all()
    assert (np.abs(t.mean(0) - j.mean(0)) <= 5.0 * se).all(), \
        np.abs(t.mean(0) - j.mean(0)) / se


def test_surface_aware_wavefront_matches_ballistic(work):
    """The port's surface-aware wavefront (the parity split at the
    crossings) against its surface-aware ballistic engine (the mask
    split), regular sampling: the totals everywhere, each channel away
    from the target's surface (tests/test_surface_aware.py:93-113)."""
    from drtvam_tpu_torch.models.scene import Scene as TScene
    sc = TScene(_sa_config(work))
    static, arr = sc.build(mode="volume", include_target=True, max_depth=10,
                           rr_depth=32, regular_sampling=True)
    data = torch.ones(sc.projector.active_size())
    vw = tr.render(static, scene_tensors(arr, "cpu"), data, 1.0, seed=0,
                   spp=1).numpy()
    mask = sc.sensor.discretize(sc.target_bank())
    vb = BallisticEngine(static, arr, "cpu", inside_mask=mask).render_vol(
        data, 1.0).numpy()
    assert vw.sum() > 0 and vw[..., 0].sum() > 0
    np.testing.assert_allclose(vb.sum(-1), vw.sum(-1), rtol=1e-3,
                               atol=1e-4 * vw.max())
    m = np.asarray(mask)[..., 0]
    interior = np.ones_like(m, bool)
    for ax in range(3):
        for sh in (1, -1):
            interior &= np.roll(m, sh, axis=ax) == m
    np.testing.assert_allclose(vb[interior], vw[interior], rtol=1e-3,
                               atol=1e-4 * vw.max())


def _square_config(work, albedo=0.5, surface_aware=True):
    """tests/test_torch_hybrid.py's scattering scene (16 angles of 24x8, a
    32x32x16 film) with a square vial and a surface-aware film."""
    med = {"ior": 1.40, "phase": {"type": "rayleigh"}, "extinction": 0.1,
           "albedo": albedo}
    film = {"type": "vfilm", "resx": 32, "resy": 32, "resz": 16}
    sensor = {"type": "dda", "scalex": 5, "scaley": 5, "scalez": 1.25}
    return {
        "vial": {"type": "square", "w_int": 12.0, "w_ext": 14.0,
                 "ior": 1.24, "medium": med},
        "projector": {"type": "collimated", "n_patterns": 16, "resx": 24,
                      "resy": 8, "pixel_size": 5.0 / 24,
                      "motion": "circular", "distance": 20},
        "sensor": dict(sensor, film=dict(film,
                                         surface_aware=surface_aware)),
        "final_sensor": dict(sensor, film=film),
        "target": {"filename": str(work / "bench_target.ply"),
                   "size": 4.0},
        "output": str(work)}


@pytest.fixture(scope="module")
def hybrid_scene(work):
    sc = JScene(_square_config(work))
    static, arr = sc.build(mode="volume", include_target=True, max_depth=6,
                           rr_depth=3)
    tb = sc.target_bank()
    mask = np.asarray(sc.sensor.discretize(tb))
    inv_vol = np.asarray(sc.sensor.inv_volume(tb))
    data = np.random.default_rng(0).uniform(
        0.2, 1.0, sc.projector.active_size()).astype(np.float32)
    dvol = np.random.default_rng(1).uniform(
        0.0, 1.0, static.sensor.shape).astype(np.float32)
    return static, arr, mask, inv_vol, data, dvol


@pytest.mark.parametrize("estimator,fast", [("delta", True),
                                           ("delta", False),
                                           ("dda", False)])
def test_hybrid_with_inside_mask_matches_jax(hybrid_scene, estimator, fast):
    """render_vol and pattern_grad of the surface-aware hybrid engine:
    the unscattered part split by the mask, the residual's channel
    seeded from the mask at the first scatter; then the fast loop reads
    it at each event, the general loop (delta, dda) flips it at the
    target's crossings."""
    static, arr, mask, inv_vol, data, dvol = hybrid_scene
    je = JEngine(static, arr, spp=SPP, chunk=CHUNK, inside_mask=mask,
                 estimator=estimator)
    ts, ta = scene_from_jax(static, arr)
    te = ScatteringEngine(ts, ta, "cpu", spp=SPP, estimator=estimator,
                          inside_mask=mask)
    assert te.static_s.fast_residual == je.static_s.fast_residual == \
        (estimator == "delta")
    # the same chord bank in both (test_torch_hybrid.py holds the two
    # banks to 1e-6): the bench's geometry puts pixel centres on voxel
    # boundaries, where a first scatter an ulp apart reads the mask of
    # the next voxel and takes the other channel for its whole path
    te.arr["chord_pack"] = torch.from_numpy(np.array(je._arr["chord_pack"]))
    je.static_s = dataclasses.replace(je.static_s, fast_residual=fast)
    te.static_s = dataclasses.replace(te.static_s, fast_residual=fast)
    ep = je.params()
    vj = np.asarray(jax.jit(lambda d, p: je.render_vol(
        d, inv_vol, seed=SEED, params=p))(jnp.asarray(data), ep))
    gj = np.asarray(jax.jit(lambda v, p: je.pattern_grad(
        v, inv_vol, seed=SEED, params=p))(jnp.asarray(dvol), ep))
    iv = torch.from_numpy(np.array(inv_vol))
    vt = te.render_vol(torch.from_numpy(data), iv, SEED).numpy()
    gt = te.pattern_grad(torch.from_numpy(dvol), iv, SEED).numpy()
    point = estimator == "delta"
    _channels_close(vt, vj, point)
    _channels_close(gt[:, None], gj[:, None], point)
    assert (vt.reshape(-1, 2).sum(0) > 0).all()


def test_hybrid_fast_residual_equals_general_with_inside_mask(hybrid_scene):
    """Without the target mesh in its static the general loop crosses no
    target, so it draws as the fast loop does and traces the same paths:
    given the same loss gradient in both channels, the adjoints are
    bitwise equal, though the fast loop takes each event's channel from
    the mask and the general loop keeps its first scatter's."""
    from drtvam_tpu_torch.ops.transport2d import strip_target
    static, arr, mask, inv_vol, data, dvol = hybrid_scene
    ts, ta = scene_from_jax(static, arr)
    te = ScatteringEngine(ts, ta, "cpu", estimator="delta",
                          inside_mask=mask)
    st_fast = te.static_s
    assert st_fast.fast_residual and st_fast.first_scatter
    st_fast, _ = strip_target(st_fast, te.arr)
    st_gen = dataclasses.replace(st_fast, fast_residual=False)
    _, at = strip_target(te.static_s, te.arr)
    dL = torch.from_numpy(dvol[..., :1]).expand(*dvol.shape).contiguous()
    for seed in (5, 7):
        ga = tr.adjoint(st_gen, at, seed, 2, tr.DEFAULT_CHUNK, dL.reshape(-1))
        gb = tr.adjoint(st_fast, at, seed, 2, tr.DEFAULT_CHUNK,
                        dL.reshape(-1))
        assert torch.equal(ga, gb) and float(ga.abs().max()) > 0
    p = torch.from_numpy(data)
    a = tr.render(st_gen, at, p, 1.0, seed=5, spp=4)
    b = tr.render(st_fast, at, p, 1.0, seed=5, spp=4)
    np.testing.assert_allclose(a.sum(-1).numpy(), b.sum(-1).numpy(),
                               rtol=1e-6, atol=1e-7 * float(a.max()))
    assert not torch.equal(a, b)  # the channels differ


def test_hybrid_final_render_keeps_the_target(work):
    """A surface-aware scene's final render on the hybrid engine: one
    channel, the scene's dda, the residual's general loop from the first
    scatter splitting its segments at the target's crossings."""
    sc = JScene(_square_config(work))
    static, arr = sc.build(mode="volume", include_target=True, max_depth=8,
                           rr_depth=4, sensor=sc.final_sensor)
    assert static.sensor.channels == 1
    assert any(s.is_target for s in static.surfaces)
    data = np.random.default_rng(2).uniform(
        0.2, 1.0, sc.projector.active_size()).astype(np.float32)
    je = JEngine(static, arr, spp=SPP, chunk=CHUNK)
    ts, ta = scene_from_jax(static, arr)
    te = ScatteringEngine(ts, ta, "cpu", spp=SPP)
    assert not te.static_s.fast_residual
    te.arr["chord_pack"] = torch.from_numpy(np.array(je._arr["chord_pack"]))
    vj = np.asarray(jax.jit(lambda d, p: je.render_vol(
        d, 1.0, seed=0, params=p))(jnp.asarray(data), je.params()))
    vt = te.render_vol(torch.from_numpy(data), 1.0, 0).numpy()
    assert vt.shape == static.sensor.shape
    _channels_close(vt, vj, False)


def test_wavefront_final_render_keeps_the_target(work):
    sc = JScene(_sa_config(work, "dda", 0.5))
    static, arr = sc.build(mode="volume", include_target=True, max_depth=8,
                           rr_depth=3, sensor=sc.final_sensor)
    assert static.sensor.channels == 1
    data, dL = _inputs(static, sc.projector.active_size(), 3)
    vt, vj, gt, gj = _render_both(static, arr, data, dL, 0)
    _channels_close(vt, vj, True)
    _channels_close(gt[:, None], gj[:, None], True)


def _files(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


def _bench_cell(work, out, **kw):
    """bench.py:686-766's surface-aware cell cut to size: the square vial
    (bench.py:197-200) at albedo 0.5, 24 angles of a 32x32 DMD at 0.3125
    mm, a 25^3 surface-aware film and a 25^3 final sensor, filter_radon,
    hybrid_estimator delta, the thresholded loss at tl 0.9, tu 0.95, 3
    steps, spp 1 (the final render at spp_ref 2).

    25 voxels, not 20: at 20 (0.5 mm voxels) the target's x and y faces
    lie on voxel boundaries, where the packages' rays, an ulp apart
    (torch's and XLA's sin / cos), start their dda walks in different
    voxels: a walk that starts an ulp short of a boundary and leaves it
    never steps that axis, in both packages alike (drtvam_tpu/ops/
    march.py:618-631; ROADMAP queue 3)."""
    med = {"ior": 1.40, "phase": {"type": "rayleigh"}, "extinction": 0.05,
           "albedo": 0.5}
    film = {"type": "vfilm", "resx": 25, "resy": 25, "resz": 25}
    sensor = {"type": "dda", "scalex": 10, "scaley": 10, "scalez": 10}
    cfg = {
        "vial": {"type": "square", "w_int": 6.8, "w_ext": 7.2, "ior": 1.54,
                 "medium": med},
        "projector": {"type": "collimated", "n_patterns": 24, "resx": 32,
                      "resy": 32, "pixel_size": 10.0 / 32,
                      "motion": "circular", "distance": 30},
        "sensor": dict(sensor, film=dict(film, surface_aware=True)),
        "final_sensor": dict(sensor, film=film),
        "target": {"filename": str(work / "bench_target.ply"),
                   "size": 10.0},
        "loss": {"type": "threshold", "tl": 0.9, "tu": 0.95},
        "filter_radon": True, "hybrid_estimator": "delta",
        "n_steps": 3, "spp": 1, "spp_ref": 2, "checkpoint_every": 3,
        "output": str(work / out)}
    cfg.update(kw)
    return cfg


def _run_clis(work, name, cfg_of):
    """Both CLIs on cfg_of(out): the two output directories."""
    outs = []
    for run, flag, key in ((jmain, "--backend", "j"), (tmain, "--device",
                                                       "t")):
        out = f"{name}_{key}"
        path = work / f"{out}.json"
        path.write_text(json.dumps(cfg_of(out)))
        run([str(path), flag, "cpu"])
        outs.append(work / out)
    return outs


def _same_artifacts(j, t):
    assert _files(t) == _files(j)
    for f in ("target.npy", "target_binary.npy"):
        np.testing.assert_array_equal(np.load(t / f), np.load(j / f))
    for f in ("target_in.exr", "target_out.exr"):
        assert (t / f).read_bytes() == (j / f).read_bytes()


def test_surface_aware_hybrid_clis_agree(work, capsys):
    """Both CLIs on the shrunk bench cell: auto runs the hybrid engine
    (the ballistic cull, the delta fast residual with the inside mask,
    the final render's dda residual keeping the target)."""
    j, t = _run_clis(work, "hy", lambda out: _bench_cell(work, out))
    assert "Hybrid engine on cpu" in capsys.readouterr().out
    _same_artifacts(j, t)
    with np.load(t / "checkpoint.npz") as ft, \
            np.load(j / "checkpoint.npz") as fj:
        np.testing.assert_array_equal(ft["active_pixels"],
                                      fj["active_pixels"])
        assert 0 < ft["active_pixels"].size < 24 * 32 * 32
    lj, lt = np.load(j / "loss.npy"), np.load(t / "loss.npy")
    np.testing.assert_allclose(lt, lj, rtol=1e-3)
    assert lt[-1] < lt[0]
    final = np.load(t / "final.npy")
    assert final.shape == (25, 25, 25, 1) and np.isfinite(final).all()


def _example_config(work, out):
    """examples/surface_aware.json cut as tests/test_torch_surface_aware.py
    cuts it (30 angles of 48x16, a 24x24x8 film, a 40x40x14 final
    sensor), on the wavefront engine at spp 1, 2 steps."""
    with open(os.path.join(os.path.dirname(__file__), "..", "examples",
                           "surface_aware.json")) as f:
        cfg = json.load(f)
    cfg["projector"].update(n_patterns=30, resx=48, resy=16,
                            pixel_size=0.125)
    cfg["sensor"]["film"].update(resx=24, resy=24, resz=8)
    cfg["final_sensor"]["film"].update(resx=40, resy=40, resz=14)
    cfg["target"]["filename"] = str(work / "box_hole.ply")
    cfg.update(engine="wavefront", spp=1, spp_ref=1, n_steps=2,
               output=str(work / out))
    return cfg


def test_surface_aware_wavefront_clis_agree(work, capsys):
    """Both CLIs with engine wavefront on a surface-aware film: the
    analog march keeping the target, its inside channel from the
    crossings. Step 0's loss, on the same patterns, to 1e-5; step 1's to
    5e-3 (measured 1.2e-3). Not to the 1e-4 of the one-channel
    wavefront (tests/test_torch_optimize.py): a voxel the target's
    surface barely cuts keeps a sliver of fractional volume (down to 1e-7
    of a voxel here, 1e-10 on the bench's 256^3 film), whose inverse
    scales the dose a lane deposits there by the parity of its crossings;
    a path an ulp apart (torch's and XLA's sin / cos) moves such a
    deposit, and the loss gradient of that voxel, by that factor, so
    the histories part after the first step (ROADMAP queue 3)."""
    save_ply(make_box_with_hole((2.0, 2.0, 0.5), 1.0,
                                hole_center_xy=(-1.0, 0.0), segments=49),
             str(work / "box_hole.ply"))
    j, t = _run_clis(work, "wf", lambda out: _example_config(work, out))
    assert "Wavefront engine on cpu" in capsys.readouterr().out
    _same_artifacts(j, t)
    lj, lt = np.load(j / "loss.npy"), np.load(t / "loss.npy")
    np.testing.assert_allclose(lt[0], lj[0], rtol=1e-5)
    np.testing.assert_allclose(lt[1], lj[1], rtol=5e-3)
    assert lt[-1] < lt[0]
    final = np.load(t / "final.npy")
    assert final.shape == (14, 40, 40, 1) and np.isfinite(final).all()
