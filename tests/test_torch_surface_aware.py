"""Surface-aware films on the ballistic engine in the port (the
fractional volumes, the two-channel loss, the inside-mask split of
BallisticEngine, optimize()'s artifacts) against the JAX package, on
the CPU.

Tolerances, with their reasons:
  * fractional volumes, the sensor's volumes and inverse volumes:
    bitwise (the same host C++ and the same float32 numpy arithmetic);
  * the two-channel loss and its gradient: 1e-6 (float32 elementwise
    terms; the sums in another order);
  * the engine's dose and pattern gradient with the inside mask: rtol
    1e-5, atol 1e-5 of the max (tests/test_torch_ballistic.py's: the
    plain backprojection against XLA's);
  * both CLIs on a shrunk examples/surface_aware.json: the same artifact
    set, target_in/out.exr, target.npy and target_binary.* equal, the
    loss history to 1e-3 (tests/test_torch_optimize.py's ballistic CLI
    tolerance); with filter_radon the same kept pixels.
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from drtvam_tpu.models.scene import Scene as JScene
from drtvam_tpu.ops.ballistic import BallisticEngine as JEngine
from drtvam_tpu.ops.voxelize import fractional_volumes as j_fractional
from drtvam_tpu.opt import loss as jloss
from drtvam_tpu.opt.optimize import main as jmain
from drtvam_tpu_torch.convert import scene_from_jax
from drtvam_tpu_torch.models.scene import Scene as TScene
from drtvam_tpu_torch.ops.ballistic import BallisticEngine as TEngine
from drtvam_tpu_torch.ops.mesh import make_box_with_hole, save_ply
from drtvam_tpu_torch.ops.voxelize import fractional_volumes
from drtvam_tpu_torch.opt import loss as tloss
from drtvam_tpu_torch.opt.optimize import main as tmain
from torch_threads import one_torch_thread  # noqa: F401
from torch_jax_native import jax_native_libraries  # noqa: F401

TOL = 1e-5


@pytest.fixture(scope="module")
def work(tmp_path_factory):
    path = tmp_path_factory.mktemp("sa")
    save_ply(make_box_with_hole((2.0, 2.0, 0.5), 1.0,
                                hole_center_xy=(-1.0, 0.0), segments=49),
             str(path / "box_hole.ply"))
    return path


def _config(work, out, **kw):
    """examples/surface_aware.json cut to 30 angles, a 48x16 DMD, a
    24x24x8 surface-aware film and a 40x40x14 final sensor, 4 steps."""
    with open(os.path.join(os.path.dirname(__file__), "..", "examples",
                           "surface_aware.json")) as f:
        cfg = json.load(f)
    cfg["projector"].update(n_patterns=30, resx=48, resy=16,
                            pixel_size=0.125)
    cfg["sensor"]["film"].update(resx=24, resy=24, resz=8)
    cfg["final_sensor"]["film"].update(resx=40, resy=40, resz=14)
    cfg["target"]["filename"] = str(work / "box_hole.ply")
    cfg.update(n_steps=4, output=str(work / out))
    cfg.update(kw)
    return cfg


def _write(work, cfg, name):
    path = work / name
    path.write_text(json.dumps(cfg))
    return str(path)


def _files(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


@pytest.mark.parametrize("res, oversample", [((24, 24, 8), 4),
                                             ((17, 13, 9), 3)])
def test_fractional_volumes_bitwise(work, res, oversample):
    sc = TScene(_config(work, "fv"))
    tb = sc.target_bank()
    s = sc.sensor
    got = fractional_volumes(tb, s.bbox_min, s.bbox_max, res, oversample)
    ref = np.asarray(j_fractional(tb, s.bbox_min, s.bbox_max, res,
                                  oversample))
    assert got.shape == tuple(res[::-1]) + (2,) and got.dtype == np.float32
    np.testing.assert_array_equal(got, ref)
    inside = got[..., 0] > 0
    assert inside.any() and (got[..., 1] > 0).any()


def test_sensor_volumes_bitwise(work):
    """compute_volume and inv_volume(tb) of a surface-aware sensor: the
    (Z, Y, X, 2) volumes, computed once, and their inverse, 0 where a
    volume is 0; the one-channel sensor's scalar unchanged."""
    cfg = _config(work, "sv")
    ts, js = TScene(cfg), JScene(cfg)
    tb = ts.target_bank()
    vt = ts.sensor.compute_volume(tb)
    np.testing.assert_array_equal(vt, np.asarray(js.sensor.compute_volume(
        js.target_bank())))
    assert ts.sensor.compute_volume() is vt
    it = ts.sensor.inv_volume(tb)
    ij = np.asarray(js.sensor.inv_volume(js.target_bank()))
    assert it.dtype == np.float32 and (it == 0).any()
    np.testing.assert_array_equal(it, ij)
    f = ts.final_sensor
    assert f.inv_volume() == np.float32(js.final_sensor.inv_volume())
    with pytest.raises(ValueError, match="target mesh"):
        TScene(cfg).sensor.compute_volume()


@pytest.mark.parametrize("name, props", [
    ("threshold", {"tl": 0.8, "tu": 0.9, "weight_sparsity": 1e-3}),
    ("l2", {"weight_sparsity": 0.1, "reduction": "mean"}),
])
def test_two_channel_loss(name, props):
    rng = np.random.default_rng(3)
    shape = (4, 5, 6, 2)
    dose = rng.uniform(0.0, 1.3, shape).astype(np.float32)
    frac = rng.uniform(0.0, 1.0, shape[:3]).astype(np.float32)
    frac[0, 0, :2] = (0.0, 1.0)
    target = np.stack([frac, 1.0 - frac], -1) * np.float32(0.02)
    pats = rng.uniform(0.0, 1.0, 7).astype(np.float32)
    jl = jloss.losses[name](dict(props))
    tl = tloss.losses[name](dict(props))
    vj, (gj, pj) = jax.value_and_grad(
        lambda d, p: jl(d, jnp.asarray(target), p), argnums=(0, 1))(
        jnp.asarray(dose), jnp.asarray(pats))
    d = torch.from_numpy(dose).requires_grad_(True)
    p = torch.from_numpy(pats).requires_grad_(True)
    vt = tl(d, torch.from_numpy(target), p)
    gt, pt = torch.autograd.grad(vt, (d, p))
    np.testing.assert_allclose(float(vt.detach()), float(vj), rtol=1e-6)
    np.testing.assert_allclose(gt.numpy(), np.asarray(gj), rtol=1e-6,
                               atol=1e-6 * np.abs(np.asarray(gj)).max())
    np.testing.assert_allclose(pt.numpy(), np.asarray(pj), rtol=1e-6,
                               atol=1e-6 * np.abs(np.asarray(pj)).max())


@pytest.mark.parametrize("sparse", [False, True])
def test_engine_with_inside_mask_matches_jax(work, sparse):
    """The dose [dose * M, dose * (1 - M)] and the adjoint
    dL0 * M + dL1 * (1 - M), with the fractional volumes' inverse as
    inv_vol, on the scene that keeps its target mesh (stripped by the
    engine)."""
    js = JScene(_config(work, "eng"))
    if sparse:
        n = js.projector.active_size()
        idx = np.sort(np.random.default_rng(1).choice(
            n, n // 3, replace=False)).astype(np.int32)
        js.projector.set_active(idx, np.zeros(idx.size, np.float32))
    static, arr = js.build(mode="volume", include_target=True)
    assert static.sensor.channels == 2
    tb = js.target_bank()
    mask = np.asarray(js.sensor.discretize(tb))
    inv_vol = np.asarray(js.sensor.inv_volume(tb))
    je = JEngine(static, arr, impl="xla", inside_mask=mask)
    ts, ta = scene_from_jax(static, arr)
    te = TEngine(ts, ta, "cpu", inside_mask=mask)
    rng = np.random.default_rng(7)
    p = rng.uniform(0.5, 1.5, te.n_active).astype(np.float32)
    v = rng.uniform(0.0, 1.0, ts.sensor.shape).astype(np.float32)
    vol_j = np.asarray(jax.jit(lambda d: je.render_vol(d, inv_vol))(
        jnp.asarray(p)))
    g_j = np.asarray(jax.jit(lambda w: je.pattern_grad(w, inv_vol))(
        jnp.asarray(v)))
    iv = torch.from_numpy(np.array(inv_vol))
    vol_t = te.render_vol(torch.from_numpy(p), iv).numpy()
    g_t = te.pattern_grad(torch.from_numpy(v), iv).numpy()
    assert vol_t.shape == ts.sensor.shape and vol_j[..., 0].sum() > 0
    assert vol_j[..., 1].sum() > 0
    for out, ref in ((vol_t, vol_j), (g_t, g_j)):
        np.testing.assert_allclose(out, ref, rtol=TOL,
                                   atol=TOL * np.abs(ref).max())
    with pytest.raises(ValueError, match="inside mask"):
        TEngine(ts, ta, "cpu")


def test_surface_aware_clis_agree(work):
    j, t = work / "jax", work / "torch"
    jmain([_write(work, _config(work, "jax"), "jax.json"), "--backend",
           "cpu"])
    tmain([_write(work, _config(work, "torch"), "torch.json"), "--device",
           "cpu"])
    files = _files(t)
    assert files == _files(j)
    for f in ("target_in.exr", "target_out.exr", "target_binary.exr",
              "target_binary.npy", "histogram.png"):
        assert f in files
    assert "target.exr" not in files
    for f in ("target.npy", "target_binary.npy"):
        np.testing.assert_array_equal(np.load(t / f), np.load(j / f))
    for f in ("target_in.exr", "target_out.exr", "target_binary.exr"):
        assert (t / f).read_bytes() == (j / f).read_bytes()
    lj, lt = np.load(j / "loss.npy"), np.load(t / "loss.npy")
    np.testing.assert_allclose(lt, lj, rtol=1e-3)
    assert lt[-1] < lt[0]
    fj, ft = np.load(j / "final.npy"), np.load(t / "final.npy")
    assert ft.shape == fj.shape == (14, 40, 40, 1)
    np.testing.assert_allclose(ft, fj, rtol=1e-3, atol=1e-3 * fj.max())


def test_surface_aware_filter_radon_keeps_the_same_pixels(work):
    """filter_radon on a surface-aware film: both packages cull with the
    target's binary occupancy, not the two-channel target. The kept set
    is read from each package's checkpoint (active_pixels)."""
    kept = []
    for run, out, flag in ((jmain, "frj", "--backend"),
                           (tmain, "frt", "--device")):
        cfg = _config(work, out, filter_radon=True, n_steps=1,
                      checkpoint_every=1)
        run([_write(work, cfg, out + ".json"), flag, "cpu"])
        with np.load(work / out / "checkpoint.npz") as f:
            kept.append(f["active_pixels"])
    np.testing.assert_array_equal(kept[1], kept[0])
    assert 0 < kept[1].size < 30 * 48 * 16
