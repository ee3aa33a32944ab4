"""The port's wavefront path tracer (plain version, CPU) against the JAX
package's `render` / `_adjoint` on the same scenes, seeds and patterns,
and against itself (AD vs finite differences, the ballistic engine).

Tolerances, with their reasons:
  * same seed, same paths: dose and pattern gradient to 1e-4 of the
    largest |value| (measured <= 3.2e-5). Both trace the same float32
    paths; XLA's and torch's CPU transcendentals differ by an ulp or
    two, which moves DDA step lengths and deposits by as much, and the
    JAX package sums each 32 steps' deposits in another order. A delta
    deposit is a point: a position an ulp off can land in the next
    voxel. There, up to 0.2 % of the nonzero values may be off by more
    (measured: 2 voxels of 2,900 with the lens projector, 0 elsewhere),
    and the totals agree to 2e-3 (measured: dose 0, gradient 7.0e-4, the
    moved deposit gathering another voxel's dL); elsewhere to 1e-5;
  * ratio tracking matches at the same seed only where no later draw is
    used (pure absorption, transmission only, no lane past rr_depth):
    the JAX package advances a chunk's counters in lock step, the port
    gives each lane its own stream (ROADMAP queue 3). With scattering,
    reflections and Russian roulette both are unbiased estimates of one
    dose: their means over 8 seeds agree within 5 standard errors
    (taken from the measured spread), on the total and on 8 blocks;
  * AD vs finite differences < 2e-4, the JAX package's own contract
    (tests/test_gradients.py): the adjoint replays the realization the
    finite difference evaluates;
  * regular sampling vs the ballistic engine: rtol 1e-3, atol 1e-4 of
    the max, as tests/test_ballistic.py holds the JAX package.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from drtvam_tpu.models.scene import Scene as JScene
from drtvam_tpu.ops.mesh import make_box, save_ply
from drtvam_tpu.ops.render import _adjoint as j_adjoint
from drtvam_tpu.ops.render import render as j_render
from drtvam_tpu_torch.convert import scene_from_jax
from drtvam_tpu_torch.models.scene import Scene as TScene
from drtvam_tpu_torch.ops import render as tr
from drtvam_tpu_torch.ops.ballistic import BallisticEngine
from drtvam_tpu_torch.ops.march import scene_tensors
from torch_jax_native import jax_native_libraries  # noqa: F401

SAME_SEED_TOL = 1e-4
D_EXT, D_INT = 16.77, 15.33


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: the plain wavefront's many small ops gain
    nothing from more, and the suite runs several workers on one host,
    where spinning thread pools slow every worker down."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def target_path(tmp_path_factory):
    path = tmp_path_factory.mktemp("wf") / "t.ply"
    save_ply(make_box((0.5, 0.5, 0.5)), str(path))
    return str(path)


def _config(target_path, method, albedo, projector, n_patterns=6, resx=16,
            resy=12, film=20):
    p = {"type": projector, "n_patterns": n_patterns, "resx": resx,
         "resy": resy, "pixel_size": D_EXT / resx, "motion": "circular",
         "distance": 1.5 * D_EXT}
    if projector == "telecentric":
        p.update(aperture_radius=0.3, focus_distance=20.0)
    elif projector == "lens":
        del p["pixel_size"]
        p.update(fov=30.0, aperture_radius=0.3, focus_distance=25.0,
                 motion={"type": "circular", "clockwise": True})
    return {
        "vial": {"type": "cylindrical", "r_ext": 0.5 * D_EXT,
                 "r_int": 0.5 * D_INT, "height": 20.0, "ior": 1.514,
                 "medium": {"ior": 1.4849, "extinction": 0.1,
                            "albedo": albedo, "phase": {"type": "rayleigh"}}},
        "projector": p,
        "sensor": {"type": method, "scalex": D_EXT, "scaley": D_EXT,
                   "scalez": D_EXT, "majorant": 10.0,
                   "film": {"type": "vfilm", "resx": film, "resy": film,
                            "resz": film}},
        "target": {"filename": target_path, "size": 4.0}, "output": "."}


# name: (estimator, albedo, projector, transmission_only, rr_depth)
CASES = {
    "dda_absorbing": ("dda", 0.0, "collimated", True, 3),
    "ratio_absorbing": ("ratio", 0.0, "collimated", True, 8),
    "dda_lens": ("dda", 0.0, "lens", True, 3),
    "dda_scattering": ("dda", 0.5, "collimated", True, 3),
    "delta_scattering": ("delta", 0.5, "collimated", True, 3),
    "dda_telecentric": ("dda", 0.0, "telecentric", True, 3),
    "delta_scattering_lens": ("delta", 0.5, "lens", True, 3),
    "dda_scattering_reflecting": ("dda", 0.5, "collimated", False, 3),
}
SPP, SEED, MAX_DEPTH = 4, 3, 8


def _scenes(target_path, case):
    method, albedo, proj, tonly, rr = CASES[case]
    sc = JScene(_config(target_path, method, albedo, proj))
    static, arr = sc.build(mode="volume", include_target=False,
                           max_depth=MAX_DEPTH, rr_depth=rr,
                           transmission_only=tonly, sample_time=True)
    inv_vol = np.float32(1.0 / sc.sensor.voxel_volume)
    return sc, static, arr, inv_vol


@pytest.fixture(scope="module", params=list(CASES))
def same_seed(request, target_path):
    """One case rendered by both packages: (port dose, JAX dose, port
    gradient, JAX gradient, the port's scene and inputs)."""
    sc, static, arr, inv_vol = _scenes(target_path, request.param)
    rng = np.random.default_rng(0)
    data = rng.uniform(0.5, 1.5, sc.projector.active_size()) \
        .astype(np.float32)
    dL = rng.uniform(0.0, 1.0, static.sensor.n_cells).astype(np.float32)
    vj = np.asarray(jax.jit(lambda d: j_render(
        static, arr, d, inv_vol, seed=SEED, spp=SPP, chunk=1 << 16))(
            jnp.asarray(data)))
    gj = np.asarray(jax.jit(lambda dl: j_adjoint(
        static, arr, jnp.uint32(SEED), SPP, 1 << 16, dl)[0])(
            jnp.asarray(dL)))
    ts, ta = scene_from_jax(static, arr)
    ta = scene_tensors(ta, "cpu")
    vt = tr.render(ts, ta, torch.from_numpy(data), float(inv_vol),
                   seed=SEED, spp=SPP).numpy()
    gt = tr.adjoint(ts, ta, SEED, SPP, tr.DEFAULT_CHUNK,
                    torch.from_numpy(dL)).numpy()
    return vt, vj, gt, gj, (ts, ta, data, dL, float(inv_vol))


def _within(port, ref, tol, estimator):
    scale = float(np.abs(ref).max())
    assert scale > 0.0
    off = np.abs(port - ref) > tol * scale
    share = off.sum() / max(np.count_nonzero(ref), 1)
    delta = estimator == "delta"
    assert share <= (2e-3 if delta else 0.0), share
    np.testing.assert_allclose(port.sum(dtype=np.float64),
                               ref.sum(dtype=np.float64),
                               rtol=2e-3 if delta else 1e-5)


def test_dose_matches_jax_at_the_same_seed(same_seed):
    vt, vj, _, _, (ts, *_) = same_seed
    assert vt.shape == vj.shape and np.isfinite(vt).all()
    _within(vt, vj, SAME_SEED_TOL, ts.sensor.estimator)


def test_gradient_matches_jax_at_the_same_seed(same_seed):
    _, _, gt, gj, (ts, *_) = same_seed
    assert gt.shape == gj.shape and np.isfinite(gt).all()
    _within(gt, gj, SAME_SEED_TOL, ts.sensor.estimator)


def test_autograd_equals_the_explicit_adjoint(same_seed):
    """render's backward is RenderRaw's replay: the chain rule delivers
    upstream * inv_vol to the adjoint."""
    _, _, _, _, (ts, ta, data, dL, inv_vol) = same_seed
    p = torch.from_numpy(data).requires_grad_(True)
    v = torch.from_numpy(dL).reshape(ts.sensor.shape)
    vol = tr.render(ts, ta, p, inv_vol, seed=SEED, spp=SPP, spp_grad=2)
    (g,) = torch.autograd.grad(vol, p, v)
    ref = tr.adjoint(ts, ta, SEED, 2, tr.DEFAULT_CHUNK,
                     (v * inv_vol).reshape(-1))
    assert torch.equal(g, ref)


def _block_sums(vol):
    z, y, x = vol.shape[:3]
    return vol[..., 0].reshape(2, z // 2, 2, y // 2, 2, x // 2) \
        .sum((1, 3, 5)).ravel()


def test_ratio_with_scattering_matches_statistically(target_path):
    """Scattering, reflections and Russian roulette from depth 2: the
    two packages' per-lane streams differ after the first ratio
    segment, so compare means over 8 seeds."""
    sc = JScene(_config(target_path, "ratio", 0.5, "collimated"))
    static, arr = sc.build(mode="volume", include_target=False,
                           max_depth=MAX_DEPTH, rr_depth=2,
                           transmission_only=False, sample_time=True)
    inv_vol = np.float32(1.0 / sc.sensor.voxel_volume)
    data = np.random.default_rng(1).uniform(
        0.5, 1.5, sc.projector.active_size()).astype(np.float32)
    dL = np.random.default_rng(2).uniform(
        0.0, 1.0, static.sensor.n_cells).astype(np.float32)
    fj = jax.jit(lambda d, s: j_render(static, arr, d, inv_vol, seed=s,
                                       spp=SPP, chunk=1 << 16))
    gjf = jax.jit(lambda dl, s: j_adjoint(static, arr, s, SPP, 1 << 16,
                                          dl)[0])
    ts, ta = scene_from_jax(static, arr)
    ta = scene_tensors(ta, "cpu")
    stats = {"jax": [], "port": []}
    for seed in range(8):
        vj = np.asarray(fj(jnp.asarray(data), jnp.uint32(seed)))
        gj = np.asarray(gjf(jnp.asarray(dL), jnp.uint32(seed)))
        vt = tr.render(ts, ta, torch.from_numpy(data), float(inv_vol),
                       seed=seed, spp=SPP).numpy()
        gt = tr.adjoint(ts, ta, seed, SPP, tr.DEFAULT_CHUNK,
                        torch.from_numpy(dL)).numpy()
        for key, v, g in (("jax", vj, gj), ("port", vt, gt)):
            stats[key].append(np.concatenate([
                [v.sum()], _block_sums(v), [g.sum()],
                g.reshape(static.projector.n_patterns, -1).sum(1)]))
    j, t = np.asarray(stats["jax"]), np.asarray(stats["port"])
    se = np.sqrt(j.var(0, ddof=1) / len(j) + t.var(0, ddof=1) / len(t))
    assert (se > 0).all()
    assert (np.abs(t.mean(0) - j.mean(0)) <= 5.0 * se).all(), \
        np.abs(t.mean(0) - j.mean(0)) / se


@pytest.mark.parametrize("method", ["dda", "ratio", "delta"])
def test_reverse_ad_matches_fd(method, target_path):
    """tests/test_gradients.py's scene and contract on the port (4 lanes
    per pixel instead of 16: the check holds one realization)."""
    cfg = _config(target_path, method, 0.5, "collimated", n_patterns=10,
                  resx=24, resy=24, film=32)
    sc = TScene(cfg)
    static, arr = sc.build(mode="volume", include_target=False,
                           max_depth=32, rr_depth=3, transmission_only=True,
                           sample_time=True)
    ta = scene_tensors(arr, "cpu")
    inv_vol = float(np.float32(1.0 / sc.sensor.voxel_volume))
    n = sc.projector.active_size()
    patterns = torch.linspace(1.0, 10.0, n, dtype=torch.float32)

    def loss_of(data):
        vol = tr.render(static, ta, data, inv_vol, seed=0, spp=4)
        return torch.mean(torch.square(vol))

    eps = 1e-3
    with torch.no_grad():
        fd = (float(loss_of(patterns * (1.0 + eps))) -
              float(loss_of(patterns * (1.0 - eps)))) / (2 * eps)
    p = patterns.clone().requires_grad_(True)
    (g,) = torch.autograd.grad(loss_of(p), p)
    ad = float(torch.dot(g, patterns))
    assert fd != 0.0
    assert abs(ad - fd) / abs(fd) < 2e-4


VIALS = {
    "index_matched": {
        "type": "index_matched", "r": 2.9,
        "medium": {"ior": 1.347, "extinction": 0.03, "albedo": 0.0}},
    "cylindrical": {
        "type": "cylindrical", "r_int": 2.3, "r_ext": 2.6, "ior": 1.54,
        "medium": {"ior": 1.40, "extinction": 0.1, "albedo": 0.0}},
    "square": {
        "type": "square", "w_int": 4.6, "w_ext": 5.2, "ior": 1.24,
        "medium": {"ior": 1.347, "extinction": 0.07, "albedo": 0.0}},
    "double_cylindrical": {
        "type": "double_cylindrical", "r_ext_outer": 2.6,
        "r_int_outer": 2.4, "r_ext_inner": 1.0, "r_int_inner": 0.8,
        "ior_outer": 1.54, "ior_inner": 1.52, "ior_inside_inner": 1.40,
        "medium": {"ior": 1.40, "extinction": 0.1, "albedo": 0.0}},
}


@pytest.mark.parametrize("vial", list(VIALS))
def test_regular_sampling_matches_ballistic_engine(vial, target_path):
    """The port's wavefront against the port's ballistic engine, on
    tests/test_ballistic.py's non-degenerate geometry."""
    cfg = {
        "vial": VIALS[vial],
        "projector": {"type": "collimated", "n_patterns": 23, "resx": 40,
                      "resy": 16, "pixel_size": 0.1231,
                      "motion": "circular", "distance": 20},
        "sensor": {"type": "dda", "scalex": 5.07, "scaley": 5.07,
                   "scalez": 1.29,
                   "film": {"type": "vfilm", "resx": 40, "resy": 40,
                            "resz": 20}},
        "target": {"filename": target_path, "size": 4.0}, "output": "."}
    sc = TScene(cfg)
    static, arr = sc.build(mode="volume", include_target=False,
                           max_depth=10, rr_depth=32, regular_sampling=True)
    data = torch.linspace(0.5, 1.5, sc.projector.active_size(),
                          dtype=torch.float32)
    inv_vol = float(np.float32(1.0 / sc.sensor.voxel_volume))
    vw = tr.render(static, scene_tensors(arr, "cpu"), data, inv_vol,
                   seed=0, spp=1).numpy()
    vb = BallisticEngine(static, arr, "cpu").render_vol(data, inv_vol) \
        .numpy()
    assert vw.sum() > 0
    np.testing.assert_allclose(vb, vw, rtol=1e-3,
                               atol=1e-4 * np.abs(vw).max())


def test_lane_ids_are_uint32(target_path):
    sc = TScene(_config(target_path, "dda", 0.0, "collimated"))
    static, arr = sc.build(mode="volume", include_target=False)
    with pytest.raises(ValueError, match="uint32"):
        tr.forward(static, scene_tensors(arr, "cpu"),
                   torch.zeros(static.projector.n_active), 0,
                   2 ** 32 // static.projector.n_active + 1)


def test_diffuse_surface_matches_jax(target_path):
    """A diffuse surface (the occlusions' BSDF; no analytic vial has
    one, so the inner vial's outer wall of a double-cylindrical vial is
    made diffuse here, with reflectance 0.6): rays in the medium bounce
    off it back into the medium, in both packages alike."""
    import dataclasses
    from drtvam_tpu.models.geometry import DIFFUSE
    cfg = _config(target_path, "dda", 0.0, "collimated")
    cfg["vial"] = {
        "type": "double_cylindrical", "r_ext_outer": 0.5 * D_EXT,
        "r_int_outer": 0.5 * D_INT, "r_ext_inner": 3.0, "r_int_inner": 2.6,
        "ior_outer": 1.54, "ior_inner": 1.52, "ior_inside_inner": 1.40,
        "medium": {"ior": 1.40, "extinction": 0.1, "albedo": 0.0}}
    sc = JScene(cfg)
    static, arr = sc.build(mode="volume", include_target=False,
                           max_depth=MAX_DEPTH, rr_depth=3,
                           transmission_only=False, sample_time=True)
    surfaces = list(static.surfaces)
    surfaces[2] = dataclasses.replace(surfaces[2], bsdf=DIFFUSE)
    static = dataclasses.replace(static, surfaces=tuple(surfaces))
    refl = np.zeros_like(arr["surf_refl"])
    refl[2] = 0.6
    arr = dict(arr, surf_refl=refl)
    inv_vol = np.float32(1.0 / sc.sensor.voxel_volume)
    data = np.random.default_rng(6).uniform(
        0.5, 1.5, sc.projector.active_size()).astype(np.float32)
    vj = np.asarray(jax.jit(lambda d: j_render(
        static, arr, d, inv_vol, seed=SEED, spp=SPP, chunk=1 << 16))(
            jnp.asarray(data)))
    ts, ta = scene_from_jax(static, arr)
    vt = tr.render(ts, scene_tensors(ta, "cpu"), torch.from_numpy(data),
                   float(inv_vol), seed=SEED, spp=SPP).numpy()
    _within(vt, vj, SAME_SEED_TOL, "dda")
