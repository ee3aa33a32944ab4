"""The wavefront's parts against the JAX package on the same numpy
inputs: warps, Fresnel refraction, the phase registry and free flights,
ray_cylinder / ray_box / intersect_scene, and sample_rays / ray_weight
for the three projector kinds.

Tolerances: float32 elementwise math in both packages; XLA's and
torch's CPU transcendentals (sin, cos, exp, log1p, sqrt) differ by an
ulp or two, so values agree to 2e-6 of their scale; the Rayleigh cube
root is cbrt in JAX and pow(., 1/3) in the port, a few ulps: 1e-5.
Integers and masks agree exactly."""
import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from drtvam_tpu.core import warp as jwarp
from drtvam_tpu.core.rng import Sampler as JSampler
from drtvam_tpu.models import projector as jproj
from drtvam_tpu.models.scene import Scene as JScene
from drtvam_tpu.ops import fresnel as jfres
from drtvam_tpu.ops import intersect as jint
from drtvam_tpu.ops import march as jmarch
from drtvam_tpu.ops import medium as jmed
from drtvam_tpu.ops.mesh import make_box, save_ply
from drtvam_tpu_torch.convert import scene_from_jax
from drtvam_tpu_torch.core import warp as twarp
from drtvam_tpu_torch.core.rng import Sampler as TSampler
from drtvam_tpu_torch.models.geometry import MESH, NULL
from drtvam_tpu_torch.models import projector as tproj
from drtvam_tpu_torch.ops import fresnel as tfres
from drtvam_tpu_torch.ops import intersect as tint
from drtvam_tpu_torch.ops import march as tmarch
from drtvam_tpu_torch.ops import medium as tmed
from torch_jax_native import jax_native_libraries  # noqa: F401

TOL = 2e-6


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: the plain wavefront's many small ops gain
    nothing from more, and the suite runs several workers on one host,
    where spinning thread pools slow every worker down."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close(t, j, tol=TOL):
    j = np.asarray(j)
    t = t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)
    scale = max(float(np.abs(j[np.isfinite(j)]).max(initial=0.0)), 1.0)
    np.testing.assert_allclose(t, j, rtol=tol, atol=tol * scale)


def _u(n, k, seed=0):
    return np.random.default_rng(seed).random((n, k)).astype(np.float32)


def _dirs(n, seed):
    v = np.random.default_rng(seed).normal(size=(n, 3)).astype(np.float32)
    return v / np.linalg.norm(v, axis=1, keepdims=True)


@pytest.mark.parametrize("name", ["square_to_uniform_sphere",
                                  "square_to_uniform_disk_concentric",
                                  "square_to_cosine_hemisphere"])
def test_warps(name):
    u = _u(4096, 2)
    u[:4] = [[0.5, 0.5], [0.0, 0.0], [0.5, 0.0], [0.0, 0.5]]  # degenerate
    _close(getattr(twarp, name)(torch.from_numpy(u)),
           getattr(jwarp, name)(jnp.asarray(u)))


def test_fresnel_and_refract_both_sides():
    n = 4096
    d, nrm = _dirs(n, 1), _dirs(n, 2)
    eta = np.random.default_rng(3).uniform(0.6, 1.7, n).astype(np.float32)
    td = [torch.from_numpy(x) for x in (d, nrm, eta)]
    jd = [jnp.asarray(x) for x in (d, nrm, eta)]
    for t, j in zip(tfres.refract(*td), jfres.refract(*jd)):
        if t.dtype == torch.bool:
            np.testing.assert_array_equal(t.numpy(), np.asarray(j))
        else:
            _close(t, j)
    ci = np.abs(d[:, 0])
    for t, j in zip(tfres.fresnel_dielectric(torch.from_numpy(ci), td[2]),
                    jfres.fresnel_dielectric(jnp.asarray(ci), jd[2])):
        _close(t.to(torch.float32), np.asarray(j, np.float32))


@pytest.mark.parametrize("phase,g,tol", [("rayleigh", 0.0, 1e-5),
                                         ("hg", 0.6, TOL), ("hg", 0.0, TOL),
                                         ("isotropic", 0.0, TOL),
                                         ("forward_delta", 0.0, TOL)])
def test_phase_sampling(phase, g, tol):
    n = 4096
    d = _dirs(n, 4)
    d[:2] = [[0.0, 0.0, 1.0], [0.0, 0.0, -1.0]]
    u = _u(n, 2, 5)
    t = tmed.sample_phase_direction(phase, torch.tensor(g),
                                    torch.from_numpy(d),
                                    torch.from_numpy(u[:, 0]),
                                    torch.from_numpy(u[:, 1]))
    j = jmed.sample_phase_direction(phase, jnp.float32(g), jnp.asarray(d),
                                    jnp.asarray(u[:, 0]),
                                    jnp.asarray(u[:, 1]))
    _close(t, j, tol)
    np.testing.assert_allclose(torch.linalg.norm(t, dim=1).numpy(), 1.0,
                               atol=1e-5)


def test_onb_free_flight_transmittance():
    d = _dirs(2048, 6)
    for t, j in zip(tmed.build_onb(torch.from_numpy(d)),
                    jmed.build_onb(jnp.asarray(d))):
        _close(t, j)
    for t, j in zip(tmarch._onb(torch.from_numpy(d)),
                    jmarch._onb(jnp.asarray(d))):
        _close(t, j)
    u = _u(2048, 1, 7)[:, 0]
    u[:2] = [0.0, 0.99999994]
    st = np.float32(0.37)
    _close(tmed.sample_free_flight(torch.from_numpy(u), torch.tensor(st)),
           jmed.sample_free_flight(jnp.asarray(u), st))
    t = np.abs(_u(2048, 1, 8)[:, 0]) * 10
    _close(tmed.transmittance(torch.tensor(st), torch.from_numpy(t)),
           jmed.transmittance(st, jnp.asarray(t)))


def _rays(n, seed, spread=6.0):
    rng = np.random.default_rng(seed)
    o = rng.uniform(-spread, spread, (n, 3)).astype(np.float32)
    d = _dirs(n, seed + 1)
    d[:8, 2] = 0.0   # horizontal rays, as the collimated projector's
    d[:8] /= np.linalg.norm(d[:8], axis=1, keepdims=True)
    return o, d


def _same_hits(tt, tn, jt, jn):
    jt, jn = np.asarray(jt), np.asarray(jn)
    hit = np.isfinite(jt)
    np.testing.assert_array_equal(np.isfinite(tt.numpy()), hit)
    _close(tt.numpy()[hit], jt[hit])
    _close(tn.numpy()[hit], jn[hit])


def test_ray_cylinder():
    o, d = _rays(8192, 9)
    tt, tn = tint.ray_cylinder(torch.from_numpy(o), torch.from_numpy(d), 1e-4,
                               torch.tensor(4.0), torch.tensor(-3.0),
                               torch.tensor(3.0))
    jt, jn = jint.ray_cylinder(jnp.asarray(o), jnp.asarray(d), 1e-4,
                               jnp.float32(4.0), jnp.float32(-3.0),
                               jnp.float32(3.0))
    assert np.isfinite(np.asarray(jt)).mean() > 0.2
    _same_hits(tt, tn, jt, jn)


def test_ray_box():
    o, d = _rays(8192, 10)
    h = np.asarray([3.0, 2.5, 4.0], np.float32)
    tt, tn = tint.ray_box(torch.from_numpy(o), torch.from_numpy(d), 1e-4,
                          torch.from_numpy(h))
    jt, jn = jint.ray_box(jnp.asarray(o), jnp.asarray(d), 1e-4,
                          jnp.asarray(h))
    assert np.isfinite(np.asarray(jt)).mean() > 0.2
    _same_hits(tt, tn, jt, jn)


# ---- projectors -------------------------------------------------------------


@pytest.fixture(scope="module")
def target_path(tmp_path_factory):
    path = tmp_path_factory.mktemp("parts") / "t.ply"
    save_ply(make_box((0.5, 0.5, 0.5)), str(path))
    return str(path)


def _jscene(target_path, projector, vial="cylindrical"):
    vials = {
        "cylindrical": {"type": "cylindrical", "r_int": 2.3, "r_ext": 2.6,
                        "ior": 1.54, "medium": {"ior": 1.40,
                                                "extinction": 0.1,
                                                "albedo": 0.0}},
        "square": {"type": "square", "w_int": 4.6, "w_ext": 5.2,
                   "ior": 1.24, "medium": {"ior": 1.347, "extinction": 0.07,
                                           "albedo": 0.0}},
    }
    cfg = {"vial": vials[vial], "projector": projector,
           "sensor": {"type": "dda", "scalex": 5.07, "scaley": 5.07,
                      "scalez": 1.29,
                      "film": {"type": "vfilm", "resx": 16, "resy": 16,
                               "resz": 8}},
           "target": {"filename": target_path, "size": 4.0}, "output": "."}
    return JScene(cfg)


PROJECTORS = {
    "collimated": {"type": "collimated", "n_patterns": 7, "resx": 20,
                   "resy": 9, "pixel_size": 0.23, "motion": "circular",
                   "distance": 20},
    "telecentric": {"type": "telecentric", "n_patterns": 7, "resx": 20,
                    "resy": 9, "pixel_size": 0.23, "aperture_radius": 0.3,
                    "focus_distance": 18.0, "motion": "circular",
                    "distance": 20},
    "lens": {"type": "lens", "n_patterns": 7, "resx": 20, "resy": 9,
             "fov": 20.0, "aperture_radius": 0.4, "focus_distance": 21.0,
             "motion": {"type": "circular", "clockwise": True},
             "distance": 20},
}


@pytest.mark.parametrize("kind", list(PROJECTORS))
@pytest.mark.parametrize("store", ["identity", "sparse"])
@pytest.mark.parametrize("regular,sample_time", [(False, True),
                                                 (True, False)])
def test_sample_rays(kind, store, regular, sample_time, target_path):
    sc = _jscene(target_path, PROJECTORS[kind])
    if store == "sparse":
        n = sc.projector.active_size()
        keep = np.arange(3, n, 5, dtype=np.int32)
        sc.projector.set_active(keep, np.ones(keep.size, np.float32))
    static, arr = sc.build(mode="volume", include_target=False,
                           regular_sampling=regular, sample_time=sample_time)
    tstatic, tarr = scene_from_jax(static, arr)
    tarr = tmarch.scene_tensors(tarr, "cpu")
    spp = 3
    n_lanes = static.projector.n_active * spp
    lane = np.arange(n_lanes, dtype=np.uint32)
    js, ts = JSampler(np.uint32(11)), TSampler(11)
    jo, jd, ja, jc = jproj.sample_rays(
        static.projector, arr, jnp.asarray(arr["active_pixels"]),
        jnp.asarray(lane), spp, js, js.init(n_lanes), regular, sample_time,
        static.clockwise)
    to, td, ta, tc = tproj.sample_rays(
        tstatic.projector, tarr, tarr["active_pixels"],
        torch.from_numpy(lane.astype(np.int64)), spp, ts,
        ts.init(n_lanes), regular, sample_time, tstatic.clockwise)
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    _close(to, jo)
    _close(td, jd)
    for k in ("pixel_size", "print_time"):
        assert tarr[k].dtype == torch.float32
    _close(tproj.ray_weight(tstatic.projector, tarr, spp,
                            tarr["print_time"]),
           jproj.ray_weight(static.projector, arr, spp, arr["print_time"]))


@pytest.mark.parametrize("vial", ["cylindrical", "square"])
def test_intersect_scene(vial, target_path):
    sc = _jscene(target_path, PROJECTORS["collimated"], vial)
    static, arr = sc.build(mode="volume", include_target=False)
    tstatic, tarr = scene_from_jax(static, arr)
    tarr = tmarch.scene_tensors(tarr, "cpu")
    o, d = _rays(8192, 12, spread=4.0)
    active = np.random.default_rng(13).random(8192) < 0.9
    jt, jn, js, jv = jmarch.intersect_scene(static, arr, jnp.asarray(o),
                                            jnp.asarray(d),
                                            jnp.asarray(active))
    tt, tn, ts, tv = tmarch.intersect_scene(
        tstatic, tarr, torch.from_numpy(o), torch.from_numpy(d),
        torch.from_numpy(active))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    _same_hits(tt, tn, jt, jn)


def test_unported_modes_raise(target_path):
    sc = _jscene(target_path, PROJECTORS["collimated"])
    static, arr = sc.build(mode="volume", include_target=False)
    tstatic, _ = scene_from_jax(static, arr)
    # a mesh surface that is not the target (an occlusion) is ported
    occlusion = tmarch.SurfaceStatic(kind=MESH, bsdf=NULL, medium_side=2,
                                     is_target=False, tri_slice=(0, 1))
    for mode in ("volume", "radon"):
        tmarch.check_supported(dataclasses.replace(
            tstatic, mode=mode, surfaces=tstatic.surfaces + (occlusion,)))
    # medium gradients are ported; with a residual mode (which no driver
    # path of the JAX package reaches) they raise
    tmarch.check_supported(dataclasses.replace(tstatic, medium_grads=True))
    with pytest.raises(NotImplementedError, match="item 21"):
        tmarch.check_supported(dataclasses.replace(
            tstatic, medium_grads=True, scattered_only=True))
