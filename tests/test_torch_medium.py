"""Medium calibration in the port (optimize_medium, the medium cotangents
of the wavefront adjoint, ops/march.py and ops/render.py RenderRaw) against
the JAX package on the CPU, with numpy-seeded inputs.

Tolerances, with their reasons:
  * d loss / d (sigma_t, albedo) against jax.grad of the JAX render at the
    same seed: the dda without scattering to rtol 1e-4 (the same float32
    paths and partials; the sums over lanes and steps in another order),
    the dda and delta with scattering, and the ratio without it, to 1e-3
    (XLA's and torch's transcendentals an ulp apart move a scattering
    path's deposits); ratio tracking with scattering draws from other
    streams in the two packages (ROADMAP queue 3), so its means over 8
    seeds agree within 5 standard errors;
  * the JAX tests' own properties (tests/test_medium_grads.py) on the
    port's render at their tolerances: AD against central finite
    differences for sigma_t (dda, 2e-4) and with scattering (0.25, the
    delta 1.2); zero without medium_grads; the pattern gradient
    unchanged by medium_grads, bitwise in the port;
  * the driver against the JAX driver on tests/test_medium_calibration.py's
    config: medium.json's sigma_t to 1e-3 relative, the loss history to
    1e-4; a resumed run bitwise to the port's own uninterrupted one, and
    across packages the loss to 1e-4 and the medium to 1e-4.
"""
import dataclasses
import json
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from drtvam_tpu.models.scene import Scene as JScene
from drtvam_tpu.ops.render import render as j_render
from drtvam_tpu.opt.optimize import optimize as j_optimize
from drtvam_tpu_torch.models.scene import Scene as TScene
from drtvam_tpu_torch.ops import render as tr
from drtvam_tpu_torch.ops.march import check_supported, scene_tensors
from drtvam_tpu_torch.opt.optimize import _Medium
from drtvam_tpu_torch.opt.optimize import optimize as t_optimize
from test_medium_calibration import make_cfg
from test_torch_custom_vial import SCENES as VIAL_SCENES
from test_torch_custom_vial import work as vial_work  # noqa: F401
from test_torch_occlusion import BSDFS
from test_torch_occlusion import _config as occlusion_config
from test_torch_occlusion import work as occ_work  # noqa: F401
from torch_jax_native import jax_native_libraries  # noqa: F401
from torch_threads import one_torch_thread  # noqa: F401

CHUNK = 1 << 14


def _grads_cfg(box_hole_mesh, albedo, estimator, extinction=0.4):
    """tests/test_medium_grads.py's scene (6 patterns, 16x8 DMD, 16x16x8
    film, the box-with-hole target)."""
    return {
        "vial": {"type": "cylindrical", "r_int": 2.0, "r_ext": 2.3,
                 "ior": 1.54,
                 "medium": {"ior": 1.4, "extinction": extinction,
                            "albedo": albedo,
                            "phase": {"type": "rayleigh"}}},
        "projector": {"type": "collimated", "n_patterns": 6, "resx": 16,
                      "resy": 8, "pixel_size": 0.2,
                      "motion": "circular", "distance": 10},
        "sensor": {"type": estimator, "scalex": 2.5, "scaley": 2.5,
                   "scalez": 1.2, "majorant": 2.0 * extinction,
                   "film": {"type": "vfilm", "resx": 16, "resy": 16,
                            "resz": 8}},
        "target": {"filename": box_hole_mesh, "size": 1.5},
        "output": "/tmp",
    }


class Losses:
    """Both packages' loss sum(render * w) of cfg's scene as a function of
    (sigma_t, albedo), and its gradients: jax.grad of the JAX render and
    torch.autograd.grad of the port's (static with medium_grads unless
    medium is False)."""

    def __init__(self, cfg, spp, medium=True, **build):
        build = dict(dict(max_depth=6, rr_depth=6), **build)
        js, ts = JScene(cfg), TScene(cfg)
        include = ts.sensor.surface_aware
        jst, self.jarr = js.build(mode="volume", include_target=include,
                                  **build)
        tst, tarr = ts.build(mode="volume", include_target=include, **build)
        self.jst = dataclasses.replace(jst, medium_grads=medium)
        self.tst = dataclasses.replace(tst, medium_grads=medium)
        self.ta = scene_tensors(tarr, "cpu")
        rng = np.random.default_rng(0)
        self.data = rng.uniform(0.5, 1.5, ts.projector.active_size()) \
            .astype(np.float32)
        self.w = rng.uniform(0.0, 1.0, ts.sensor.static.shape) \
            .astype(np.float32)
        self.inv_vol = np.float32(1.0 / ts.sensor.voxel_volume)
        self.spp = spp
        self.jgrad = jax.jit(jax.grad(self._jloss, argnums=(0, 1)))

    def _jloss(self, st, al, seed):
        arr2 = dict(self.jarr, sigma_t=st, albedo=al)
        return jnp.sum(j_render(self.jst, arr2, jnp.asarray(self.data),
                                self.inv_vol, seed=seed, spp=self.spp,
                                chunk=CHUNK) * self.w)

    def jax(self, st, al, seed=0):
        return [float(g) for g in self.jgrad(
            jnp.float32(st), jnp.float32(al), jnp.uint32(seed))]

    def port_loss(self, st, al, seed=0, data=None):
        ta = dict(self.ta, sigma_t=st.detach(), albedo=al.detach())
        d = torch.from_numpy(self.data) if data is None else data
        vol = tr.render(self.tst, ta, d, float(self.inv_vol), seed,
                        self.spp, self.spp, CHUNK, (st, al))
        return (vol * torch.from_numpy(self.w)).sum()

    def port(self, st, al, seed=0):
        st = torch.tensor(st, dtype=torch.float32, requires_grad=True)
        al = torch.tensor(al, dtype=torch.float32, requires_grad=True)
        g = torch.autograd.grad(self.port_loss(st, al, seed), (st, al))
        return [float(x) for x in g]


def _rel(a, b):
    return abs(a - b) / max(abs(b), 1e-12)


@pytest.mark.parametrize("estimator,albedo,spp,tol", [
    ("dda", 0.0, 1, 1e-4), ("dda", 0.5, 2, 1e-3), ("delta", 0.5, 2, 1e-3),
    ("ratio", 0.0, 2, 1e-3)])
def test_medium_gradients_match_jax(estimator, albedo, spp, tol,
                                    box_hole_mesh):
    L = Losses(_grads_cfg(box_hole_mesh, albedo, estimator), spp)
    gj, gt = L.jax(0.4, albedo), L.port(0.4, albedo)
    assert all(g != 0.0 for g in gj)
    for a, b in zip(gt, gj):
        assert _rel(a, b) < tol, (gt, gj)


def test_ratio_medium_gradients_agree_in_mean(box_hole_mesh):
    """Ratio tracking with scattering: the packages' random streams part
    after the first tracking segment, so the means of both gradients over
    8 seeds agree within 5 standard errors."""
    L = Losses(_grads_cfg(box_hole_mesh, 0.5, "ratio"), 2)
    gj = np.asarray([L.jax(0.4, 0.5, seed=s + 1) for s in range(8)])
    gt = np.asarray([L.port(0.4, 0.5, seed=s + 1) for s in range(8)])
    se = np.sqrt(gj.var(0, ddof=1) / 8 + gt.var(0, ddof=1) / 8)
    assert (np.abs(gj.mean(0) - gt.mean(0)) <= 5 * se).all(), (gj, gt)


def test_dda_sigma_t_matches_fd(box_hole_mesh):
    """Pure absorption, dda: the JAX test's strict bar (2e-4) on the
    port's render."""
    L = Losses(_grads_cfg(box_hole_mesh, 0.0, "dda"), 1)
    g = L.port(0.4, 0.0)[0]
    h = 1e-3
    with torch.no_grad():
        fd = float(L.port_loss(torch.tensor(0.4 + h), torch.tensor(0.0)) -
                   L.port_loss(torch.tensor(0.4 - h), torch.tensor(0.0))) \
            / (2 * h)
    assert _rel(g, fd) < 2e-4, (g, fd)


@pytest.mark.parametrize("estimator", ["dda", "ratio", "delta"])
def test_scattering_grads_match_fd(estimator, box_hole_mesh):
    """Scattering (albedo 0.5), spp 8: the sign of both gradients and their
    size against central differences at the JAX test's tolerances (the
    path-sampling term is not differentiated, as in the reference)."""
    L = Losses(_grads_cfg(box_hole_mesh, 0.5, estimator), 8)
    g_st, g_al = L.port(0.4, 0.5)
    h = 2e-3
    with torch.no_grad():
        f = lambda s, a: float(L.port_loss(torch.tensor(s),  # noqa: E731
                                           torch.tensor(a)))
        fd_st = (f(0.4 + h, 0.5) - f(0.4 - h, 0.5)) / (2 * h)
        fd_al = (f(0.4, 0.5 + h) - f(0.4, 0.5 - h)) / (2 * h)
    assert g_st != 0.0 and g_al != 0.0
    assert np.sign(g_st) == np.sign(fd_st) and np.sign(g_al) == np.sign(fd_al)
    tol = 1.2 if estimator == "delta" else 0.25
    assert abs(g_st - fd_st) <= tol * abs(fd_st), (g_st, fd_st)
    assert abs(g_al - fd_al) <= tol * abs(fd_al), (g_al, fd_al)


def test_medium_gradients_zero_without_medium_grads(box_hole_mesh):
    """Without medium_grads the medium is no input of the render: autograd
    finds no path to (sigma_t, albedo), the JAX package's zero."""
    L = Losses(_grads_cfg(box_hole_mesh, 0.0, "dda"), 1, medium=False)
    d = torch.from_numpy(L.data).requires_grad_(True)
    st = torch.tensor(0.4, requires_grad=True)
    al = torch.tensor(0.0, requires_grad=True)
    g = torch.autograd.grad(L.port_loss(st, al, data=d), (d, st, al),
                            allow_unused=True)
    assert float(g[0].abs().sum()) > 0.0 and g[1:] == (None, None)
    assert L.jax(0.4, 0.0)[0] == 0.0


def test_pattern_grads_unchanged_by_medium_grads(box_hole_mesh):
    """The pattern gradient of the medium adjoint is the plain adjoint's,
    bitwise, whether or not the medium takes gradients too."""
    cfg = _grads_cfg(box_hole_mesh, 0.5, "dda")
    grads = []
    for medium in (False, True):
        L = Losses(cfg, 2, medium=medium)
        d = torch.from_numpy(L.data).requires_grad_(True)
        st = torch.tensor(0.4, requires_grad=True)
        al = torch.tensor(0.5, requires_grad=True)
        loss = L.port_loss(st, al, data=d)
        grads.append(torch.autograd.grad(
            loss, (d, st, al) if medium else (d,))[0])
    assert torch.equal(grads[0], grads[1])


def test_medium_only_backward_forms_no_pattern_gradient(box_hole_mesh,
                                                       monkeypatch):
    """RenderRaw.backward with the patterns detached (optimize_medium's
    case; on the card wf_med alone) forms no pattern gradient,
    and its (d sigma_t, d albedo) are those of the backward that
    differentiates the patterns too, on the plain route, to 1e-6."""
    L = Losses(_grads_cfg(box_hole_mesh, 0.5, "dda"), 2)
    adjoint, seen = tr.adjoint, []

    def spy(*args, **kw):
        out = adjoint(*args, **kw)
        seen.append(out[0])
        return out

    monkeypatch.setattr(tr, "adjoint", spy)
    grads = {}
    for need in (False, True):
        d = torch.from_numpy(L.data).requires_grad_(need)
        st = torch.tensor(0.4, requires_grad=True)
        al = torch.tensor(0.5, requires_grad=True)
        loss = L.port_loss(st, al, data=d)
        grads[need] = torch.autograd.grad(
            loss, (d, st, al) if need else (st, al))[-2:]
    assert seen[0] is None
    assert seen[1] is not None and float(seen[1].abs().sum()) > 0.0
    for a, b in zip(grads[False], grads[True]):
        assert float(b) != 0.0 and _rel(float(a), float(b)) <= 1e-6


def test_residual_mode_with_medium_grads_raises(box_hole_mesh):
    st = TScene(_grads_cfg(box_hole_mesh, 0.5, "dda")).build(
        mode="volume", include_target=False)[0]
    check_supported(dataclasses.replace(st, medium_grads=True))
    with pytest.raises(NotImplementedError, match="item 21"):
        check_supported(dataclasses.replace(st, medium_grads=True,
                                            scattered_only=True))


MESH_SCENES = {
    "occlusion": lambda occ, vial: occlusion_config(occ, BSDFS["default"]),
    "custom_cuvette": lambda occ, vial: VIAL_SCENES["custom"](vial),
    "surface_aware_occlusion": lambda occ, vial: occlusion_config(
        occ, BSDFS["reflective"], surface_aware=True),
}


@pytest.mark.parametrize("scene", MESH_SCENES)
def test_mesh_scene_medium_gradients_match_jax(scene, occ_work, vial_work):
    """Scenes with mesh surfaces (the target forms' one-pass kernel on the
    card): an occlusion, a custom cuvette, a surface-aware target beside a
    reflective occlusion (two channels); dda, pure absorption."""
    L = Losses(MESH_SCENES[scene](occ_work, vial_work), 1, max_depth=8,
               rr_depth=4)
    st, al = float(L.ta["sigma_t"]), float(L.ta["albedo"])
    gj, gt = L.jax(st, al), L.port(st, al)
    for a, b in zip(gt, gj):
        assert _rel(a, b) < 1e-4, (gt, gj)


# ---- the driver ------------------------------------------------------------

ST_TRUE, ST_INIT = 0.12, 0.06


@pytest.fixture(scope="module")
def cal(tmp_path_factory):
    """tests/test_medium_calibration.py's setup: the dose recorded at the
    true extinction by the JAX render; returns a config maker."""
    tmp = tmp_path_factory.mktemp("cal")
    patterns = np.ones((12, 6, 16), np.float32)
    dose = str(tmp / "measured.npy")
    np.save(dose, np.zeros((9, 24, 24, 1), np.float32))
    scene = JScene(make_cfg(str(tmp), ST_TRUE, patterns, dose))
    static, arr = scene.build(mode="volume", include_target=False,
                              max_depth=6, rr_depth=6)
    np.save(dose, np.asarray(render_j(static, arr, scene)))

    def cfg(out, **kw):
        c = make_cfg(str(tmp / out), ST_INIT, patterns, dose)
        c["optimize_medium"] = {"lr": 0.015, "sigma_t": True}
        c.update(kw)
        os.makedirs(c["output"], exist_ok=True)
        return c
    return cfg


def render_j(static, arr, scene):
    return j_render(static, arr, jnp.asarray(scene.projector.active_data),
                    jnp.float32(1.0 / scene.sensor.voxel_volume), seed=0,
                    spp=2, chunk=CHUNK)


def _result(out):
    with open(os.path.join(out, "medium.json")) as f:
        med = json.load(f)
    return med, np.load(os.path.join(out, "loss.npy"))


@pytest.fixture(scope="module")
def runs(cal):
    """The uninterrupted 10-step calibration of each package."""
    out = {}
    for name, fn, kw in (("jax", j_optimize, {}),
                         ("port", t_optimize, {"device": "cpu"})):
        c = cal(name)
        fn(c, **kw)
        out[name] = _result(c["output"])
    return out


def test_calibration_matches_jax(runs):
    (mj, lj), (mt, lt) = runs["jax"], runs["port"]
    assert _rel(mt["sigma_t"], mj["sigma_t"]) < 1e-3, (mt, mj)
    assert mt["albedo"] == mj["albedo"] == 0.0
    np.testing.assert_allclose(lt, lj, rtol=1e-4)
    assert abs(mt["sigma_t"] - ST_TRUE) < 0.5 * abs(ST_INIT - ST_TRUE)


def test_progressive_calibration_matches_jax(cal):
    """progressive: depth 3 for steps 0-4, then 6, the medium kept across
    the change."""
    res = {}
    for name, fn, kw in (("jax", j_optimize, {}),
                         ("port", t_optimize, {"device": "cpu"})):
        c = cal(f"prog_{name}", progressive=True, n_steps=7)
        fn(c, **kw)
        res[name] = _result(c["output"])
    (mj, lj), (mt, lt) = res["jax"], res["port"]
    assert _rel(mt["sigma_t"], mj["sigma_t"]) < 1e-3
    np.testing.assert_allclose(lt, lj, rtol=1e-4)


def test_albedo_calibration_matches_jax(cal):
    """A scattering medium (albedo 0.5 recorded, 0.35 to start), the delta
    estimator, both components calibrated."""
    res = {}
    for name, fn, kw in (("jax", j_optimize, {}),
                         ("port", t_optimize, {"device": "cpu"})):
        c = cal(f"albedo_{name}", n_steps=4)
        c["vial"]["medium"].update(albedo=0.35, extinction=0.12,
                                   phase={"type": "rayleigh"})
        c["sensor"]["type"] = "delta"
        c["optimize_medium"] = {"lr": 0.02, "sigma_t": True, "albedo": True}
        fn(c, **kw)
        res[name] = _result(c["output"])
    (mj, lj), (mt, lt) = res["jax"], res["port"]
    assert mt["albedo"] != 0.35
    for k in ("sigma_t", "albedo"):
        assert _rel(mt[k], mj[k]) < 1e-3, (mt, mj)
    np.testing.assert_allclose(lt, lj, rtol=1e-3)


def _partial(run, cfg):
    c = dict(cfg, n_steps=4, checkpoint_every=4)
    run(c)
    return c["output"]


def _resume(run, cfg, src):
    shutil.copy(os.path.join(src, "checkpoint.npz"),
                os.path.join(cfg["output"], "checkpoint.npz"))
    run(dict(cfg, resume=True))
    return _result(cfg["output"])


PORT = lambda c: t_optimize(c, device="cpu")  # noqa: E731


def test_port_resume_matches_uninterrupted(cal, runs):
    src = _partial(PORT, cal("res_part"))
    with np.load(os.path.join(src, "checkpoint.npz")) as f:
        keys = sorted(k for k in f.files if k.startswith("med_"))
        assert f["med_leaf_0"].dtype == np.int32
        assert all(f[k].dtype == np.float32 for k in keys
                   if k not in ("med_n_leaves", "med_leaf_0"))
    assert keys == ["med_al", "med_leaf_0", "med_leaf_1", "med_leaf_2",
                    "med_leaf_3", "med_leaf_4", "med_n_leaves", "med_st"]
    med, loss = _resume(PORT, cal("res_port"), src)
    assert med == runs["port"][0]
    assert np.array_equal(loss, runs["port"][1])


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_checkpoints_resume_across_packages(writer, cal, runs):
    """A checkpoint with the med_* keys written by one package, resumed by
    the other, against the JAX package's uninterrupted run (loss 1e-4,
    medium 1e-4)."""
    write = j_optimize if writer == "jax" else PORT
    read = PORT if writer == "jax" else j_optimize
    src = _partial(write, cal(f"x_{writer}_part"))
    med, loss = _resume(read, cal(f"x_{writer}_res"), src)
    mj, lj = runs["jax"]
    assert _rel(med["sigma_t"], mj["sigma_t"]) < 1e-4
    np.testing.assert_allclose(loss, lj, rtol=1e-4)


def test_checkpoint_without_medium_resumes_from_the_config(cal):
    """A checkpoint without the med_* keys: the medium starts again from
    the config's, as the JAX package resumes it."""
    src = _partial(PORT, cal("nomed_part"))
    path = os.path.join(src, "checkpoint.npz")
    with np.load(path) as f:
        kept = {k: f[k] for k in f.files if not k.startswith("med_")}
    np.savez(path, **kept)
    res = {}
    for name, run in (("jax", j_optimize), ("port", PORT)):
        res[name] = _resume(run, cal(f"nomed_{name}"), src)
    assert _rel(res["port"][0]["sigma_t"], res["jax"][0]["sigma_t"]) < 1e-4
    np.testing.assert_allclose(res["port"][1], res["jax"][1], rtol=1e-4)


@pytest.mark.parametrize("engine", ["ballistic", "hybrid"])
def test_engines_that_precompute_the_medium_raise(engine, cal):
    with pytest.raises(ValueError, match="optimize_medium requires"):
        t_optimize(cal(f"eng_{engine}", engine=engine), device="cpu")


def test_applied_medium_renders_as_a_fresh_scene(box_hole_mesh):
    """After a calibration step writes the medium into the scene tensors,
    the next render is bitwise the render of a scene built at the new
    medium (no cache of the tensors' dict holds the old one)."""
    cfg = _grads_cfg(box_hole_mesh, 0.5, "ratio")
    sc = TScene(cfg)
    st, arr = sc.build(mode="volume", include_target=False)
    ta = scene_tensors(arr, "cpu")
    data = torch.from_numpy(np.random.default_rng(3).uniform(
        0.5, 1.5, st.projector.n_active).astype(np.float32))
    tr.render(st, ta, data, 1.0, 0, 2)
    med = _Medium({"lr": 0.05, "albedo": True}, sc.medium)
    med.step(torch.tensor(2.0), torch.tensor(-3.0))
    med.apply(ta)
    cfg2 = json.loads(json.dumps(cfg))
    cfg2["vial"]["medium"].update(extinction=med.sigma_t, albedo=med.albedo)
    st2, arr2 = TScene(cfg2).build(mode="volume", include_target=False)
    assert st2 == st
    assert torch.equal(tr.render(st, ta, data, 1.0, 1, 2),
                       tr.render(st2, scene_tensors(arr2, "cpu"), data, 1.0,
                                 1, 2))
