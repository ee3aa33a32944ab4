"""optimize()'s modes in the port (drtvam_tpu_torch/opt/optimize.py)
against the JAX package's (drtvam_tpu/opt/optimize.py), on the CPU:
the progressive depth schedule, Adam and SGD, the forward mode and
psf_analysis. Checkpoints and resume are tests/test_torch_resume.py's.

Tolerances, with their reasons:
  * progressive, hybrid and wavefront engines, both CLIs (7 steps, the
    switch to max_depth at step 5): the loss history to 1e-4, the
    wavefront's same-seed tolerance across packages
    (tests/test_torch_hybrid.py, tests/test_torch_optimize.py), and the
    same artifact set;
  * progressive on the ballistic engine: bitwise equal to the run
    without it (the ballistic engine has no depth);
  * Adam and SGD against optax, both CLIs: the loss history to 1e-4
    and the patterns to rtol 1e-4, atol 1e-4 of the max. The update
    rules are optax's float32 operations; the loss differs already at
    step 0, where both doses are 0, by 2.1e-5 (measured): a float32 sum
    of 32,000 voxel terms in another order, which a 1e-5 bound would
    not leave room for;
  * the forward mode: the optimizing run's final.npy bitwise in the
    port, the JAX CLI's --forward_mode to rtol 1e-5 and 1e-6 of the
    max (the plain backprojection against XLA's, tests/
    test_torch_ballistic.py);
  * psf_analysis: the same as the forward mode, and the lit pixels
    exactly.
"""
import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from drtvam_tpu.opt.optimize import main as jmain
from drtvam_tpu.opt.optimize import optimize as joptimize
from drtvam_tpu_torch.models.scene import Scene as TScene
from drtvam_tpu_torch.ops.mesh import make_box_with_hole, save_ply
from drtvam_tpu_torch.opt.device_lbfgs import DeviceLinearLBFGS
from drtvam_tpu_torch.opt.optimize import main as tmain
from drtvam_tpu_torch.opt.optimize import optimize as toptimize
from torch_threads import one_torch_thread  # noqa: F401
from torch_jax_native import jax_native_libraries  # noqa: F401

SAME_SEED_TOL = 1e-4


@pytest.fixture
def work(tmp_path):
    save_ply(make_box_with_hole((2.0, 2.0, 0.5), 1.0,
                                hole_center_xy=(-1.0, 0.0)),
             str(tmp_path / "box_hole.ply"))
    return tmp_path


def _config(work, out, albedo=0.0, **kw):
    """The verify recipe's scene, shrunk (30 angles, 48x12 DMD,
    40x40x20 film)."""
    cfg = {
        "vial": {"type": "cylindrical", "r_int": 7, "r_ext": 8, "ior": 1.54,
                 "medium": {"ior": 1.40, "phase": {"type": "rayleigh"},
                            "extinction": 0.1, "albedo": albedo}},
        "projector": {"type": "collimated", "n_patterns": 30, "resx": 48,
                      "resy": 12, "pixel_size": 0.104,
                      "motion": "circular", "distance": 20},
        "sensor": {"type": "dda", "scalex": 5, "scaley": 5, "scalez": 1.25,
                   "film": {"type": "vfilm", "resx": 40, "resy": 40,
                            "resz": 20}},
        "target": {"filename": str(work / "box_hole.ply"), "size": 4.0},
        "loss": {"type": "threshold", "tl": 0.85, "tu": 0.95},
        "n_steps": 3, "output": str(work / out)}
    cfg.update(kw)
    return cfg


def _write(work, cfg, name):
    path = work / name
    path.write_text(json.dumps(cfg))
    return str(path)


def _files(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


def _both_clis(work, make, extra=()):
    """Run both CLIs on make(out) -> config; returns the two outputs."""
    jmain([_write(work, make("jax"), "jax.json"), "--backend", "cpu",
           *extra])
    tmain([_write(work, make("torch"), "torch.json"), "--device", "cpu",
           *extra])
    j, t = work / "jax", work / "torch"
    assert _files(t) == _files(j)
    return j, t


# --------------------------------------------------------------------------
# progressive


@pytest.mark.parametrize("engine", ["hybrid", "wavefront"])
def test_progressive_clis_agree(work, engine, capsys):
    """A scattering scene (albedo 0.5: the depth cap matters) cut to
    tests/test_hybrid.py's size (16 angles, 24x8 DMD, 32x32x16 film,
    spp 1), 7 steps, depth 3 for steps 0-4, then max_depth 6: both CLIs
    print the same
    loss history; the port changed the engine's depth in place (one
    engine: the hybrid's unscattered fields built once)."""
    def make(out):
        cfg = _config(work, out, 0.5, engine=engine, n_steps=7, spp=1,
                      spp_ref=1, progressive=True)
        cfg["projector"].update(n_patterns=16, resx=24, resy=8,
                                pixel_size=5.0 / 24)
        cfg["sensor"]["film"].update(resx=32, resy=32, resz=16)
        return cfg

    j, t = _both_clis(work, make)
    lj, lt = np.load(j / "loss.npy"), np.load(t / "loss.npy")
    np.testing.assert_allclose(lt, lj, rtol=SAME_SEED_TOL)
    assert lt.shape == (7,) and lt[-1] < lt[0]
    out = capsys.readouterr().out
    assert out.count(f"{engine.capitalize()} engine on cpu") == 1


def test_set_depth_equals_a_fresh_engine(work):
    """The hybrid engine's set_max_depth: the residual at the new depth
    is bitwise a freshly built engine's (the unscattered fields and the
    chord bank kept), and differs from the old depth's."""
    from drtvam_tpu_torch.ops.hybrid import ScatteringEngine
    cfg = _config(work, "d", albedo=0.5)
    cfg["projector"].update(n_patterns=8, resx=24, resy=6,
                            pixel_size=0.208)
    cfg["sensor"]["film"].update(resx=20, resy=20, resz=10)
    sc = TScene(cfg)
    engines = {}
    for depth in (3, 6):
        static, arr = sc.build(mode="volume", include_target=False,
                               max_depth=depth)
        engines[depth] = ScatteringEngine(static, arr, "cpu", spp=2)
    data = torch.from_numpy(np.random.default_rng(1).uniform(
        0.0, 1.0, static.projector.n_active).astype(np.float32))
    with torch.no_grad():
        d3 = engines[3].render_vol(data, 1.0, 4)
        engines[3].set_max_depth(6)
        assert engines[3].static_s == engines[6].static_s
        d6 = engines[3].render_vol(data, 1.0, 4)
        torch.testing.assert_close(d6, engines[6].render_vol(data, 1.0, 4),
                                   rtol=0, atol=0)
    assert not torch.equal(d3, d6)


def test_progressive_ballistic_is_bitwise_the_plain_run(work):
    toptimize(_config(work, "p", progressive=True, n_steps=7), device="cpu")
    toptimize(_config(work, "n", n_steps=7), device="cpu")
    for f in ("loss.npy", "final.npy"):
        np.testing.assert_array_equal(np.load(work / "p" / f),
                                      np.load(work / "n" / f))
    with np.load(work / "p" / "patterns.npz") as a, \
            np.load(work / "n" / "patterns.npz") as b:
        np.testing.assert_array_equal(a["patterns"], b["patterns"])


def test_scene_arrays_do_not_depend_on_max_depth(work):
    """What the progressive schedule keeps: scene.build's arrays are
    the same at every depth, and its static differs only in max_depth
    (so the wavefront keeps its uploaded tensors, the hybrid engine its
    fields and chord bank)."""
    sc = TScene(_config(work, "b", albedo=0.5))
    for include_target in (False, True):
        s3, a3 = sc.build(mode="volume", include_target=include_target,
                          max_depth=3)
        s6, a6 = sc.build(mode="volume", include_target=include_target,
                          max_depth=6)
        assert dataclasses.replace(s3, max_depth=6) == s6
        assert sorted(a3) == sorted(a6)
        for k in a3:
            np.testing.assert_array_equal(a3[k], a6[k], err_msg=k)


def test_rebind_keeps_the_history():
    """rebind swaps the direction render and the line search's loss and
    keeps the pairs: after it a step is the step the unswapped
    optimizer takes, with the new closures (least squares ||A p - b||^2,
    whose residual is affine in p as the dose is linear)."""
    rng = np.random.default_rng(0)
    n = 64
    A = torch.from_numpy(rng.uniform(0.0, 1.0, (n, n)).astype(np.float32))
    b = torch.from_numpy(rng.uniform(0.0, 1.0, n).astype(np.float32))

    def dir_fn(z, seed):
        return A @ z

    def cand_fn(vol, dvol, alpha, z, seed):
        r = vol + alpha * dvol
        return torch.dot(r, r)

    def dir2(z, seed):
        return dir_fn(z, seed)

    def cand2(vol, dvol, alpha, z, seed):
        return cand_fn(vol, dvol, alpha, z, seed)

    opts = [DeviceLinearLBFGS(dir_fn, cand_fn),
            DeviceLinearLBFGS(dir_fn, cand_fn)]
    ps = [torch.zeros(n), torch.zeros(n)]
    for i in range(6):
        if i == 3:
            opts[1].rebind(dir2, cand2)
            assert opts[1]._dir_fn is dir2 and opts[1]._cand_fn is cand2
            assert opts[1].state_dict()["nvalid"] == \
                opts[0].state_dict()["nvalid"] > 0
        for k in range(2):
            r = A @ ps[k] - b   # the residual is the "dose"
            ps[k] = opts[k].step(ps[k], 2.0 * (A.T @ r), r,
                                 torch.dot(r, r), step_args=(i,))
    torch.testing.assert_close(ps[1], ps[0], rtol=0, atol=0)
    sd0, sd1 = opts[0].state_dict(), opts[1].state_dict()
    for k in sd0:
        np.testing.assert_array_equal(sd1[k], sd0[k], err_msg=k)


# --------------------------------------------------------------------------
# Adam and SGD


@pytest.mark.parametrize("optimizer", [
    {"type": "adam"},
    {"type": "adam", "lr": 0.05, "b1": 0.8, "eps_root": 1e-8,
     "nesterov": True},
    {"type": "sgd", "lr": 0.02},
    {"type": "sgd", "lr": 0.01, "momentum": 0.9, "nesterov": True},
], ids=["adam", "adam_options", "sgd", "sgd_momentum"])
def test_first_order_clis_agree_with_optax(work, optimizer):
    def make(out):
        return _config(work, out, optimizer=optimizer, n_steps=6)

    j, t = _both_clis(work, make)
    lj, lt = np.load(j / "loss.npy"), np.load(t / "loss.npy")
    np.testing.assert_allclose(lt, lj, rtol=SAME_SEED_TOL)
    assert lt[-1] < lt[0]
    with np.load(j / "patterns.npz") as a, np.load(t / "patterns.npz") as b:
        pj, pt = a["patterns"], b["patterns"]
    assert pt.min() >= 0.0
    np.testing.assert_allclose(pt, pj, rtol=1e-4, atol=1e-4 * pj.max())


def test_unknown_first_order_key_raises(work):
    cfg = _config(work, "bad", optimizer={"type": "adam", "beta1": 0.8})
    with pytest.raises(ValueError, match="beta1"):
        toptimize(cfg, device="cpu")


# --------------------------------------------------------------------------
# the forward mode and psf_analysis


def test_forward_mode_reproduces_the_final_dose(work):
    """Both CLIs' --forward_mode on the port's optimized patterns: the
    port's final.npy is bitwise the optimizing run's, the JAX CLI's
    agrees to the engines' tolerance; the full artifact set, with zero
    loss and timing."""
    tmain([_write(work, _config(work, "opt"), "opt.json"), "--device",
           "cpu"])
    pats = str(work / "opt" / "patterns.npz")
    j, t = _both_clis(work, lambda out: _config(work, out),
                      ["--forward_mode", "--patterns", pats])
    assert _files(t) == _files(work / "opt")
    ft = np.load(t / "final.npy")
    np.testing.assert_array_equal(ft, np.load(work / "opt" / "final.npy"))
    fj = np.load(j / "final.npy")
    np.testing.assert_allclose(ft, fj, rtol=1e-5, atol=1e-6 * fj.max())
    assert not np.load(t / "loss.npy").any()
    assert not np.load(t / "timing.npy").any()
    with np.load(pats) as a, np.load(t / "patterns.npz") as b:
        np.testing.assert_array_equal(b["patterns"], a["patterns"])


def test_forward_mode_checks_the_pattern_count(work):
    cfg = _config(work, "fw")
    with pytest.raises(ValueError, match="patterns have shape"):
        toptimize(cfg, patterns_fwd=np.zeros((29, 12, 48), np.float32),
                  device="cpu")
    assert not (work / "fw").exists()
    with pytest.raises(ValueError, match="--patterns"):
        tmain([_write(work, cfg, "fw.json"), "--device", "cpu",
               "--forward_mode"])


def _psf_config(mesh_path, out, **extra):
    """tests/test_modes.py's config."""
    cfg = {
        "vial": {"type": "index_matched", "r": 2.9,
                 "medium": {"ior": 1.347, "phase": {"type": "rayleigh"},
                            "extinction": 0.03, "albedo": 0.0}},
        "projector": {"type": "collimated", "n_patterns": 40, "resx": 48,
                      "resy": 12, "pixel_size": 0.1, "motion": "circular",
                      "distance": 20},
        "sensor": {"type": "dda", "scalex": 5, "scaley": 5, "scalez": 1.25,
                   "film": {"type": "vfilm", "resx": 48, "resy": 48,
                            "resz": 24}},
        "target": {"filename": mesh_path, "size": 4.0},
        "loss": {"type": "threshold", "tl": 0.85, "tu": 0.95},
        "n_steps": 6, "output": out}
    cfg.update(extra)
    return cfg


PSF = [{"x": 10, "y": 3, "index_pattern": 0, "intensity": 1.0},
       {"x": 30, "y": 9, "index_pattern": 5, "intensity": 2.0}]


def test_psf_analysis_agrees_with_jax(box_hole_mesh, tmp_path):
    """tests/test_modes.py's two pixels through both packages: the same
    shorter artifact set, the same lit pixels, the same dose; which
    equals the forward mode's on a pattern stack holding just those
    pixels."""
    outs = {k: str(tmp_path / k) for k in ("jax", "torch", "fwd")}
    vj = joptimize(_psf_config(box_hole_mesh, outs["jax"],
                               psf_analysis=PSF))
    vt = toptimize(_psf_config(box_hole_mesh, outs["torch"],
                               psf_analysis=PSF), device="cpu")
    assert _files(outs["torch"]) == _files(outs["jax"])
    assert "histogram.png" not in _files(outs["torch"])
    np.testing.assert_allclose(vt, vj, rtol=1e-5, atol=1e-6 * vj.max())
    with np.load(os.path.join(outs["torch"], "patterns.npz")) as f:
        pats = f["patterns"]
    lit = np.nonzero(pats)
    assert set(zip(*lit)) == {(0, 3, 10), (5, 9, 30)}
    np.testing.assert_allclose(sorted(pats[lit]), [1.0, 2.0])
    vf = toptimize(_psf_config(box_hole_mesh, outs["fwd"]),
                   patterns_fwd=pats, device="cpu")
    np.testing.assert_array_equal(vf, vt)


def test_psf_analysis_rejects_out_of_range(box_hole_mesh, tmp_path):
    for entry, match in (({"x": 48, "y": 0}, "outside"),
                         ({"x": 0, "y": 12}, "outside"),
                         ({"x": -1, "y": 0}, "outside"),
                         ({"x": 0, "y": 0, "index_pattern": 40},
                          "n_patterns")):
        e = {"index_pattern": 0, "intensity": 1.0, **entry}
        cfg = _psf_config(box_hole_mesh, str(tmp_path / "o"),
                          psf_analysis=[e])
        with pytest.raises(ValueError, match=match):
            toptimize(cfg, device="cpu")
        if entry["x"] >= 0:   # the JAX package checks only the top end
            with pytest.raises(ValueError, match=match):
                joptimize(cfg)
