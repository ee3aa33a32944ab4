"""Both CLIs on a shrunk copy of the verify recipe's config (40x40x20
film, 3 steps): the same artifact set, final.npy to rtol 1e-3 and the
same best IoU to 1e-3, through the ballistic engine and through the
wavefront path tracer (engine 'wavefront', the loss history to 1e-4:
both render the same realization at each step's seed, measured 2.1e-5).
optimize()'s other modes are tests/test_torch_modes.py's, `profile`
tests/test_torch_profile.py's, medium calibration
tests/test_torch_medium.py's."""
import json
import os

import numpy as np
import pytest
import torch

from drtvam_tpu.opt.optimize import main as jmain
from drtvam_tpu_torch.ops.mesh import make_box_with_hole, save_ply
from drtvam_tpu_torch.opt.optimize import main as tmain
from drtvam_tpu_torch.utils.metrics import best_iou
from torch_jax_native import jax_native_libraries  # noqa: F401


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: the plain wavefront's many small ops gain
    nothing from more, and the suite runs several workers on one host,
    where spinning thread pools slow every worker down."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _config(work, out):
    return {
        "vial": {"type": "cylindrical", "r_int": 7, "r_ext": 8, "ior": 1.54,
                 "medium": {"ior": 1.40, "phase": {"type": "rayleigh"},
                            "extinction": 0.1, "albedo": 0.0}},
        "projector": {"type": "collimated", "n_patterns": 30, "resx": 48,
                      "resy": 12, "pixel_size": 0.104,
                      "motion": "circular", "distance": 20},
        "sensor": {"type": "dda", "scalex": 5, "scaley": 5, "scalez": 1.25,
                   "film": {"type": "vfilm", "resx": 40, "resy": 40,
                            "resz": 20}},
        "target": {"filename": "box_hole.ply", "size": 4.0},
        "loss": {"type": "threshold", "tl": 0.85, "tu": 0.95},
        "n_steps": 3, "output": str(work / out)}


def _write(work, cfg, name):
    path = work / name
    path.write_text(json.dumps(cfg))
    return str(path)


@pytest.fixture
def work(tmp_path):
    save_ply(make_box_with_hole((2.0, 2.0, 0.5), 1.0,
                                hole_center_xy=(-1.0, 0.0)),
             str(tmp_path / "box_hole.ply"))
    return tmp_path


def _files(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


def test_clis_agree(work):
    jmain([_write(work, _config(work, "jax"), "jax.json"),
           "--backend", "cpu"])
    tmain([_write(work, _config(work, "torch"), "torch.json"),
           "--device", "cpu"])
    j, t = work / "jax", work / "torch"
    assert _files(t) == _files(j)
    # the target first: a reference that voxelized it another way names
    # itself here, not as a dose that disagrees
    np.testing.assert_array_equal(np.load(t / "target.npy"),
                                  np.load(j / "target.npy"))
    fj, ft = np.load(j / "final.npy"), np.load(t / "final.npy")
    assert ft.shape == fj.shape == (20, 40, 40, 1)
    np.testing.assert_allclose(ft, fj, rtol=1e-3, atol=1e-3 * fj.max())
    np.testing.assert_allclose(np.load(t / "loss.npy"),
                               np.load(j / "loss.npy"), rtol=1e-3)
    iou_j = best_iou(fj, np.load(j / "target.npy"))[0]
    iou_t = best_iou(ft, np.load(t / "target.npy"))[0]
    assert abs(iou_t - iou_j) <= 1e-3
    assert json.loads((t / "opt_config.json").read_text())["n_steps"] == 3


def test_overrides_reach_the_config(work):
    cfg = _config(work, "ovr")
    tmain([_write(work, cfg, "ovr.json"), "--device", "cpu",
           "-D", "n_steps=2", "-D", "loss.tl=0.8"])
    saved = json.loads((work / "ovr" / "opt_config.json").read_text())
    assert saved["n_steps"] == 2 and saved["loss"]["tl"] == 0.8
    assert np.load(work / "ovr" / "loss.npy").shape == (2,)


def _wavefront_config(work, out):
    cfg = _config(work, out)
    cfg.update(engine="wavefront", spp=2, spp_ref=2)
    return cfg


def test_wavefront_clis_agree(work):
    jmain([_write(work, _wavefront_config(work, "wj"), "wj.json"),
           "--backend", "cpu"])
    tmain([_write(work, _wavefront_config(work, "wt"), "wt.json"),
           "--device", "cpu"])
    j, t = work / "wj", work / "wt"
    assert _files(t) == _files(j)
    np.testing.assert_allclose(np.load(t / "loss.npy"),
                               np.load(j / "loss.npy"), rtol=1e-4)
    fj, ft = np.load(j / "final.npy"), np.load(t / "final.npy")
    assert ft.shape == fj.shape == (20, 40, 40, 1)
    np.testing.assert_allclose(ft, fj, rtol=1e-3, atol=1e-3 * fj.max())
    loss = np.load(t / "loss.npy")
    assert loss[-1] < loss[0]


def test_auto_runs_the_wavefront_on_a_telecentric_scene(work, capsys):
    cfg = _config(work, "tele")
    cfg["projector"].update(type="telecentric", aperture_radius=0.05,
                            focus_distance=20.0)
    cfg.update(spp=1, spp_ref=1)
    tmain([_write(work, cfg, "tele.json"), "--device", "cpu"])
    assert "Wavefront engine on cpu" in capsys.readouterr().out
    out = work / "tele"
    assert (out / "final.npy").exists() and (out / "histogram.png").exists()
    loss = np.load(out / "loss.npy")
    assert np.isfinite(loss).all() and loss[-1] < loss[0]


def test_medium_optimization_on_the_hybrid_engine_raises(work):
    """The hybrid engine bakes the medium into its transport fields, so
    medium optimization with it raises a ValueError, as in the JAX
    package."""
    cfg = _config(work, "hy")
    cfg["vial"]["medium"]["albedo"] = 0.5
    cfg.update(engine="hybrid", optimize_medium=True)
    with pytest.raises(ValueError, match="optimize_medium"):
        tmain([_write(work, cfg, "hy.json"), "--device", "cpu"])
