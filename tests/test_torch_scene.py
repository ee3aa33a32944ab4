"""drtvam_tpu_torch scene assembly == the JAX package's: the same static
description and bit-identical arrays from Scene.build, and a
bit-identical target occupancy (both run the same host C++)."""
import json
import os

import numpy as np
import pytest

from drtvam_tpu.models.scene import Scene as JScene
from drtvam_tpu.ops.mesh import make_box, save_ply
from drtvam_tpu_torch.convert import scene_from_jax
from drtvam_tpu_torch.models.scene import Scene as TScene

from test_ballistic import VIALS
from torch_jax_native import jax_native_libraries  # noqa: F401

EXAMPLES = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "examples")


def _example(name):
    with open(os.path.join(EXAMPLES, name + ".json")) as f:
        cfg = json.load(f)

    def resolve(p):
        return os.path.join(EXAMPLES, p)
    return cfg, resolve, {}


def _vial(name, tmp_path):
    path = str(tmp_path / "t.ply")
    save_ply(make_box((0.5, 0.5, 0.5)), path)
    cfg = {
        "vial": VIALS[name],
        "projector": {"type": "collimated", "n_patterns": 23, "resx": 40,
                      "resy": 16, "pixel_size": 0.1231,
                      "motion": "circular", "distance": 20},
        "sensor": {"type": "dda", "scalex": 5.07, "scaley": 5.07,
                   "scalez": 1.29,
                   "film": {"type": "vfilm", "resx": 40, "resy": 36,
                            "resz": 20}},
        "target": {"filename": path, "size": 4.0},
        "output": str(tmp_path),
    }
    return cfg, (lambda p: p), dict(max_depth=10, rr_depth=32,
                                    regular_sampling=True)


CASES = ["example:cylindrical", "example:square", "example:index_matched"] + \
    [f"vial:{v}" for v in VIALS]


@pytest.mark.parametrize("case", CASES)
def test_scene_matches_jax(case, tmp_path):
    kind, name = case.split(":")
    cfg, resolve, kw = _example(name) if kind == "example" else \
        _vial(name, tmp_path)
    js, ts = JScene(cfg, resolve), TScene(cfg, resolve)
    jstatic, jarr = js.build(mode="volume", **kw)
    tstatic, tarr = ts.build(mode="volume", **kw)

    conv_static, conv_arr = scene_from_jax(jstatic, jarr)
    assert tstatic == conv_static
    assert sorted(tarr) == sorted(conv_arr)
    for k in tarr:
        a, b = np.asarray(tarr[k]), conv_arr[k]
        assert a.dtype == b.dtype and a.shape == b.shape, k
        np.testing.assert_array_equal(a, b, err_msg=k)

    # the film's resx -> Y, resy -> X quirk, and the occupancy
    assert ts.sensor.static.res == js.sensor.static.res
    occ_t = ts.sensor.discretize(ts.target_bank())
    occ_j = np.asarray(js.sensor.discretize(js.target_bank()))
    assert occ_t.shape == occ_j.shape == ts.sensor.static.shape
    assert occ_t.sum() > 0
    np.testing.assert_array_equal(occ_t, occ_j)


def test_mesh_vial_and_occlusions_raise(tmp_path):
    """Mesh vials and occlusions are ported: what raises is what raises
    in the JAX package, a custom vial without its wall meshes and an
    occlusion BSDF it does not know (ValueError, at scene build)."""
    cfg, resolve, _ = _vial("cylindrical", tmp_path)
    occluded = dict(cfg, vial=dict(cfg["vial"], occlusions=[
        {"filename": cfg["target"]["filename"],
         "bsdf": {"type": "conductor"}}]))
    custom = dict(cfg, vial=dict(cfg["vial"], type="custom"))
    for scene_cls in (TScene, JScene):
        with pytest.raises(ValueError, match="unsupported occlusion BSDF"):
            scene_cls(occluded, resolve).build()
        with pytest.raises(ValueError, match="filename_vial_outer"):
            scene_cls(custom, resolve).build()


def test_set_active_checks_before_changing_state(tmp_path):
    cfg, resolve, _ = _vial("square", tmp_path)
    proj = TScene(cfg, resolve).projector
    before = proj.active_pixels.copy()
    with pytest.raises(ValueError):
        proj.set_active(np.arange(5), np.zeros(4, np.float32))
    np.testing.assert_array_equal(proj.active_pixels, before)
    assert proj.dense_identity
