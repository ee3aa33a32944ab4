"""Occlusions on the port's wavefront (plain version, CPU) against the JAX
package at the same seed, on tests/test_occlusion_bsdf.py's scene (a
cylindrical vial, 16 angles of 24x10, a 24x24x12 film, a box occlusion
with half-extents (0.8, 0.5, 0.3), the medium on its outside).

Each occlusion BSDF (none, null, black by default and explicit,
reflective diffuse with and without transmission_only, dielectric) is
parsed by each package's own Scene, the static descriptions must be
equal and the scene arrays bitwise, and the port's dose and pattern
gradient must agree with the JAX package's to 1e-4 of the largest
|value| (SAME_SEED_TOL of tests/test_torch_wavefront.py: both trace the
same float32 paths, XLA's and torch's transcendentals an ulp apart),
with the totals to 1e-5. The same holds for an occlusion walked through
its uniform grid (make_hollow_gear, 960 triangles past GRID_MIN_TRIS)
and for an occlusion beside a surface-aware target (two channels, per
channel). The JAX test's own properties (null passes through, the
default is black, a reflective occlusion adds dose only without
transmission_only, glass transmits) are checked on the port's doses.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from drtvam_tpu.ops.render import _adjoint as j_adjoint
from drtvam_tpu.ops.render import render as j_render
from drtvam_tpu_torch.models.scene import Scene as TScene
from drtvam_tpu_torch.ops import render as tr
from drtvam_tpu_torch.ops.mesh import make_box, make_hollow_gear, save_ply
from test_torch_custom_vial import _inputs, _same_scene
from torch_jax_native import jax_native_libraries  # noqa: F401
from torch_threads import one_torch_thread  # noqa: F401

TOL = 1e-4
SEED, SPP = 3, 1
CHUNK = 1 << 15

BSDFS = {
    "none": None,
    "null": {"bsdf": {"type": "null"}},
    "default": {},
    "black": {"bsdf": {"type": "diffuse",
                       "reflectance": {"type": "spectrum", "value": 0.0}}},
    "reflective": {"bsdf": {"type": "diffuse", "reflectance": 0.8}},
    "dielectric": {"bsdf": {"type": "dielectric", "int_ior": "bk7",
                            "ext_ior": 1.40}},
}


@pytest.fixture(scope="module")
def work(tmp_path_factory):
    path = tmp_path_factory.mktemp("occ")
    save_ply(make_box((0.8, 0.8, 0.4)), str(path / "tgt.ply"))
    save_ply(make_box((0.8, 0.5, 0.3)), str(path / "occ.ply"))
    save_ply(make_hollow_gear(r_out=0.9, r_root=0.7, r_hole=0.3,
                              half_height=0.3, segments=120),
             str(path / "gear.ply"))
    return path


def _config(work, occlusion, albedo=0.0, mesh="occ.ply",
            surface_aware=False):
    vial = {"type": "cylindrical", "r_int": 7, "r_ext": 8, "ior": 1.54,
            "medium": {"ior": 1.40, "phase": {"type": "rayleigh"},
                       "extinction": 0.12, "albedo": albedo}}
    if occlusion is not None:
        vial["occlusions"] = [dict({"filename": str(work / mesh)},
                                   **occlusion)]
    cfg = {
        "vial": vial,
        "projector": {"type": "collimated", "n_patterns": 16, "resx": 24,
                      "resy": 10, "pixel_size": 0.25,
                      "motion": "circular", "distance": 20},
        "sensor": {"type": "dda", "scalex": 5, "scaley": 5,
                   "scalez": 1.25,
                   "film": {"type": "vfilm", "resx": 24, "resy": 24,
                            "resz": 12}},
        "target": {"filename": str(work / "tgt.ply"), "size": 3.0},
        "output": str(work),
    }
    if surface_aware:
        cfg["final_sensor"] = json.loads(json.dumps(cfg["sensor"]))
        cfg["sensor"]["film"]["surface_aware"] = True
    return cfg


def _within(port, ref, channels=1):
    """TOL of each channel's largest |value|; totals to 1e-5."""
    assert port.shape == ref.shape and np.isfinite(port).all()
    p, r = port.reshape(-1, channels), ref.reshape(-1, channels)
    for c in range(channels):
        scale = float(np.abs(r[:, c]).max())
        assert scale > 0.0
        off = np.abs(p[:, c] - r[:, c]) > TOL * scale
        assert not off.any(), (c, int(off.sum()))
        np.testing.assert_allclose(p[:, c].sum(dtype=np.float64),
                                   r[:, c].sum(dtype=np.float64), rtol=1e-5)


def _render_both(jst, jarr, tst, ta, data, dL=None):
    """(port dose, JAX dose[, port gradient, JAX gradient]) of the raw
    accumulators (inv_vol 1)."""
    vj = np.asarray(jax.jit(lambda d: j_render(
        jst, jarr, d, 1.0, seed=SEED, spp=SPP, chunk=CHUNK))(
            jnp.asarray(data)))
    vt = tr.render(tst, ta, torch.from_numpy(data), 1.0, seed=SEED,
                   spp=SPP).numpy()
    if dL is None:
        return vt, vj
    gj = np.asarray(jax.jit(lambda dl: j_adjoint(
        jst, jarr, jnp.uint32(SEED), SPP, CHUNK, dl)[0])(jnp.asarray(dL)))
    gt = tr.adjoint(tst, ta, SEED, SPP, tr.DEFAULT_CHUNK,
                    torch.from_numpy(dL)).numpy()
    return vt, vj, gt, gj


@pytest.fixture(scope="module")
def doses(work):
    """The port's dose of each (BSDF, transmission_only) the cases read,
    each held to the JAX package's at the same seed as it is made (the
    patterns at 1, as tests/test_occlusion_bsdf.py renders)."""
    out = {}

    def dose(name, tonly=True):
        key = (name, tonly)
        if key not in out:
            jst, jarr, tst, ta = _same_scene(
                _config(work, BSDFS[name]), max_depth=12, rr_depth=12,
                transmission_only=tonly)
            data = np.ones(tst.projector.n_active, np.float32)
            vt, vj = _render_both(jst, jarr, tst, ta, data)
            _within(vt, vj)
            out[key] = vt.reshape(tst.sensor.shape)
        return out[key]
    return dose


def test_null_occlusion_passthrough(doses):
    """No dose inside a null occlusion; every voxel lit without it and
    outside its box and a one-voxel shell stays lit behind it."""
    d_none, d_null = doses("none")[..., 0], doses("null")[..., 0]
    xs = (np.arange(24) + 0.5) / 24 * 5.0 - 2.5
    zs = (np.arange(12) + 0.5) / 12 * 1.25 - 0.625
    Zc, Yc, Xc = np.meshgrid(zs, xs, xs, indexing="ij")
    vox = np.array([5.0 / 24, 5.0 / 24, 1.25 / 12])

    def box(m):
        return ((np.abs(Xc) < 0.8 + m * vox[0]) &
                (np.abs(Yc) < 0.5 + m * vox[1]) &
                (np.abs(Zc) < 0.3 + m * vox[2]))
    inside = box(-1)
    assert inside.sum() > 4
    np.testing.assert_array_equal(d_null[inside], 0.0)
    lit = (d_none > 1e-6) & ~box(1)
    assert lit.sum() > 100
    assert (d_null[lit] > 1e-6).all()


def test_black_diffuse_default_absorbs(doses):
    np.testing.assert_array_equal(doses("default"), doses("black"))
    assert doses("default").sum() < doses("none").sum()


def test_reflective_diffuse_adds_dose(doses):
    """Without transmission_only a reflectance-0.8 occlusion reflects
    into the medium; under it the occlusion absorbs, as the black one."""
    assert doses("reflective", False).sum() > \
        doses("default", False).sum() * 1.001
    np.testing.assert_array_equal(doses("reflective"), doses("default"))


def test_dielectric_occlusion_transmits(doses):
    assert doses("dielectric").sum() > doses("default").sum() * 1.001


def test_unknown_bsdf_raises(work):
    cfg = _config(work, {"bsdf": {"type": "conductor"}})
    with pytest.raises(ValueError, match="unsupported occlusion BSDF"):
        TScene(cfg).build()


@pytest.mark.parametrize("name,tonly,albedo", [
    ("default", True, 0.0), ("reflective", False, 0.0),
    ("dielectric", False, 0.0), ("null", True, 0.5)])
def test_pattern_gradient_matches_jax(name, tonly, albedo, work):
    """The adjoint replays the port's paths: the pattern gradient (and the
    dose) at seeded patterns to TOL of the JAX package's; with albedo 0.5
    the lanes scatter through a null occlusion."""
    jst, jarr, tst, ta = _same_scene(
        _config(work, BSDFS[name], albedo=albedo), max_depth=8, rr_depth=8,
        transmission_only=tonly)
    data, dL = _inputs(tst, 5)
    vt, vj, gt, gj = _render_both(jst, jarr, tst, ta, data, dL)
    _within(vt, vj)
    _within(gt, gj)


def test_grid_walked_occlusion_matches_jax(work):
    """A hollow gear occlusion of 960 triangles: its uniform grid in the
    scene arrays (bitwise) and walked by both marches."""
    jst, jarr, tst, ta = _same_scene(
        _config(work, {"bsdf": {"type": "dielectric"}}, mesh="gear.ply"),
        max_depth=8, rr_depth=8, transmission_only=True)
    occ = [s for s in tst.surfaces if s.medium_side == 2]
    assert len(occ) == 1 and occ[0].grid is not None
    assert occ[0].tri_slice[1] == 960
    data, dL = _inputs(tst, 6)
    vt, vj, gt, gj = _render_both(jst, jarr, tst, ta, data, dL)
    _within(vt, vj)
    _within(gt, gj)


def test_occlusion_with_surface_aware_target_matches_jax(work):
    """An occlusion beside the kept target on a two-channel film: the
    lanes' inside flag flips at the target only; each channel to TOL."""
    jst, jarr, tst, ta = _same_scene(
        _config(work, BSDFS["null"], surface_aware=True), max_depth=8,
        rr_depth=8, transmission_only=True)
    assert tst.sensor.channels == 2
    assert [s.is_target for s in tst.surfaces].count(True) == 1
    data, dL = _inputs(tst, 7)
    vt, vj, gt, gj = _render_both(jst, jarr, tst, ta, data, dL)
    _within(vt, vj, 2)
    _within(gt, gj)
    assert (vt.reshape(-1, 2).sum(0) > 0).all()
