"""The wavefront kernels' launch order (ops/render.py `angle_groups`,
`block_order`, `home_slices`), on the CPU.

`block_order` must be a permutation of the active indices, sorted by
(DMD row, angle, pixel) and cut into one range per (row, angle group)
CTA, for the identity store (whose order the kernels compute
arithmetically) and for sparse stores (whose order the wrapper builds
once per scene and caches with the scene tensors). `home_slices` must
name the film z-slice where a collimated row's rays deposit: the z
voxel of each lane's ray from the port's plain `sample_rays`, and of
every voxel of one row's dose as the JAX package's `render` gives it,
at regular sampling. All of it is exact: integer maps.
"""
import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from drtvam_tpu.models.scene import Scene as JScene
from drtvam_tpu.ops.mesh import make_box, save_ply
from drtvam_tpu.ops.render import render as j_render
from drtvam_tpu_torch.convert import scene_from_jax
from drtvam_tpu_torch.core.rng import Sampler
from drtvam_tpu_torch.models.scene import Scene as TScene
from drtvam_tpu_torch.models.projector import ProjectorStatic, sample_rays
from drtvam_tpu_torch.ops import render as wf
from drtvam_tpu_torch.ops.march import _grid, scene_tensors

from torch_threads import one_torch_thread  # noqa: F401
from torch_jax_native import jax_native_libraries  # noqa: F401


@pytest.fixture(scope="module")
def target_path(tmp_path_factory):
    path = tmp_path_factory.mktemp("wf_order") / "t.ply"
    save_ply(make_box((0.5, 0.5, 0.5)), str(path))
    return str(path)


def test_angle_groups_cover_every_angle_evenly():
    assert wf.angle_groups(400) == (16, 25)  # the bench scene
    for a in range(1, 1001):
        n_groups, group = wf.angle_groups(a)
        assert group <= wf.ANGLES_PER_GROUP
        assert n_groups * group >= a > (n_groups - 1) * group
        assert n_groups == -(-a // wf.ANGLES_PER_GROUP)


def _store(kind, A=30, h=7, w=45):
    """A synthetic scene of one pattern store: (static, arr)."""
    n = A * h * w
    rng = np.random.default_rng(2)
    if kind == "identity":
        pix = np.arange(n)
    elif kind == "subset":  # 40 % of the pixels in random order
        pix = rng.permutation(n)[:2 * n // 5]
    elif kind == "repeats":  # pixels drawn with repeats
        pix = rng.integers(0, n, n // 3)
    else:  # a cropped window: rows 2..5, columns 10..39, every angle
        a, y, x = np.meshgrid(np.arange(A), np.arange(2, 6),
                              np.arange(10, 40), indexing="ij")
        pix = ((a * h + y) * w + x).ravel()
    proj = ProjectorStatic("collimated", A, w, h, pix.size,
                           identity=kind == "identity")
    arr = {"active_pixels": torch.from_numpy(pix.astype(np.int32))}
    return types.SimpleNamespace(projector=proj), arr


@pytest.mark.parametrize("kind", ["identity", "subset", "repeats", "crop"])
def test_block_order_is_a_permutation_grouped_by_row_and_angle(kind):
    static, arr = _store(kind)
    p = static.projector
    A, h, w = p.n_patterns, p.resy, p.resx
    n_groups, group = wf.angle_groups(A)
    order, starts = wf.block_order(static, arr)
    assert torch.equal(torch.sort(order).values, torch.arange(p.n_active))
    idx = arr["active_pixels"].to(torch.int64)[order]
    a, py, px = idx // (h * w), idx % (h * w) // w, idx % w
    key = (py * A + a) * w + px
    assert bool((key[1:] >= key[:-1]).all())
    assert starts.shape == (h * n_groups + 1,)
    assert int(starts[0]) == 0 and int(starts[-1]) == p.n_active
    assert bool((starts[1:] >= starts[:-1]).all())
    block = torch.repeat_interleave(torch.arange(h * n_groups),
                                    starts[1:] - starts[:-1])
    assert torch.equal(py, block // n_groups)
    assert torch.equal(a // group, block % n_groups)
    if kind == "identity":
        # the arithmetic order (the kernels') equals the sorted one
        sparse = types.SimpleNamespace(projector=ProjectorStatic(
            "collimated", A, w, h, p.n_active, identity=False))
        o2, s2 = wf.block_order(sparse, arr)
        assert torch.equal(order, o2) and torch.equal(starts, s2)


# the template test's scenes (tests/test_torch_wf_template.py), each
# collimated ray horizontal and staying so through the walls
VIALS = {
    "cylindrical": {"type": "cylindrical", "r_ext": 8.385, "r_int": 7.665,
                    "height": 20.0, "ior": 1.514},
    "square": {"type": "square", "w_int": 12.0, "w_ext": 14.0, "ior": 1.24},
    "double_cylindrical": {
        "type": "double_cylindrical", "r_ext_outer": 8.3, "r_int_outer": 7.9,
        "r_ext_inner": 3.0, "r_int_inner": 2.6, "ior_outer": 1.54,
        "ior_inner": 1.52, "ior_inside_inner": 1.40}}


def _config(target_path, vial, film=20, scale=16.77):
    return {"vial": dict(VIALS[vial], medium={
                "ior": 1.4849, "extinction": 0.1, "albedo": 0.0}),
            "projector": {"type": "collimated", "n_patterns": 6, "resx": 16,
                          "resy": 12, "pixel_size": 16.77 / 16,
                          "motion": "circular", "distance": 25.0},
            "sensor": {"type": "dda", "scalex": scale, "scaley": scale,
                       "scalez": scale,
                       "film": {"type": "vfilm", "resx": film,
                                "resy": film, "resz": film}},
            "target": {"filename": target_path, "size": 4.0}, "output": "."}


def _jax_scene(target_path, vial, tonly):
    sc = JScene(_config(target_path, vial))
    static, arr = sc.build(mode="volume", include_target=False, max_depth=8,
                           rr_depth=3, transmission_only=tonly,
                           regular_sampling=True)
    return sc, static, arr


@pytest.mark.parametrize("vial,tonly", [("cylindrical", True),
                                        ("square", False),
                                        ("double_cylindrical", False)])
def test_home_slice_is_where_a_collimated_row_deposits(vial, tonly,
                                                       target_path):
    sc, j_static, j_arr = _jax_scene(target_path, vial, tonly)
    static, arr = scene_from_jax(j_static, j_arr)
    at = scene_tensors(arr, "cpu")
    p = static.projector
    h, w = p.resy, p.resx
    home = wf.home_slices(static, at)
    assert bool((home >= 0).all())
    assert len(set(home.tolist())) > 1

    # the port's plain rays: horizontal, in the home slice of their row
    lane = torch.arange(p.n_active, dtype=torch.int64)
    sampler = Sampler(5)
    o, d, aidx, _ = sample_rays(p, at, at["active_pixels"], lane, 1, sampler,
                                sampler.init(p.n_active, "cpu"), True,
                                static.sample_time, static.clockwise)
    assert bool((d[:, 2] == 0).all())
    bmin, vs, _, _ = _grid(static, at)
    z = ((o[:, 2] - bmin[2]) / vs[2]).to(torch.int64)  # dda's start voxel
    assert torch.equal(z, home[aidx % (h * w) // w])

    # the JAX package's dose of one row: all of it in the row's slice
    inv_vol = np.float32(1.0 / sc.sensor.voxel_volume)
    render = jax.jit(lambda dd: j_render(j_static, j_arr, dd, inv_vol,
                                         seed=0, spp=1, chunk=1 << 16))
    row = (np.arange(p.n_active) % (h * w)) // w
    # and in the tile's columns of each film row
    lo, hi, _ = (t.numpy() for t in _unpack(wf.tile_rows(static, at)[0]))
    for py in range(h):
        vol = np.asarray(render(jnp.asarray((row == py).astype(np.float32))))
        slices = np.nonzero(vol.reshape(vol.shape[0], -1).any(1))[0]
        assert slices.tolist() == [int(home[py])], (py, slices)
        y, x = np.nonzero(vol[int(home[py]), ..., 0])
        assert ((x >= lo[y]) & (x < hi[y])).all()


def test_launch_layout_is_built_once_per_scene(target_path):
    sc = TScene(_config(target_path, "cylindrical"))
    static, arr = sc.build(mode="volume", include_target=False)
    at = scene_tensors(arr, "cpu")
    order, starts, rows, n = wf._launch_layout(static, at)
    assert order is None and starts is None and n > 0  # the identity store
    static, arr = _store("subset")
    arr = dict(at, active_pixels=arr["active_pixels"])
    static = dataclasses.replace(sc.build(mode="volume",
                                          include_target=False)[0],
                                 projector=static.projector)
    order, starts, rows, n = wf._launch_layout(static, arr)
    assert order.dtype == starts.dtype == rows.dtype == torch.int32
    assert torch.equal(order.to(torch.int64), wf.block_order(static, arr)[0])
    again = wf._launch_layout(static, arr)
    assert again[0] is order and again[1] is starts and again[2] is rows
    # another store under the same dict is not served the cached order
    other, arr2 = _store("crop")
    arr["active_pixels"] = arr2["active_pixels"]
    other = dataclasses.replace(static, projector=other.projector)
    assert wf._launch_layout(other, arr)[0].numel() == \
        other.projector.n_active


def _unpack(rows):
    """(lo, hi, offset) of each film row of the tile."""
    rows = rows.to(torch.int64)
    lo, n = rows[:, 0], rows[:, 1]
    return lo, lo + n, rows[:, 2] + lo


@pytest.mark.parametrize("vial", ["bench", "cylindrical", "square",
                                  "double_cylindrical"])
def test_tile_rows_hold_the_medium(vial, target_path):
    """Every voxel whose centre lies in the medium is in the tile, the
    rows are packed end to end, and the bench scene's tile (a 4.75 mm
    vial on a 256^2 slice over 10 mm) fits one CTA's shared memory."""
    if vial == "bench":
        cfg = _config(target_path, "cylindrical", film=256, scale=10.0)
        cfg["vial"] = {"type": "cylindrical", "r_int": 4.75, "r_ext": 5.0,
                       "ior": 1.54, "medium": cfg["vial"]["medium"]}
    else:
        cfg = _config(target_path, vial)
    static, arr = TScene(cfg).build(mode="volume", include_target=False)
    at = scene_tensors(arr, "cpu")
    rows, n = wf.tile_rows(static, at)
    lo, hi, off = _unpack(rows)
    assert int((hi - lo).clamp(min=0).sum()) == n > 0
    assert torch.equal(off[1:], off[:-1] + (hi - lo)[:-1])
    X, Y, _ = static.sensor.res
    bmin, vs, _, _ = _grid(static, at)
    c = (torch.arange(max(X, Y), dtype=torch.float64) + 0.5)
    cx = bmin[0].double() + c[:X] * vs[0].double()
    cy = bmin[1].double() + c[:Y] * vs[1].double()
    yy, xx = torch.meshgrid(cy, cx, indexing="ij")
    v = VIALS.get(vial)
    if v is None or v["type"] == "cylindrical":
        r = 4.75 if v is None else v["r_int"]
        medium = xx ** 2 + yy ** 2 < r ** 2
    elif v["type"] == "square":
        medium = (xx.abs() < v["w_int"] / 2) & (yy.abs() < v["w_int"] / 2)
    else:
        medium = xx ** 2 + yy ** 2 < v["r_int_outer"] ** 2
    x = torch.arange(X)
    inside = (x[None, :] >= lo[:, None]) & (x[None, :] < hi[:, None])
    assert bool(inside[medium].all())
    if vial == "bench":
        assert 8 * Y + 4 * n <= 227 * 1024
        assert n < 1.05 * int(medium.sum())
