"""The port's mesh intersection against the JAX package's, on the CPU:
the uniform grid's build (the same arrays, bitwise), the brute-force
Moller-Trumbore sweep and the grid walk on tests/test_mesh_grid.py's
meshes and rays (hit distances bitwise: the port fuses the test's cross
products and three-term sums as XLA does on the CPU; triangle ids equal
except where two triangles share the nearest hit), the mesh scene's
arrays key for key, and the march's intersect_scene with the target
mesh kept (the hit distance and surface id bitwise)."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from drtvam_tpu.models.scene import Scene as JScene
from drtvam_tpu.ops import march as jmarch
from drtvam_tpu.ops.intersect import ray_triangles as jrt
from drtvam_tpu.ops.mesh import (make_box, make_box_with_hole,
                                 make_hollow_gear, save_ply)
from drtvam_tpu.ops.mesh_grid import (build_tri_grid as jgrid,
                                      ray_triangles_grid as jrtg)
from drtvam_tpu_torch.convert import scene_from_jax
from drtvam_tpu_torch.models.scene import Scene as TScene
from drtvam_tpu_torch.ops import march as tmarch
from drtvam_tpu_torch.ops.intersect import ray_triangles as trt
from drtvam_tpu_torch.ops.mesh_grid import (GRID_MIN_TRIS,
                                            build_tri_grid as tgrid,
                                            ray_triangles_grid as trtg)

from torch_threads import one_torch_thread  # noqa: F401
from torch_jax_native import jax_native_libraries  # noqa: F401

# tests/test_mesh_grid.py's meshes and ray seeds
MESHES = {"gear": (lambda: make_hollow_gear(segments=240), 1),
          "box_hole": (lambda: make_box_with_hole((2.0, 2.0, 1.0), 0.6,
                                                  segments=99), 2)}


def _rays(n, seed, spread=3.0):
    """tests/test_mesh_grid.py's rays: numpy-seeded origins in a cube,
    unit directions."""
    rng = np.random.default_rng(seed)
    o = rng.uniform(-spread, spread, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return o, d


def _same_nearest(t, i, jt, ji, v0, e1, e2, o, d):
    """Bitwise t; ids equal, or, where they differ, both triangles hit
    at the same t (a tie, e.g. a shared edge)."""
    np.testing.assert_array_equal(t, jt)
    for k in np.nonzero(i != ji)[0]:
        for tri in (i[k], ji[k]):
            tk, _ = jrt(o[k:k + 1], d[k:k + 1], np.full(1, 1e-4, np.float32),
                        v0[tri:tri + 1], e1[tri:tri + 1], e2[tri:tri + 1])
            assert np.asarray(tk)[0] == t[k]


def test_build_tri_grid_matches_jax():
    for make, _ in MESHES.values():
        v0, e1, e2, _ = make().triangle_bank()
        j, t = jgrid(v0, e1, e2), tgrid(v0, e1, e2)
        assert tuple(t[0]) == tuple(j[0])
        for a, b in zip(t[1:], j[1:]):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("name", list(MESHES))
@pytest.mark.parametrize("grid", [False, True])
def test_ray_triangles_matches_jax(name, grid):
    make, seed = MESHES[name]
    v0, e1, e2, _ = make().triangle_bank()
    n = 4096
    o, d = _rays(n, seed)
    tmin = np.full(n, 1e-4, np.float32)
    T = lambda x: torch.from_numpy(np.ascontiguousarray(x))  # noqa: E731
    if grid:
        res, cs, ids, b0, b1 = jgrid(v0, e1, e2)
        jt, ji = jax.jit(lambda o, d, tm: jrtg(
            o, d, tm, *map(jnp.asarray, (v0, e1, e2, cs, ids, b0, b1)),
            res))(o, d, tmin)
        t, i = trtg(*map(T, (o, d, tmin, v0, e1, e2, cs, ids, b0, b1)), res)
    else:
        jt, ji = jax.jit(jrt)(o, d, tmin, v0, e1, e2)
        t, i = trt(*map(T, (o, d, tmin, v0, e1, e2)))
    jt, ji = np.asarray(jt), np.asarray(ji)
    assert np.isfinite(jt).mean() > 0.05   # the rays do hit the mesh
    _same_nearest(t.numpy(), i.numpy(), jt, ji, v0, e1, e2, o, d)


def _config(path, vial):
    vials = {"cylindrical": {"type": "cylindrical", "r_int": 2.6,
                             "r_ext": 2.9, "ior": 1.54},
             "square": {"type": "square", "w_int": 4.6, "w_ext": 5.0,
                        "ior": 1.54}}
    v = dict(vials[vial], medium={"ior": 1.40, "extinction": 0.1,
                                  "albedo": 0.0})
    return {"vial": v,
            "projector": {"type": "collimated", "n_patterns": 8,
                          "resx": 16, "resy": 8, "pixel_size": 5.0 / 16,
                          "motion": "circular", "distance": 20},
            "sensor": {"type": "dda", "scalex": 5, "scaley": 5,
                       "scalez": 1.25,
                       "film": {"type": "vfilm", "resx": 24, "resy": 24,
                                "resz": 12}},
            "target": {"filename": path, "size": 1.5}, "output": "/tmp"}


# a 12-triangle box (below GRID_MIN_TRIS: brute force) and the 792-
# triangle box with a hole of the bench (a grid)
TARGETS = {"box": lambda: make_box((0.5, 0.5, 0.5)),
           "box_hole": lambda: make_box_with_hole((2.0, 2.0, 1.0), 0.5,
                                                  segments=99)}


@pytest.mark.parametrize("target", list(TARGETS))
@pytest.mark.parametrize("mode", ["radon", "corner"])
def test_mesh_scene_matches_jax(target, mode, tmp_path):
    path = str(tmp_path / "t.ply")
    save_ply(TARGETS[target](), path)
    cfg = _config(path, "square" if mode == "corner" else "cylindrical")
    kw = dict(mode="volume", include_target=True, max_depth=1,
              regular_sampling=True) if mode == "corner" else \
        dict(mode="radon", include_target=True, max_depth=5)
    jstatic, jarr = JScene(cfg).build(**kw)
    tstatic, tarr = TScene(cfg).build(**kw)
    mesh = tstatic.surfaces[-1]
    assert mesh.is_target and (mesh.grid is not None) == (
        mesh.tri_slice[1] >= GRID_MIN_TRIS)
    conv_static, conv_arr = scene_from_jax(jstatic, jarr)
    assert tstatic == conv_static
    assert sorted(tarr) == sorted(conv_arr)
    for k in tarr:
        a, b = np.asarray(tarr[k]), conv_arr[k]
        assert a.dtype == b.dtype and a.shape == b.shape, k
        np.testing.assert_array_equal(a, b, err_msg=k)

    # the march's intersection over the scene, the mesh included: the
    # mesh's hits bitwise, the analytic surfaces' to 2e-6 of scale (XLA
    # fuses their products on the CPU), the same surface ids
    o, d = _rays(4096, 5, spread=2.0)
    active = np.ones(4096, bool)
    jarr = {k: jnp.asarray(v) for k, v in jarr.items()}
    jt, _, js, jv = jmarch.intersect_scene(jstatic, jarr, jnp.asarray(o),
                                           jnp.asarray(d),
                                           jnp.asarray(active))
    tt, _, ts, tv = tmarch.intersect_scene(
        tstatic, tmarch.scene_tensors(tarr, "cpu"), torch.from_numpy(o),
        torch.from_numpy(d), torch.from_numpy(active))
    jt, js = np.asarray(jt), np.asarray(js)
    np.testing.assert_array_equal(ts.numpy(), js)
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    on_mesh = js == len(tstatic.surfaces) - 1
    assert on_mesh.sum() > 50
    np.testing.assert_array_equal(tt.numpy()[on_mesh], jt[on_mesh])
    fin = np.isfinite(jt)
    np.testing.assert_allclose(tt.numpy()[fin], jt[fin], rtol=0,
                               atol=2e-6 * np.abs(jt[fin]).max())
