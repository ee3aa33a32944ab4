"""The seeded phantom: the same seed gives the same mesh, another seed
another pose; the mesh is closed; its outline, as the reference reads
it, is what the program voxelizes."""
import json
import os

import numpy as np
import pytest

from perfbench.harness import phantom
from perfbench.reference import occupancy

from conftest import ROOT

with open(os.path.join(ROOT, "perfbench", "configs", "benchy-idx.json")) as f:
    SPEC = json.load(f)["phantom"]
SEEDS = [0, 7, 2**31 + 11, 2**33 + 5]


@pytest.mark.parametrize("seed", SEEDS)
def test_same_seed_same_mesh(seed):
    a = phantom.make_pose(SPEC, np.random.default_rng(seed))
    b = phantom.make_pose(SPEC, np.random.default_rng(seed))
    assert a.angle == b.angle and a.hole_x == b.hole_x
    np.testing.assert_array_equal(a.vertices, b.vertices)
    np.testing.assert_array_equal(a.faces, b.faces)


def test_seeds_draw_other_poses():
    poses = [phantom.make_pose(SPEC, np.random.default_rng(s))
             for s in SEEDS]
    assert len({p.angle for p in poses}) == len(SEEDS)
    lo, hi = SPEC["hole_x"]
    assert all(lo <= p.hole_x <= hi for p in poses)


@pytest.mark.parametrize("seed", SEEDS)
def test_mesh_is_closed_and_centred(seed):
    p = phantom.make_pose(SPEC, np.random.default_rng(seed))
    edges = {}
    for f in p.faces:
        for a, b in ((f[0], f[1]), (f[1], f[2]), (f[2], f[0])):
            key = (min(a, b), max(a, b))
            edges[key] = edges.get(key, 0) + 1
    assert set(edges.values()) == {2}
    bmin, bmax = p.vertices.min(0), p.vertices.max(0)
    np.testing.assert_array_equal(bmin, -bmax)
    v = p.normalized(10.0)
    assert np.isclose(v[:, 2].max() - v[:, 2].min(), 10.0)


@pytest.mark.parametrize("seed", SEEDS)
def test_outline_matches_the_program_s_voxelization(seed, tmp_path):
    from drtvam_tpu_torch.models.sensor import Sensor
    from drtvam_tpu_torch.models.scene import _mesh_transform
    from drtvam_tpu_torch.ops.mesh import load_mesh
    p = phantom.make_pose(SPEC, np.random.default_rng(seed))
    path = str(tmp_path / "p.ply")
    phantom.write_ply(p, path)
    mesh = _mesh_transform(load_mesh(path), {"size": 10.0})
    np.testing.assert_array_equal(mesh.vertices, p.normalized(10.0))
    sensor = {"type": "dda", "scalex": 10, "scaley": 10, "scalez": 10,
              "film": {"type": "vfilm", "resx": 96, "resy": 80,
                       "resz": 4}}
    occ = Sensor(sensor).discretize(mesh.triangle_bank())
    film = occupancy.film_of(sensor)
    far, near = occupancy.compare(occ, p.rings(10.0), p.edges(10.0), film)
    assert (far, near) == (0, 0)
    assert occ.sum() > 0.15 * occ.size


@pytest.mark.parametrize("angle,hole_x", [(0.3, 0.1), (1.0, -0.25)])
def test_the_written_mesh_reads_back_exactly(angle, hole_x, tmp_path):
    """The program reads the written file's vertices bit for bit; the
    first pose is one whose binary body would start with a line break."""
    from drtvam_tpu_torch.ops.mesh import load_mesh
    p = phantom.build_pose(SPEC, angle, hole_x)
    path = str(tmp_path / "p.ply")
    phantom.write_ply(p, path)
    mesh = load_mesh(path)
    np.testing.assert_array_equal(mesh.vertices, p.vertices)
    np.testing.assert_array_equal(mesh.faces, p.faces)
