"""drtvam_tpu_torch.utils.meshfit against drtvam_tpu.utils.meshfit on the
seven cases of tests/test_meshfit.py: the enclosing circles and the
to_world matrices within 1e-12 (both are float64 host numpy running the
same operations; measured bitwise), the same ValueError, and the
port's own checks of each case (the circle contains every point, the
transformed bounding boxes)."""
import numpy as np
import pytest

from drtvam_tpu.ops.mesh import load_obj as j_load_obj
from drtvam_tpu.utils import meshfit as jfit
from drtvam_tpu_torch.ops.mesh import load_obj, make_box, save_ply
from drtvam_tpu_torch.utils import meshfit as tfit

TOL = 1e-12


def _same_circle(pts):
    (cj, rj), (ct, rt) = (jfit.min_enclosing_circle(pts),
                          tfit.min_enclosing_circle(pts))
    np.testing.assert_allclose(ct, cj, rtol=0, atol=TOL)
    assert abs(rt - rj) <= TOL
    return ct, rt


def _same_transform(path, print_size, size=None):
    mj = jfit.get_mesh_transform(path, print_size=print_size, size=size)
    mt = tfit.get_mesh_transform(path, print_size=print_size, size=size)
    assert mt.shape == (4, 4)
    np.testing.assert_allclose(mt, mj, rtol=0, atol=TOL)
    return mt


def case_mec_exact_square(tmp_path):
    c, r = _same_circle(np.array([[0, 0], [2, 0], [0, 2], [2, 2]], float))
    assert np.allclose(c, [1, 1], atol=1e-9)
    assert np.isclose(r, np.sqrt(2), atol=1e-9)


def case_mec_collinear_and_interior(tmp_path):
    c, r = _same_circle(np.array([[0, 0], [1, 0], [4, 0], [2, 0]], float))
    assert np.allclose(c, [2, 0], atol=1e-9)
    assert np.isclose(r, 2.0, atol=1e-9)


def case_mec_random_contains_all(tmp_path):
    pts = np.random.default_rng(3).normal(size=(500, 2))
    c, r = _same_circle(pts)
    d = np.linalg.norm(pts - c, axis=1)
    assert d.max() <= r * (1 + 1e-9) + 1e-9
    assert np.count_nonzero(d >= r - 1e-6) >= 2


def case_transform_tall_z_tight_fit(tmp_path):
    mesh = make_box((0.5, 1.0, 2.0), center=(3.0, -1.0, 5.0))
    p = str(tmp_path / "box.ply")
    save_ply(mesh, p)
    M = _same_transform(p, (10.0, 10.0, 8.0))
    bmin, bmax = mesh.transformed_matrix(M).bbox
    s = min(8.0 / 4.0, 5.0 / np.sqrt(0.5 ** 2 + 1.0 ** 2))
    assert np.isclose(float(bmax[2] - bmin[2]), 4.0 * s, rtol=1e-5)
    assert np.allclose(0.5 * (bmin + bmax), 0.0, atol=1e-5)


def case_transform_rotates_tallest_axis_to_z(tmp_path):
    mesh = make_box((3.0, 1.0, 0.5))
    p = str(tmp_path / "wide.ply")
    save_ply(mesh, p)
    M = _same_transform(p, (4.0, 4.0, 4.0))
    out = mesh.transformed_matrix(M)
    ext = out.bbox[1] - out.bbox[0]
    assert np.argmax(ext) == 2 and float(ext[2]) <= 4.0 + 1e-5
    assert np.linalg.norm(out.vertices[:, :2], axis=1).max() <= \
        2.0 * np.sqrt(2) + 1e-4


def case_transform_explicit_size(tmp_path):
    mesh = make_box((1.0, 1.0, 2.0), center=(5.0, 5.0, 5.0))
    p = str(tmp_path / "b.ply")
    save_ply(mesh, p)
    M = _same_transform(p, (10.0, 10.0, 10.0), size=2.0)
    bmin, bmax = mesh.transformed_matrix(M).bbox
    assert np.isclose(float((bmax - bmin).max()), 2.0, rtol=1e-6)
    assert np.allclose(0.5 * (bmin + bmax), 0.0, atol=1e-5)
    for fit in (jfit, tfit):
        with pytest.raises(ValueError, match="larger than the printable"):
            fit.get_mesh_transform(p, print_size=(1.0, 1.0, 1.0), size=2.0)


def case_obj_roundtrip(tmp_path):
    p = str(tmp_path / "tri.obj")
    with open(p, "w") as f:
        f.write("v 0 0 0\nv 1 0 0\nv 0 1 0\nv 0 0 1\n"
                "f 1 2 3\nf 1/1 2/2 4/4\nf -4//1 -1//1 -2//1\n")
    m, mj = load_obj(p), j_load_obj(p)
    np.testing.assert_array_equal(m.vertices, mj.vertices)
    np.testing.assert_array_equal(m.faces, mj.faces)
    assert m.faces[2].tolist() == [0, 3, 2]
    # the fit of the tetrahedron: tallest axis a tie, taken as x
    _same_transform(p, (4.0, 4.0, 4.0))


CASES = {k[5:]: v for k, v in dict(globals()).items()
         if k.startswith("case_")}


@pytest.mark.parametrize("case", sorted(CASES))
def test_meshfit_matches_jax(case, tmp_path):
    CASES[case](tmp_path)


def test_empty_points_raise():
    for fit in (jfit, tfit):
        with pytest.raises(ValueError, match="at least one point"):
            fit.min_enclosing_circle(np.zeros((0, 2)))
