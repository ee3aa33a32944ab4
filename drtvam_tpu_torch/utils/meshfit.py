"""Mesh-to-print-volume fitting (counterpart of drtvam_tpu/utils/meshfit.py,
host numpy).

`get_mesh_transform` computes a `to_world` 4x4 that places a mesh inside
the printable volume. With `size=None` the object is fit as tightly as
possible: the tallest bounding-box axis is rotated onto z (the print
volume is taller than it is wide because of refraction), the xy
footprint is bounded by the minimal enclosing circle of the projected
vertices (Welzl's algorithm, `min_enclosing_circle`), and the limiting
scale factor of {height fit, circle fit} wins. With an explicit `size`
the mesh is centered and scaled so that its largest extent equals
`size`.
"""
from __future__ import annotations

import numpy as np

from ..ops.mesh import load_mesh


def _circumcircle(a, b, c):
    """Circumcircle of 3 points in 2D: (center, r2), or None for
    (near-)collinear points."""
    d = 2.0 * (a[0] * (b[1] - c[1]) + b[0] * (c[1] - a[1]) +
               c[0] * (a[1] - b[1]))
    if abs(d) < 1e-14 * max(1.0, np.abs([a, b, c]).max() ** 2):
        return None
    a2, b2, c2 = np.dot(a, a), np.dot(b, b), np.dot(c, c)
    ux = (a2 * (b[1] - c[1]) + b2 * (c[1] - a[1]) + c2 * (a[1] - b[1])) / d
    uy = (a2 * (c[0] - b[0]) + b2 * (a[0] - c[0]) + c2 * (b[0] - a[0])) / d
    ctr = np.array([ux, uy])
    return ctr, float(np.dot(a - ctr, a - ctr))


def _circle_from(boundary):
    """The smallest circle with the 0-3 points `boundary` on it."""
    if len(boundary) == 0:
        return np.zeros(2), -1.0
    if len(boundary) == 1:
        return boundary[0].copy(), 0.0
    if len(boundary) == 2:
        ctr = 0.5 * (boundary[0] + boundary[1])
        return ctr, float(np.dot(boundary[0] - ctr, boundary[0] - ctr))
    cc = _circumcircle(*boundary)
    if cc is not None:
        return cc
    # collinear support: the widest pair
    best = (np.zeros(2), -1.0)
    for i in range(3):
        for j in range(i + 1, 3):
            ctr = 0.5 * (boundary[i] + boundary[j])
            r2 = float(np.dot(boundary[i] - ctr, boundary[i] - ctr))
            if r2 > best[1]:
                best = (ctr, r2)
    return best


def min_enclosing_circle(points, rng_seed=0):
    """Exact minimal enclosing circle of 2D points (Welzl, iterative
    move-to-front, expected O(n)). Returns (center (2,), radius)."""
    pts = np.unique(np.asarray(points, np.float64).reshape(-1, 2), axis=0)
    if pts.shape[0] == 0:
        raise ValueError("min_enclosing_circle needs at least one point")
    pts = pts[np.random.default_rng(rng_seed).permutation(pts.shape[0])]
    eps = 1e-10

    def covers(ctr, r2, p):
        d = p - ctr
        return np.dot(d, d) <= r2 * (1.0 + eps) + eps

    ctr, r2 = _circle_from([pts[0]])
    for i in range(1, len(pts)):
        if covers(ctr, r2, pts[i]):
            continue
        ctr, r2 = _circle_from([pts[i]])
        for j in range(i):
            if covers(ctr, r2, pts[j]):
                continue
            ctr, r2 = _circle_from([pts[i], pts[j]])
            for k in range(j):
                if covers(ctr, r2, pts[k]):
                    continue
                ctr, r2 = _circle_from([pts[i], pts[j], pts[k]])
    return ctr, float(np.sqrt(max(r2, 0.0)))


def _rot90_about(axis):
    """Rodrigues rotation by +90 degrees about a unit axis."""
    k = np.asarray(axis, np.float64)
    k = k / np.linalg.norm(k)
    K = np.array([[0, -k[2], k[1]],
                  [k[2], 0, -k[0]],
                  [-k[1], k[0], 0]])
    return np.eye(3) + K + K @ K  # cos 90 = 0, sin 90 = 1


def get_mesh_transform(filename, print_size, size=None):
    """4x4 `to_world` fitting the mesh of `filename` (PLY or OBJ) into
    the printable volume of extents print_size (x, y, z). size: an
    explicit object size (the largest extent), else the tight fit (the
    tallest axis onto z, the minimal enclosing circle of the other two
    axes' coordinates, taken before the rotation)."""
    print_size = np.asarray(print_size, np.float64)
    v = load_mesh(filename).vertices.astype(np.float64)
    bmin, bmax = v.min(0), v.max(0)
    extents = bmax - bmin
    ext_max = float(extents.max())

    M = np.eye(4)
    if size is not None:
        if np.any(size > print_size):
            raise ValueError(
                "The size of the object is larger than the printable "
                "volume.")
        c = 0.5 * (bmin + bmax)
        s = size / ext_max
        M[:3, :3] = s * np.eye(3)
        M[:3, 3] = -s * c
        return M

    tall = int(np.argmax(extents))
    R = np.eye(3)
    if tall != 2:
        # the tallest axis onto z: about cross(e_tall, e_z)
        e = np.zeros(3)
        e[tall] = 1.0
        R = _rot90_about(np.cross(e, [0.0, 0.0, 1.0]))

    mask = np.ones(3, bool)
    mask[tall] = False
    ctr2, r = min_enclosing_circle(v[:, mask])
    c = np.zeros(3)
    c[mask] = ctr2
    c[tall] = 0.5 * (bmin + bmax)[tall]

    s = min(print_size[2] / ext_max,
            float(np.min(0.5 * print_size[:2])) / max(r, 1e-30))
    M[:3, :3] = s * R
    M[:3, 3] = s * (R @ (-c))
    return M
