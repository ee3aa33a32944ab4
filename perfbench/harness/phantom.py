"""The seeded bench phantom: a box with a z-through hole.

The stand-in for the 3DBenchy mesh of upstream Dr.TVAM's benchmark: a
box of half extents `half` (mesh units) with a round hole of
`hole_radius` (a regular polygon of `segments` sides) along z. Each
draw rotates it about the vial axis by an angle in `rotation_deg` and
moves the hole's centre along the box's x axis by an offset in
`hole_x`, both from the run's seed.

The outline is exact: the outer ring is the box's rectangle (its four
corners and one point per hole vertex, projected radially from the
hole's centre onto it), so that the rotated mesh's bounding box is
symmetric about the origin. The caps are fans from the hole's vertices
over that ring; the side walls and the hole wall close the mesh.

The mesh is written as an ASCII PLY. `Pose.rings` gives the outline in
the print volume (the config's normalization applied in float32, as the
configuration schema defines it), and `Pose.edges` every edge of the
caps' triangulation, which the reference needs to tell a tie on a
triangle edge from a real difference.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class Pose:
    """One seeded phantom: its angle (radians), hole offset and mesh."""
    angle: float
    hole_x: float
    vertices: np.ndarray      # (V, 3) float32, mesh units
    faces: np.ndarray         # (F, 3) int32
    outer: np.ndarray         # (n_out, 2) float32 indices into vertices
    hole: np.ndarray          # (n_hole,) indices into vertices
    cap_edges: np.ndarray     # (E, 2) vertex index pairs of one cap

    def normalized(self, size, center=(0.0, 0.0, 0.0)):
        """The vertices in the print volume: v * s + (c - m * s) with
        m the bounding box's centre and s = size / its largest extent,
        in float32 arithmetic (the configuration schema's `size`)."""
        v = self.vertices
        bmin, bmax = v.min(0), v.max(0)
        m = np.float32(0.5) * (bmin + bmax)
        s = np.float32(float(size) / float((bmax - bmin).max()))
        t = np.asarray(center, np.float32) - m * s
        return v * s + t

    def rings(self, size):
        """(outer ring, hole ring) (n, 2) float64 in the print volume."""
        v = self.normalized(size).astype(np.float64)
        return v[self.outer, :2], v[self.hole, :2]

    def edges(self, size):
        """(E, 2, 2) float64 segments of the caps' triangulation."""
        v = self.normalized(size).astype(np.float64)
        return v[self.cap_edges][:, :, :2]


def _ring(half, radius, cx, segments):
    """Hole polygon and the outer ring: the rectangle's corners merged
    in angular order with the hole's vertices projected onto it."""
    hx, hy = half[0], half[1]
    th = 2.0 * np.pi * np.arange(segments) / segments
    circ = np.stack([cx + radius * np.cos(th), radius * np.sin(th)], -1)
    proj = []
    for (x, y), a in zip(circ, th):
        dx, dy = np.cos(a), np.sin(a)
        ts = []
        if dx > 1e-12:
            ts.append((hx - x) / dx)
        elif dx < -1e-12:
            ts.append((-hx - x) / dx)
        if dy > 1e-12:
            ts.append((hy - y) / dy)
        elif dy < -1e-12:
            ts.append((-hy - y) / dy)
        proj.append([x + min(ts) * dx, y + min(ts) * dy])
    proj = np.asarray(proj)
    corners = np.array([[hx, hy], [-hx, hy], [-hx, -hy], [hx, -hy]])
    # angles about the hole's centre, in [th_0, th_0 + 2 pi)
    cang = np.mod(np.arctan2(corners[:, 1], corners[:, 0] - cx), 2 * np.pi)
    return circ, proj, corners, cang, th


def make_pose(spec, rng):
    """Draw one phantom from `spec` (the configuration's `phantom`) and
    a numpy Generator."""
    lo, hi = spec["rotation_deg"]
    angle = float(np.deg2rad(rng.uniform(lo, hi)))
    xlo, xhi = spec["hole_x"]
    hole_x = float(rng.uniform(xlo, xhi))
    return build_pose(spec, angle, hole_x)


def build_pose(spec, angle, hole_x):
    half = [float(h) for h in spec["half"]]
    n = int(spec["segments"])
    circ, proj, corners, cang, th = _ring(half, float(spec["hole_radius"]),
                                          hole_x, n)
    # outer ring: projected points with the corners inserted where the
    # angle about the hole's centre passes them
    outer_xy, owner = [], []     # owner: the hole vertex whose fan holds it
    for i in range(n):
        outer_xy.append(proj[i])
        owner.append(i)
        a0, a1 = th[i], th[i + 1] if i + 1 < n else 2 * np.pi
        for k in np.argsort(cang):
            if a0 < cang[k] < a1:
                outer_xy.append(corners[k])
                owner.append(i)
    outer_xy = np.asarray(outer_xy)
    hz = half[2]
    c, s = np.cos(angle), np.sin(angle)
    rot = np.array([[c, -s], [s, c]])

    def lift(xy, z):
        p = xy @ rot.T
        return np.concatenate([p, np.full((len(xy), 1), z)], 1)

    n_out = len(outer_xy)
    verts = np.concatenate([lift(circ, -hz), lift(outer_xy, -hz),
                            lift(circ, hz), lift(outer_xy, hz)])
    cb = np.arange(n)
    ob = n + np.arange(n_out)
    ct = n + n_out + np.arange(n)
    ot = 2 * n + n_out + np.arange(n_out)
    faces, cap = [], []
    for j in range(n_out):
        jn = (j + 1) % n_out
        i = owner[j]
        # a fan triangle from hole vertex i over the outer edge j -> jn
        faces += [[cb[i], ob[j], ob[jn]], [ct[i], ot[jn], ot[j]]]
        faces += [[ob[j], ot[j], ot[jn]], [ob[j], ot[jn], ob[jn]]]
        cap += [[i, n + j], [n + j, n + jn], [i, n + jn]]
        if owner[jn] != i:
            # the fan passes to the next hole vertex over this outer point
            i2 = owner[jn]
            faces += [[cb[i], ob[jn], cb[i2]], [ct[i], ct[i2], ot[jn]]]
            cap += [[i, i2], [i2, n + jn]]
    for i in range(n):
        j = (i + 1) % n
        faces += [[cb[i], cb[j], ct[j]], [cb[i], ct[j], ct[i]]]
    verts = verts.astype(np.float32)
    return Pose(angle=angle, hole_x=hole_x, vertices=verts,
                faces=np.asarray(faces, np.int32), outer=ob.copy(),
                hole=cb.copy(), cap_edges=np.asarray(cap, np.int64))


def write_ply(pose, path):
    """ASCII PLY of the phantom's triangles, each coordinate with the nine
    digits that give its float32 back. (The program's binary PLY reader
    takes a body that starts with a line-break byte for part of the
    header and reads the mesh wrong: PERF.md, Open questions.)"""
    v, f = pose.vertices.astype(np.float32), pose.faces
    with open(path, "w") as fh:
        fh.write("ply\nformat ascii 1.0\n")
        fh.write(f"element vertex {len(v)}\n")
        fh.write("property float x\nproperty float y\nproperty float z\n")
        fh.write(f"element face {len(f)}\n")
        fh.write("property list uchar int vertex_indices\nend_header\n")
        fh.writelines(f"{x:.9g} {y:.9g} {z:.9g}\n" for x, y, z in v)
        fh.writelines(f"3 {a} {b} {c}\n" for a, b, c in f)
