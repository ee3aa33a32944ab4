"""Triangle meshes: PLY/OBJ I/O and procedural phantoms (counterpart of
drtvam_tpu/ops/mesh.py, host numpy).

Meshes are plain (V, 3) / (F, 3) numpy arrays; the triangle bank handed
to the voxelizer is (v0, e1, e2, n) float32.
"""
from __future__ import annotations

import struct

import numpy as np


class TriMesh:
    """Host-side triangle mesh: vertices (V, 3) f32, faces (F, 3) int32."""

    def __init__(self, vertices, faces):
        self.vertices = np.asarray(vertices, np.float32)
        self.faces = np.asarray(faces, np.int32)

    @property
    def bbox(self):
        return self.vertices.min(0), self.vertices.max(0)

    def transformed(self, scale=1.0, translate=(0.0, 0.0, 0.0), rot=None):
        v = self.vertices
        if rot is not None:
            v = v @ np.asarray(rot, np.float32).T
        v = v * np.float32(scale) + np.asarray(translate, np.float32)
        return TriMesh(v, self.faces)

    def transformed_matrix(self, to_world):
        """Apply a homogeneous 4x4 to_world matrix to the vertices."""
        M = np.asarray(to_world, np.float64)
        v = self.vertices @ M[:3, :3].T + M[:3, 3]
        return TriMesh(v, self.faces)

    def triangle_bank(self):
        """Return (v0, e1, e2, n) float32 arrays with geometric normals."""
        v = self.vertices
        f = self.faces
        v0 = v[f[:, 0]]
        e1 = v[f[:, 1]] - v0
        e2 = v[f[:, 2]] - v0
        n = np.cross(e1, e2)
        ln = np.linalg.norm(n, axis=-1, keepdims=True)
        n = n / np.maximum(ln, 1e-20)
        return (v0.astype(np.float32), e1.astype(np.float32),
                e2.astype(np.float32), n.astype(np.float32))


# --- PLY / OBJ I/O ----------------------------------------------------------

_PLY_TYPES = {"float": "f", "float32": "f", "double": "d", "float64": "d",
              "uchar": "B", "uint8": "B", "char": "b", "int8": "b",
              "short": "h", "ushort": "H", "int": "i", "int32": "i",
              "uint": "I", "uint32": "I"}


def load_ply(path):
    """Minimal PLY reader (ascii + binary_little_endian, polygon fans)."""
    with open(path, "rb") as f:
        data = f.read()
    header_end = data.index(b"end_header") + len(b"end_header")
    while data[header_end:header_end + 1] in (b"\r", b"\n"):
        header_end += 1
    lines = [l.strip() for l in data[:header_end].decode("latin1")
             .splitlines() if l.strip()]
    fmt = None
    n_vert = n_face = 0
    vert_props = []
    cur = None
    for l in lines:
        parts = l.split()
        if parts[0] == "format":
            fmt = parts[1]
        elif parts[0] == "element":
            cur = parts[1]
            if cur == "vertex":
                n_vert = int(parts[2])
            elif cur == "face":
                n_face = int(parts[2])
        elif parts[0] == "property" and cur == "vertex":
            vert_props.append(parts[1])

    if fmt == "ascii":
        rows = data[header_end:].decode("latin1").split()
        stride = len(vert_props)
        vals = np.array(rows[:n_vert * stride], np.float64)
        verts = vals.reshape(n_vert, stride)[:, :3]
        faces = []
        i = n_vert * stride
        for _ in range(n_face):
            cnt = int(rows[i])
            idx = [int(x) for x in rows[i + 1:i + 1 + cnt]]
            i += 1 + cnt
            for j in range(1, cnt - 1):
                faces.append([idx[0], idx[j], idx[j + 1]])
        return TriMesh(verts, np.array(faces, np.int32))

    if fmt != "binary_little_endian":
        raise ValueError(f"Unsupported PLY format: {fmt}")

    body = data[header_end:]
    fmt_str = "<" + "".join(_PLY_TYPES[t] for t in vert_props)
    vsize = struct.calcsize(fmt_str)
    if all(t in ("float", "float32") for t in vert_props):
        flat = np.frombuffer(body[:n_vert * vsize], dtype="<f4")
        verts = flat.reshape(n_vert, len(vert_props))[:, :3] \
            .astype(np.float32)
    else:
        verts = np.zeros((n_vert, 3), np.float32)
        for i in range(n_vert):
            verts[i] = struct.unpack_from(fmt_str, body, i * vsize)[:3]
    faces = []
    pos = n_vert * vsize
    for _ in range(n_face):
        cnt = body[pos]
        pos += 1
        idx = struct.unpack_from(f"<{cnt}i", body, pos)
        pos += 4 * cnt
        for j in range(1, cnt - 1):
            faces.append([idx[0], idx[j], idx[j + 1]])
    return TriMesh(verts, np.array(faces, np.int32))


def load_obj(path):
    """Minimal Wavefront OBJ reader (v / f records, polygon fans)."""
    verts, faces = [], []
    with open(path, "r") as fh:
        for line in fh:
            parts = line.split()
            if not parts:
                continue
            if parts[0] == "v":
                verts.append([float(x) for x in parts[1:4]])
            elif parts[0] == "f":
                # 1-based, negatives count from the end
                idx = []
                for p in parts[1:]:
                    i = int(p.split("/")[0])
                    idx.append(i - 1 if i > 0 else len(verts) + i)
                for j in range(1, len(idx) - 1):
                    faces.append([idx[0], idx[j], idx[j + 1]])
    if not verts or not faces:
        raise ValueError(f"OBJ file '{path}' has no triangles.")
    return TriMesh(np.asarray(verts, np.float32),
                   np.asarray(faces, np.int32))


def load_mesh(path):
    """Load a triangle mesh by extension (ply | obj)."""
    ext = path.rsplit(".", 1)[-1].lower()
    if ext == "ply":
        return load_ply(path)
    if ext == "obj":
        return load_obj(path)
    raise ValueError(f"Unsupported extension: '{ext}', only PLY and OBJ "
                     "meshes are supported.")


def save_ply(mesh: TriMesh, path):
    v, f = mesh.vertices, mesh.faces
    with open(path, "wb") as fh:
        fh.write(b"ply\nformat binary_little_endian 1.0\n")
        fh.write(f"element vertex {len(v)}\n".encode())
        fh.write(b"property float x\nproperty float y\nproperty float z\n")
        fh.write(f"element face {len(f)}\n".encode())
        fh.write(b"property list uchar int vertex_indices\nend_header\n")
        fh.write(v.astype("<f4").tobytes())
        rec = np.empty(len(f), dtype=[("n", "u1"), ("i", "<i4", 3)])
        rec["n"] = 3
        rec["i"] = f
        fh.write(rec.tobytes())


# --- procedural phantoms ----------------------------------------------------

def make_box(half, center=(0, 0, 0)):
    """Axis-aligned box mesh with outward normals."""
    hx, hy, hz = half
    cx, cy, cz = center
    v = np.array([[sx * hx + cx, sy * hy + cy, sz * hz + cz]
                  for sz in (-1, 1) for sy in (-1, 1) for sx in (-1, 1)],
                 np.float32)
    # 8 vertices indexed bit-wise (x fastest); faces CCW seen from outside
    quads = [(0, 2, 3, 1), (4, 5, 7, 6), (0, 1, 5, 4),
             (2, 6, 7, 3), (0, 4, 6, 2), (1, 3, 7, 5)]
    faces = []
    for a, b, c, d in quads:
        faces += [[a, b, c], [a, c, d]]
    return TriMesh(v, np.array(faces, np.int32))


def make_open_box(half_outer, wall, open_top=True):
    """A 5-sided cuvette as two nested boxes: (outer, inner), both with
    outward normals (the custom vial's convention: the medium is the
    inner mesh's interior). open_top: the inner cavity reaches past the
    top."""
    ho = np.asarray(half_outer, np.float64)
    outer = make_box(ho)
    hi = ho - wall
    if open_top:
        inner = make_box((hi[0], hi[1], ho[2] + wall), center=(0, 0, wall))
    else:
        inner = make_box(hi)
    return outer, inner


def make_box_with_hole(half, hole_radius, hole_center_xy=(0.0, 0.0),
                       segments=64):
    """Box with a cylindrical through-hole along z. Watertight:
    annulus-to-square rings top and bottom, 4 side walls, and the hole
    wall (normals pointing into the hole)."""
    hx, hy, hz = half
    cx, cy = hole_center_xy
    th = np.linspace(0.0, 2.0 * np.pi, segments, endpoint=False)
    circ = np.stack([cx + hole_radius * np.cos(th),
                     cy + hole_radius * np.sin(th)], -1)

    # one square-boundary point per circle point, projected radially
    # outward from the hole center (valid pairing for off-center holes)
    sq = []
    for x, y in circ:
        dx, dy = x - cx, y - cy
        ts = []
        if dx > 1e-12:
            ts.append((hx - x) / dx)
        elif dx < -1e-12:
            ts.append((-hx - x) / dx)
        if dy > 1e-12:
            ts.append((hy - y) / dy)
        elif dy < -1e-12:
            ts.append((-hy - y) / dy)
        t = min((t for t in ts if t >= 0.0), default=0.0)
        sq.append([x + t * dx, y + t * dy])

    verts = []

    def add(v):
        verts.append(v)
        return len(verts) - 1

    cb = [add([x, y, -hz]) for x, y in circ]
    sb = [add([x, y, -hz]) for x, y in sq]
    ct = [add([x, y, hz]) for x, y in circ]
    st = [add([x, y, hz]) for x, y in sq]

    faces = []
    n = segments
    for i in range(n):
        j = (i + 1) % n
        faces += [[cb[i], sb[i], sb[j]], [cb[i], sb[j], cb[j]]]  # bottom
        faces += [[ct[i], st[j], st[i]], [ct[i], ct[j], st[j]]]  # top
        faces += [[cb[i], cb[j], ct[j]], [cb[i], ct[j], ct[i]]]  # hole wall
        faces += [[sb[i], st[i], st[j]], [sb[i], st[j], sb[j]]]  # side
    return TriMesh(np.array(verts, np.float32), np.array(faces, np.int32))


def make_box_tube(hx, hy, z0, z1, flip=False):
    """Open rectangular tube (4 side walls, no caps, 8 triangles), the
    shape of a cuvette's wall. Normals point outward (flip: inward); a
    custom vial's inner wall has outward normals too, the medium being
    the mesh's interior."""
    v = np.array([[sx * hx, sy * hy, z]
                  for z in (z0, z1) for sy in (-1, 1) for sx in (-1, 1)],
                 np.float32)
    # bottom ring 0..3 (x fastest), top ring 4..7: the y-, y+, x+, x- walls
    quads = [(0, 1, 5, 4), (3, 2, 6, 7), (1, 3, 7, 5), (2, 0, 4, 6)]
    faces = []
    for a, b, c, d in quads:
        faces += [[a, b, c], [a, c, d]]
    f = np.array(faces, np.int32)
    if flip:
        f = f[:, ::-1]
    return TriMesh(v, f)


def make_hollow_gear(r_out=1.0, r_root=0.78, r_hole=0.35, n_teeth=12,
                     half_height=0.5, segments=360, steepness=4.0):
    """Hollow gear: an extruded annulus between a toothed outer profile
    r(th) = r_root + (r_out - r_root) (0.5 + 0.5 clip(steepness
    sin(n_teeth th), -1, 1)) and a circular bore, both sampled at the
    same `segments` angles. Watertight, make_box_with_hole's topology."""
    th = np.linspace(0.0, 2.0 * np.pi, segments, endpoint=False)
    wave = np.clip(steepness * np.sin(n_teeth * th), -1.0, 1.0)
    r = r_root + (r_out - r_root) * (0.5 + 0.5 * wave)
    outer = np.stack([r * np.cos(th), r * np.sin(th)], -1)
    inner = np.stack([r_hole * np.cos(th), r_hole * np.sin(th)], -1)

    verts = []

    def add(v):
        verts.append(v)
        return len(verts) - 1

    hz = half_height
    cb = [add([x, y, -hz]) for x, y in inner]   # bottom bore ring
    sb = [add([x, y, -hz]) for x, y in outer]   # bottom gear ring
    ct = [add([x, y, hz]) for x, y in inner]    # top bore ring
    st = [add([x, y, hz]) for x, y in outer]    # top gear ring

    faces = []
    n = segments
    for i in range(n):
        j = (i + 1) % n
        faces += [[cb[i], sb[i], sb[j]], [cb[i], sb[j], cb[j]]]  # bottom
        faces += [[ct[i], st[j], st[i]], [ct[i], ct[j], st[j]]]  # top
        faces += [[cb[i], cb[j], ct[j]], [cb[i], ct[j], ct[i]]]  # bore
        faces += [[sb[i], st[i], st[j]], [sb[i], st[j], sb[j]]]  # side
    return TriMesh(np.array(verts, np.float32), np.array(faces, np.int32))


def make_cylinder_shell(radius, z0, z1, segments=96, flip=False):
    """Open tube of `segments` quads approximating a cylinder's side wall
    (normals outward; flip: inward)."""
    th = np.linspace(0.0, 2.0 * np.pi, segments, endpoint=False)
    ring = np.stack([radius * np.cos(th), radius * np.sin(th)], -1)
    verts = [[x, y, z0] for x, y in ring] + [[x, y, z1] for x, y in ring]
    faces = []
    n = segments
    for i in range(n):
        j = (i + 1) % n
        faces += [[i, j, n + j], [i, n + j, n + i]]
    f = np.array(faces, np.int32)
    if flip:
        f = f[:, ::-1]
    return TriMesh(np.array(verts, np.float32), f)
