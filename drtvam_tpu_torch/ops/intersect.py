"""Analytic ray intersection (counterpart of drtvam_tpu/ops/intersect.py
:25-80): the open z-aligned cylinder tube of the vial walls and the
axis-aligned box of square vials.

Batched over rays, branchless, t = +inf on a miss; normals are
geometric and outward (the BSDF layer handles sidedness). Triangle
meshes (`ray_triangles`, the mesh grid) are not ported: mesh vials and
occlusions are ROADMAP queue 1 item 17, the surface-aware target item
14.
"""
from __future__ import annotations

import torch

INF = float("inf")


def ray_cylinder(o, d, tmin, r, z0, z1):
    """Open tube of radius r around the z-axis, z in [z0, z1]."""
    ox, oy, oz = o[..., 0], o[..., 1], o[..., 2]
    dx, dy, dz = d[..., 0], d[..., 1], d[..., 2]
    a = dx * dx + dy * dy
    b = 2.0 * (ox * dx + oy * dy)
    c = ox * ox + oy * oy - r * r
    disc = b * b - 4.0 * a * c
    big = a > 1e-20
    ok = (disc >= 0.0) & big
    sq = torch.sqrt(torch.clamp(disc, min=0.0))
    inv2a = 0.5 / torch.where(big, a, torch.ones_like(a))
    t0 = (-b - sq) * inv2a
    t1 = (-b + sq) * inv2a
    inf = torch.full_like(t0, INF)

    def pick(t):
        z = oz + t * dz
        return torch.where(ok & (t > tmin) & (z >= z0) & (z <= z1), t, inf)

    t = torch.minimum(pick(t0), pick(t1))
    inv_r = 1.0 / r
    n = torch.stack([(ox + t * dx) * inv_r, (oy + t * dy) * inv_r,
                     torch.zeros_like(t)], -1)
    return t, n


def ray_box(o, d, tmin, h):
    """Axis-aligned box centred at the origin with half-extents h (3,)."""
    tiny = torch.full_like(d, 1e-20)
    inv_d = 1.0 / torch.where(torch.abs(d) > 1e-20, d, tiny)
    t_lo = (-h - o) * inv_d
    t_hi = (h - o) * inv_d
    t_near_v = torch.minimum(t_lo, t_hi)
    t_far_v = torch.maximum(t_lo, t_hi)
    t_near = t_near_v.amax(-1)
    t_far = t_far_v.amin(-1)
    hit = t_near <= t_far
    inf = torch.full_like(t_near, INF)
    t_n = torch.where(hit & (t_near > tmin), t_near, inf)
    t_f = torch.where(hit & (t_far > tmin), t_far, inf)
    t = torch.minimum(t_n, t_f)
    use_near = t == t_n
    # the slab that bounds the chosen t (first index on ties, as
    # argmax / argmin); the outward normal points along it with the sign
    # of the hit point's coordinate
    axis = torch.where(use_near, torch.argmax(t_near_v, -1),
                       torch.argmin(t_far_v, -1))
    p = o + t[..., None] * d
    sgn = torch.sign(torch.gather(p, -1, axis[..., None])[..., 0])
    n = torch.stack([torch.where(axis == k, sgn, torch.zeros_like(sgn))
                     for k in range(3)], -1)
    return t, n
