"""Ray intersection (counterpart of drtvam_tpu/ops/intersect.py): the
open z-aligned cylinder tube of the vial walls, the axis-aligned box of
square vials and a bank of triangles (the target mesh; brute force here,
the uniform grid in ops/mesh_grid.py).

Batched over rays, branchless, t = +inf on a miss; normals are
geometric and outward (the BSDF layer handles sidedness).
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


def fma(a, b, c):
    """a * b + c rounded once to float32, as a fused multiply-add (the
    CUDA kernels' fmaf, XLA's on the CPU). The product of two float32
    values is exact in float64, and so is the float64 sum's rounding
    error (TwoSum). Rounding the float64 sum to float32 rounds the
    exact value once, except where that sum lies exactly halfway
    between two float32 values (or in float32's subnormal range) while
    the exact sum does not: rounding twice would then break the tie to
    even and miss fmaf by an ulp (as on a few pixels of the telecentric
    bench radon render, PERF.md section 6). There the float64 sum is
    rounded to odd
    (an inexact even sum moves one float64 ulp toward the exact sum),
    which makes the float32 rounding exact."""
    p = a.double() * b.double()
    c = c.double()
    s = p + c
    bb = s - p
    err = (p - (s - bb)) + (c - bb)
    inexact = err != 0.0
    # a float32 tie: the 29 bits below float32's precision are 1000...0
    tie = (s.view(torch.int64) & 0x1FFFFFFF) == 0x10000000
    if bool((inexact & (tie | (s.abs() < 2.0 ** -125))).any()):
        odd = (s.view(torch.int64) & 1) == 1
        toward = torch.where(err > 0.0, torch.full_like(s, INF),
                             torch.full_like(s, -INF))
        s = torch.where(inexact & ~odd, torch.nextafter(s, toward), s)
    return s.float()


def cross_fma(a, b):
    """The cross product as the JAX package's jnp.cross computes it on
    the CPU, where XLA contracts each component a1 b2 - a2 b1 into
    fma(a1, b2, -(a2 b1))."""
    a0, a1, a2 = a[..., 0], a[..., 1], a[..., 2]
    b0, b1, b2 = b[..., 0], b[..., 1], b[..., 2]
    return torch.stack([fma(a1, b2, -(a2 * b1)), fma(a2, b0, -(a0 * b2)),
                        fma(a0, b1, -(a1 * b0))], -1)


def dot_fma(a, b):
    """Sum over the last axis of size 3 as XLA computes jnp.sum(a * b)
    on the CPU: fma(a2, b2, fma(a1, b1, a0 b0))."""
    return fma(a[..., 2], b[..., 2],
               fma(a[..., 1], b[..., 1], a[..., 0] * b[..., 0]))


def moller_trumbore(o, d, tmin, a0, a1, a2, valid=None):
    """Moller-Trumbore of rays o, d (N, 3) against triangles a0 = v0,
    a1 = e1, a2 = e2, each (C, 3) (shared) or (N, C, 3) (per ray): the
    hit distance (N, C), +inf where the ray misses, the determinant is
    below 1e-12, the hit is not beyond tmin (N,) or valid (N, C) is
    false. The float32 operations of drtvam_tpu/ops/intersect.py:101-114
    in their order (multiplications by 1 / det), the cross products and
    the three-term sums fused as XLA fuses them on the CPU (cross_fma,
    dot_fma), so that t agrees bitwise with the JAX package's."""
    d3, o3 = d[:, None, :], o[:, None, :]
    pvec = cross_fma(d3, a2)
    det = dot_fma(a1, pvec)
    ok = torch.abs(det) > 1e-12
    inv_det = 1.0 / torch.where(ok, det, torch.ones_like(det))
    tvec = o3 - a0
    u = dot_fma(tvec, pvec) * inv_det
    qvec = cross_fma(tvec, a1)
    v = dot_fma(d3, qvec) * inv_det
    t = dot_fma(a2, qvec) * inv_det
    ok = ok & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0) & \
        (t > tmin[:, None])
    if valid is not None:
        ok = ok & valid
    return torch.where(ok, t, torch.full_like(t, INF))


def ray_triangles(o, d, tmin, v0, e1, e2, chunk=8):
    """Nearest hit of rays o, d (N, 3), beyond tmin (N,), against a
    triangle bank (T, 3) arrays, scanned in `chunk`-wide blocks: (t,
    tri), t = +inf and tri = -1 on a miss. On equal t the first triangle
    in bank order wins, as in the JAX package (argmin within a block,
    a strict < across blocks)."""
    n = o.shape[0]
    t_best = torch.full((n,), INF, dtype=torch.float32, device=o.device)
    i_best = torch.full((n,), -1, dtype=torch.int64, device=o.device)
    for s in range(0, v0.shape[0], chunk):
        t = moller_trumbore(o, d, tmin, v0[s:s + chunk], e1[s:s + chunk],
                            e2[s:s + chunk])
        j = torch.argmin(t, -1)
        t_c = torch.gather(t, -1, j[:, None])[:, 0]
        better = t_c < t_best
        t_best = torch.where(better, t_c, t_best)
        i_best = torch.where(better, s + j, i_best)
    return t_best, i_best
