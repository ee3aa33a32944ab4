"""Plain reference of the unscattered transport of a collimated projector
orbiting a z-invariant vial, in float64 PyTorch.

Upstream Dr.TVAM's model, as its configuration schema states it: a DMD
pixel (row r, column u) of pattern a sends a ray from the projector at
distance `distance` and angle 2 pi a / n_patterns (negated when
clockwise) towards the vial's axis, offset sideways by
(1/2 - (u + 1/2) / resx) * resx * pixel_size and lifted to the row's
height. The vial's walls are analytic cylinders or boxes; a dielectric
wall refracts the ray (Snell) and passes the unpolarized Fresnel
transmittance over the square of the relative index, a null wall passes
it unchanged. Inside the resin the ray loses exp(-sigma_t s) and each
film cell it crosses absorbs (1 - albedo) exp(-sigma_t s0)
(1 - exp(-sigma_t ds)) of it.

Since every ray stays in its row's plane, the dose factors into
per-angle 2D fields (the ballistic model of the port and of the JAX
package): W_a(y, x), the light a cell of angle a absorbs from the whole
fan, and u_a(y, x), the mean DMD column of that light, weighted by it.
A cell's dose is then W_a times the pattern's row, resampled onto the
film's z rows by the pixels' box overlap and read at u_a by linear
interpolation between columns. `fan_fields` traces the fan and clips
each in-resin segment to the film cells it crosses (every crossing of
a grid line, sorted); `z_resample` and `dose` do the rest.

Nothing here reads the program: the vial comes from the configuration
file, the rays from the projector's keys.
"""
from __future__ import annotations

import math

import numpy as np
import torch

IOR_AIR = 1.000277          # the schema's "air", the outer medium
EPS = 1e-4                  # a hit nearer than this is the surface left


def vial_surfaces(vial):
    """[(kind, params, bsdf, eta, medium_side)], outermost first: kind
    'circle' (radius,) or 'box' (hx, hy); bsdf 'dielectric' or 'null';
    eta the inside's index over the outside's; medium_side 1 when the
    resin is inside."""
    med = vial["medium"]
    t = vial["type"]
    if t == "cylindrical":
        return [("circle", (vial["r_ext"],), "dielectric",
                 vial["ior"] / IOR_AIR, 0),
                ("circle", (vial["r_int"],), "dielectric",
                 med["ior"] / vial["ior"], 1)]
    if t == "index_matched":
        return [("circle", (vial["r"],), "null", 1.0, 1)]
    if t == "square":
        return [("box", (0.5 * vial["w_ext"], 0.5 * vial["w_ext"]),
                 "dielectric", vial["ior"] / IOR_AIR, 0),
                ("box", (0.5 * vial["w_int"], 0.5 * vial["w_int"]),
                 "dielectric", med["ior"] / vial["ior"], 1)]
    raise ValueError(f"no reference for a '{t}' vial")


def _hit_circle(o, d, r):
    a = (d * d).sum(-1)
    b = 2.0 * (o * d).sum(-1)
    c = (o * o).sum(-1) - r * r
    disc = b * b - 4.0 * a * c
    sq = torch.sqrt(torch.clamp(disc, min=0.0))
    t0 = (-b - sq) / (2.0 * a)
    t1 = (-b + sq) / (2.0 * a)
    inf = torch.full_like(t0, math.inf)
    t = torch.where(t0 > EPS, t0, torch.where(t1 > EPS, t1, inf))
    t = torch.where(disc < 0.0, inf, t)
    p = o + torch.where(torch.isfinite(t), t, 0.0)[:, None] * d
    return t, p / r


def _hit_box(o, d, hx, hy):
    tiny = torch.finfo(o.dtype).tiny
    big = torch.finfo(o.dtype).max
    dx = torch.where(d[:, 0].abs() > tiny, d[:, 0],
                     torch.full_like(d[:, 0], tiny))
    dy = torch.where(d[:, 1].abs() > tiny, d[:, 1],
                     torch.full_like(d[:, 1], tiny))
    tx0, tx1 = (-hx - o[:, 0]) / dx, (hx - o[:, 0]) / dx
    ty0, ty1 = (-hy - o[:, 1]) / dy, (hy - o[:, 1]) / dy
    tnx, tfx = torch.minimum(tx0, tx1), torch.maximum(tx0, tx1)
    tny, tfy = torch.minimum(ty0, ty1), torch.maximum(ty0, ty1)
    tn, tf = torch.maximum(tnx, tny), torch.minimum(tfx, tfy)
    near = tn > EPS
    t = torch.where(near, tn, tf)
    inf = torch.full_like(t, math.inf)
    t = torch.where((tn > tf) | (~near & ~(tf > EPS)) | (t > big), inf, t)
    x_axis = torch.where(near, tnx >= tny, tfx <= tfy)
    p = o + torch.where(torch.isfinite(t), t, 0.0)[:, None] * d
    one = torch.ones_like(t)
    nx = torch.where(x_axis, torch.where(p[:, 0] >= 0, one, -one), 0 * one)
    ny = torch.where(x_axis, 0 * one, torch.where(p[:, 1] >= 0, one, -one))
    return t, torch.stack([nx, ny], -1)


def _refract(d, n, eta):
    """Transmitted direction and weight (1 - F) / eta_rel^2; 0 on total
    internal reflection."""
    cos_i = -(d * n).sum(-1)
    outside = cos_i > 0.0
    er = torch.where(outside, torch.full_like(cos_i, eta),
                     torch.full_like(cos_i, 1.0 / eta))
    nl = torch.where(outside[:, None], n, -n)
    ci = cos_i.abs()
    s2 = (1.0 - ci * ci) / (er * er)
    tir = s2 >= 1.0
    ct = torch.sqrt(torch.clamp(1.0 - s2, min=0.0))
    rpar = (er * ci - ct) / (er * ci + ct)
    rper = (ci - er * ct) / (ci + er * ct)
    F = 0.5 * (rpar * rpar + rper * rper)
    w = torch.where(tir, torch.zeros_like(F), (1.0 - F) / (er * er))
    dt = d / er[:, None] + (ci / er - ct)[:, None] * nl
    return dt, w


def fan_segments(cfg, device):
    """Trace the A x U fan in float64. Returns the in-resin segments: ray
    index (a * U + u), entry point, direction, length, amplitude at entry
    and the resin path before it."""
    proj = cfg["projector"]
    A, U = int(proj["n_patterns"]), int(proj["resx"])
    ps = proj["pixel_size"]
    f32 = np.float32
    psx = f32(ps if np.isscalar(ps) else ps[0])
    D = f32(proj["distance"])
    cw = bool(proj.get("clockwise", False))
    alpha = 2.0 * np.pi * np.arange(A) / A
    if cw:
        alpha = -alpha
    # the rays' set-up in float32, the precision the schema's numbers
    # have; a direction component under 1e-9 is taken as 0 (the ray runs
    # along the film's grid, and lies in the cells on its + side)
    ca, sa = np.cos(alpha).astype(f32), np.sin(alpha).astype(f32)
    s_u = ((np.arange(U, dtype=f32) + f32(0.5)) / f32(U)).astype(f32)
    cam = ((f32(0.5) - s_u) * f32(U * psx)).astype(f32)
    ox = (D * ca)[:, None] + cam[None, :] * sa[:, None]
    oy = (D * sa)[:, None] - cam[None, :] * ca[:, None]
    dx = np.array(np.broadcast_to(-ca[:, None], ox.shape))
    dy = np.array(np.broadcast_to(-sa[:, None], ox.shape))
    dx[np.abs(dx) < 1e-9] = 0.0
    dy[np.abs(dy) < 1e-9] = 0.0
    f64 = dict(dtype=torch.float64, device=device)
    o = torch.stack([torch.tensor(ox, **f64).reshape(-1),
                     torch.tensor(oy, **f64).reshape(-1)], -1)
    d = torch.stack([torch.tensor(dx, **f64).reshape(-1),
                     torch.tensor(dy, **f64).reshape(-1)], -1)
    surfs = vial_surfaces(cfg["vial"])
    n = o.shape[0]
    amp = torch.ones(n, **f64)
    t_med = torch.zeros(n, **f64)
    inside = torch.zeros(n, dtype=torch.bool, device=device)
    alive = torch.ones(n, dtype=torch.bool, device=device)
    ray = torch.arange(n, device=device)
    segs = []
    for _ in range(2 * len(surfs) + 2):
        best_t = torch.full((n,), math.inf, **f64)
        best_n = torch.zeros((n, 2), **f64)
        best_s = torch.full((n,), -1, dtype=torch.long, device=device)
        for k, (kind, prm, _, _, _) in enumerate(surfs):
            if kind == "circle":
                t, nrm = _hit_circle(o, d, prm[0])
            else:
                t, nrm = _hit_box(o, d, prm[0], prm[1])
            closer = t < best_t
            best_t = torch.where(closer, t, best_t)
            best_n = torch.where(closer[:, None], nrm, best_n)
            best_s = torch.where(closer, torch.full_like(best_s, k), best_s)
        alive = alive & (best_s >= 0)
        rec = alive & inside & (amp > 0.0)
        if rec.any():
            segs.append((ray[rec], o[rec], d[rec], best_t[rec], amp[rec],
                         t_med[rec]))
        t_med = torch.where(alive & inside, t_med + best_t, t_med)
        step = torch.where(alive, best_t, torch.zeros_like(best_t))
        o = o + step[:, None] * d
        new_d, w = d.clone(), torch.zeros_like(amp)
        for k, (_, _, bsdf, eta, ms) in enumerate(surfs):
            on = alive & (best_s == k)
            if bsdf == "dielectric":
                dk, wk = _refract(d, best_n, eta)
            else:
                dk, wk = d, torch.ones_like(amp)
            new_d = torch.where(on[:, None], dk, new_d)
            w = torch.where(on, wk, w)
            dn = (dk * best_n).sum(-1)
            ent = (dn < 0.0) if ms == 1 else (dn > 0.0) if ms == 2 else \
                torch.zeros_like(on)
            inside = torch.where(on, ent, inside)
        d = torch.where(alive[:, None], new_d, d)
        amp = torch.where(alive, amp * w, amp)
        alive = alive & (amp > 0.0)
        if not alive.any():
            break
    cat = [torch.cat(x) for x in zip(*segs)] if segs else None
    return A, U, cat


def fan_fields(cfg, film, device, chunk=16384):
    """(W, UW, SPAN) (A, Y, X) float64: per angle, the light each film
    cell absorbs from the fan, that light times its DMD column, and the
    spread of the columns whose rays cross the cell (largest less
    least)."""
    med = cfg["vial"]["medium"]
    sigma, albedo = float(med["extinction"]), float(med["albedo"])
    X, Y, _ = film["res"]
    bmin = [float(v) for v in film["bbox_min"][:2]]
    bmax = [float(v) for v in film["bbox_max"][:2]]
    vs = [(bmax[0] - bmin[0]) / X, (bmax[1] - bmin[1]) / Y]
    A, U, seg = fan_segments(cfg, device)
    dtype = torch.float64
    W = torch.zeros(A * Y * X, dtype=dtype, device=device)
    UW = torch.zeros_like(W)
    UMIN = torch.full_like(W, math.inf)
    UMAX = torch.full_like(W, -math.inf)
    if seg is None:
        return W.view(A, Y, X), UW.view(A, Y, X), W.view(A, Y, X)
    ray, o, d, L, amp, tm = seg
    gx = bmin[0] + vs[0] * torch.arange(X + 1, dtype=dtype, device=device)
    gy = bmin[1] + vs[1] * torch.arange(Y + 1, dtype=dtype, device=device)
    tiny = torch.finfo(dtype).tiny
    for s in range(0, ray.shape[0], chunk):
        r, oo, dd = ray[s:s + chunk], o[s:s + chunk], d[s:s + chunk]
        LL, aa, tt = L[s:s + chunk], amp[s:s + chunk], tm[s:s + chunk]
        dx = torch.where(dd[:, 0] == 0, torch.full_like(LL, tiny), dd[:, 0])
        dy = torch.where(dd[:, 1] == 0, torch.full_like(LL, tiny), dd[:, 1])
        tx = (gx[None, :] - oo[:, :1]) / dx[:, None]
        ty = (gy[None, :] - oo[:, 1:]) / dy[:, None]
        t_in = torch.clamp(torch.maximum(torch.minimum(tx[:, 0], tx[:, -1]),
                                         torch.minimum(ty[:, 0], ty[:, -1])),
                           min=0.0)
        t_out = torch.minimum(torch.minimum(torch.maximum(tx[:, 0], tx[:, -1]),
                                            torch.maximum(ty[:, 0],
                                                          ty[:, -1])), LL)
        T = torch.cat([tx, ty, t_in[:, None], t_out[:, None]], 1)
        keep = (T >= t_in[:, None]) & (T <= t_out[:, None]) & \
            (t_in < t_out)[:, None]
        T = torch.where(keep, T, torch.full_like(T, math.inf)).sort(1).values
        t0, t1 = T[:, :-1], T[:, 1:]
        ok = torch.isfinite(t1) & (t1 > t0)
        t0 = torch.where(ok, t0, torch.zeros_like(t0))
        dt = torch.where(ok, t1 - t0, torch.zeros_like(t0))
        mid = t0 + 0.5 * dt
        px = oo[:, :1] + mid * dd[:, :1]
        py = oo[:, 1:] + mid * dd[:, 1:]
        cx = torch.clamp(((px - bmin[0]) / vs[0]).floor().long(), 0, X - 1)
        cy = torch.clamp(((py - bmin[1]) / vs[1]).floor().long(), 0, Y - 1)
        c = (aa * (1.0 - albedo))[:, None] * torch.exp(
            -sigma * (tt[:, None] + t0)) * (-torch.expm1(-sigma * dt))
        c = torch.where(ok, c, torch.zeros_like(c))
        a_idx = (r // U)[:, None]
        u_val = (r % U).to(dtype)[:, None]
        flat = (a_idx * Y + cy) * X + cx
        W.index_add_(0, flat.reshape(-1), c.reshape(-1))
        UW.index_add_(0, flat.reshape(-1), (c * u_val).reshape(-1))
        lit = c > 0
        fl = flat.expand_as(c)[lit]
        uv = u_val.expand_as(c)[lit]
        UMIN.scatter_reduce_(0, fl, uv, "amin")
        UMAX.scatter_reduce_(0, fl, uv, "amax")
    span = torch.where(W > 0, UMAX - UMIN, torch.zeros_like(W))
    return W.view(A, Y, X), UW.view(A, Y, X), span.view(A, Y, X)


def z_resample(cfg, film):
    """(Z, resy) float64: DMD row r's share in film row k, the box
    overlap of the pixel's height [z_r -+ h/2] with the row (the expected
    value of a jittered ray's height), or the row holding z_r where the
    rays leave the pixel centres (`regular_sampling`)."""
    proj = cfg["projector"]
    R = int(proj["resy"])
    ps = proj["pixel_size"]
    psy = float(ps if np.isscalar(ps) else ps[1])
    Z = film["res"][2]
    z0, z1 = float(film["bbox_min"][2]), float(film["bbox_max"][2])
    vz = (z1 - z0) / Z
    zr = (0.5 - (np.arange(R) + 0.5) / R) * (R * psy)
    lo = z0 + vz * np.arange(Z)
    if cfg.get("regular_sampling", False):
        k = np.floor((zr - z0) / vz).astype(int)
        S = np.zeros((Z, R))
        ok = (k >= 0) & (k < Z)
        S[k[ok], np.nonzero(ok)[0]] = 1.0
        return S
    ov = np.minimum(zr[None, :] + 0.5 * psy, lo[:, None] + vz) - \
        np.maximum(zr[None, :] - 0.5 * psy, lo[:, None])
    return np.clip(ov, 0.0, None) / psy
