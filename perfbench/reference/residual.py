"""Plain reference of the scattered light's dose: a Monte-Carlo estimate
of its expectation in coarse blocks of film voxels, in float64 PyTorch,
with its own random numbers (a torch.Generator), independent of the
program's streams.

Upstream Dr.TVAM's model of a homogeneous scattering resin, as its
configuration schema states it: a DMD pixel's ray crosses the resin on
its refracted chord (reference/transport.py `fan_segments`), the light
scatters with density sigma_s exp(-sigma_t t) along it, each scatter
sends it on in a direction drawn from the phase function (Rayleigh:
p(mu) = 3/8 (1 + mu^2)), and along every leg in the resin the film
cells absorb sigma_a exp(-sigma_t t) of it per unit length, until it
leaves the resin through a wall (the vial's walls transmit only: light
that leaves the resin does not come back). The dose of the light that
scattered at least once is that absorbed energy over the voxel volume.

The estimate: `photons` paths, their first scatter drawn over every
(chord, DMD row) with probability proportional to the pattern's value
times the chord's scattering mass amp (1 - exp(-sigma_t L)) (systematic
sampling), its height uniform in the pixel's row, its place along the
chord from the truncated exponential; then `events` forced scatters,
each leg to the resin's wall depositing its expected absorption
w (1 - albedo) (1 - exp(-sigma_t T)) at `points` stratified draws of the
truncated exponential along it, the weight going on as
w albedo (1 - exp(-sigma_t T)). A path's weight after `events` legs is
under albedo^events of its start; the rest is left out.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from .transport import fan_segments, vial_surfaces

# the schema's vial heights (mm) where a configuration gives none: the
# square vial's resin fills 0.9 of its height
HEIGHT = {"cylindrical": 40.0, "index_matched": 40.0, "square": 100.0}
FILL = {"cylindrical": 1.0, "index_matched": 1.0, "square": 0.9}


def resin_region(vial):
    """(kind, (a, b), zhalf): the resin's inner wall ('circle' (r,) or
    'box' (hx, hy)) and its half height."""
    kind, prm, _, _, ms = vial_surfaces(vial)[-1]
    assert ms == 1
    h = float(vial.get("height", HEIGHT[vial["type"]]))
    return kind, prm, 0.5 * FILL[vial["type"]] * h


def exit_distance(region, o, d):
    """Distance along d from o (inside the resin) to its wall."""
    kind, prm, zh = region
    big = torch.full_like(o[:, 0], math.inf)
    tz = torch.where(d[:, 2] > 0, (zh - o[:, 2]) / d[:, 2],
                     torch.where(d[:, 2] < 0, (-zh - o[:, 2]) / d[:, 2],
                                 big))
    if kind == "box":
        t = tz
        for k in range(2):
            tk = torch.where(d[:, k] > 0, (prm[k] - o[:, k]) / d[:, k],
                             torch.where(d[:, k] < 0,
                                         (-prm[k] - o[:, k]) / d[:, k], big))
            t = torch.minimum(t, tk)
    else:
        r = prm[0]
        a = d[:, 0] ** 2 + d[:, 1] ** 2
        b = o[:, 0] * d[:, 0] + o[:, 1] * d[:, 1]
        c = o[:, 0] ** 2 + o[:, 1] ** 2 - r * r
        disc = torch.clamp(b * b - a * c, min=0.0)
        tc = torch.where(a > 0, (-b + torch.sqrt(disc)) /
                         torch.where(a > 0, a, torch.ones_like(a)), big)
        t = torch.minimum(tz, tc)
    return torch.clamp(t, min=0.0)


def rayleigh(d, u1, u2):
    """Directions drawn around unit d by the Rayleigh phase function:
    mu solves mu^3 + 3 mu = 8 u1 - 4, the azimuth 2 pi u2."""
    c = 4.0 * (2.0 * u1 - 1.0)
    w = torch.pow(0.5 * c + torch.sqrt(0.25 * c * c + 1.0), 1.0 / 3.0)
    mu = torch.clamp(w - 1.0 / w, -1.0, 1.0)
    st = torch.sqrt(torch.clamp(1.0 - mu * mu, min=0.0))
    phi = 2.0 * math.pi * u2
    # any orthonormal pair around d
    helper = torch.where((d[:, 2].abs() < 0.9)[:, None],
                         torch.tensor([0.0, 0.0, 1.0], dtype=d.dtype,
                                      device=d.device).expand_as(d),
                         torch.tensor([1.0, 0.0, 0.0], dtype=d.dtype,
                                      device=d.device).expand_as(d))
    t1 = torch.linalg.cross(helper, d)
    t1 = t1 / t1.norm(dim=1, keepdim=True)
    t2 = torch.linalg.cross(d, t1)
    return (st * torch.cos(phi))[:, None] * t1 + \
        (st * torch.sin(phi))[:, None] * t2 + mu[:, None] * d


def _trunc_exp(u, G, sigma):
    """Draws of the exponential of rate sigma truncated to the leg whose
    mass is G = 1 - exp(-sigma T)."""
    return -torch.log1p(-u * G) / sigma


class Residual:
    """One cell's scattered-light reference: the chords, once."""

    def __init__(self, cfg, film, device, block):
        self.device = torch.device(device)
        med = cfg["vial"]["medium"]
        self.sigma = float(med["extinction"])
        self.albedo = float(med["albedo"])
        self.region = resin_region(cfg["vial"])
        proj = cfg["projector"]
        ps = proj["pixel_size"]
        self.psx, self.psy = (float(ps), float(ps)) if np.isscalar(ps) else \
            (float(ps[0]), float(ps[1]))
        self.R = int(proj["resy"])
        self.s = self.psx * self.psy * float(cfg.get("time", 1.0))
        self.A, self.U, seg = fan_segments(cfg, self.device)
        ray, o, d, L, amp, tm = seg
        self.seg_ray, self.seg_o, self.seg_d = ray, o, d
        self.seg_mass = amp * torch.exp(-self.sigma * tm) * \
            (-torch.expm1(-self.sigma * L))
        self.seg_G = -torch.expm1(-self.sigma * L)
        X, Y, Z = film["res"]
        self.bmin = torch.tensor(film["bbox_min"], dtype=torch.float64,
                                 device=self.device)
        self.bmax = torch.tensor(film["bbox_max"], dtype=torch.float64,
                                 device=self.device)
        self.vs = (self.bmax - self.bmin) / torch.tensor(
            [X, Y, Z], dtype=torch.float64, device=self.device)
        self.voxel_volume = float(torch.prod(self.vs))
        self.block = int(block)
        if X % block or Y % block or Z % block:
            raise ValueError(f"blocks of {block} do not tile the film")
        self.nb = (X // block, Y // block, Z // block)

    def blocks(self, patterns, photons, events, points, seed,
               chunk=1 << 22):
        """(NBz, NBy, NBx) float64: the scattered light's dose summed
        over each block's voxels."""
        dev = self.device
        gen = torch.Generator(device=dev)
        gen.manual_seed(int(seed) % (1 << 63))

        def rnd(n):
            return torch.rand(n, generator=gen, dtype=torch.float64,
                              device=dev)
        P = torch.as_tensor(np.asarray(patterns), device=dev)
        a_seg, u_seg = self.seg_ray // self.U, self.seg_ray % self.U
        # (segment, row) masses, rows fastest
        w = P[a_seg, :, u_seg].to(torch.float64) * self.seg_mass[:, None]
        cdf = torch.cumsum(w.reshape(-1), 0)
        del w
        total = float(cdf[-1])
        nbx, nby, nbz = self.nb
        out = torch.zeros(nbz * nby * nbx, dtype=torch.float64, device=dev)
        if total <= 0.0 or photons <= 0:
            return out.view(nbz, nby, nbx)
        w0 = self.albedo * total * self.s / photons / self.voxel_volume
        u0 = float(rnd(1))
        sig, al = self.sigma, self.albedo
        R = self.R
        bs = self.vs * self.block
        for p0 in range(0, photons, chunk):
            n = min(chunk, photons - p0)
            pos = (torch.arange(p0, p0 + n, dtype=torch.float64,
                                device=dev) + u0) * (total / photons)
            idx = torch.clamp(torch.searchsorted(cdf, pos, right=True), 0,
                              cdf.numel() - 1)
            seg, row = idx // R, idx % R
            t = _trunc_exp(rnd(n), self.seg_G[seg], sig)
            xy = self.seg_o[seg] + t[:, None] * self.seg_d[seg]
            z = (0.5 - (row.to(torch.float64) + rnd(n)) / R) * (R * self.psy)
            o = torch.cat([xy, z[:, None]], 1)
            d = torch.cat([self.seg_d[seg], torch.zeros_like(z)[:, None]], 1)
            d = rayleigh(d, rnd(n), rnd(n))
            wt = torch.full((n,), w0, dtype=torch.float64, device=dev)
            for _ in range(events):
                T = exit_distance(self.region, o, d)
                G = -torch.expm1(-sig * T)
                dep = wt * (1.0 - al) * G / points
                for j in range(points):
                    s = _trunc_exp((j + rnd(n)) / points, G, sig)
                    p = o + s[:, None] * d
                    c = torch.floor((p - self.bmin) / bs).long()
                    ok = ((p >= self.bmin) & (p < self.bmax)).all(1)
                    c = torch.minimum(c, torch.tensor(
                        [nbx - 1, nby - 1, nbz - 1], device=dev))
                    flat = (c[:, 2] * nby + c[:, 1]) * nbx + c[:, 0]
                    out.index_add_(0, flat[ok], dep[ok])
                s = _trunc_exp(rnd(n), G, sig)
                o = o + s[:, None] * d
                wt = wt * al * G
                d = rayleigh(d, rnd(n), rnd(n))
        return out.view(nbz, nby, nbx)
