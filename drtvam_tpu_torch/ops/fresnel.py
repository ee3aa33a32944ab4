"""Snell refraction and unpolarized Fresnel for smooth dielectrics
(counterpart of drtvam_tpu/ops/fresnel.py).

`eta` is the surface's int_ior / ext_ior; the relative IOR along a
crossing is eta from outside (cos_i > 0 against the outward normal),
else 1 / eta. Transmission weights carry the radiance factor
1 / eta_rel^2; total internal reflection gives F = 1.
"""
from __future__ import annotations

import torch


def dot3(a, b):
    """Per-row dot product of (..., 3) tensors, summed in index order
    (the CUDA kernels use the same order)."""
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + \
        a[..., 2] * b[..., 2]


def fresnel_dielectric(cos_i_abs, eta_rel):
    """Returns (F, |cos theta_t| (0 under TIR), tir)."""
    ci = torch.clamp(cos_i_abs, 0.0, 1.0)
    sin_t2 = (1.0 - ci * ci) / (eta_rel * eta_rel)
    tir = sin_t2 >= 1.0
    ct = torch.sqrt(torch.clamp(1.0 - sin_t2, min=0.0))
    r_par = (eta_rel * ci - ct) / (eta_rel * ci + ct)
    r_perp = (ci - eta_rel * ct) / (ci + eta_rel * ct)
    F = 0.5 * (r_par * r_par + r_perp * r_perp)
    F = torch.where(tir, torch.ones_like(F), F)
    return F, torch.where(tir, torch.zeros_like(ct), ct), tir


def refract(d, n, eta):
    """Refract unit directions d (..., 3) at surfaces with outward unit
    normals n and int/ext IOR ratios eta (...,).

    Returns (d_t, d_r, F, tir, eta_rel); d_t is garbage under TIR."""
    cos_i = -dot3(d, n)
    outside = cos_i > 0.0
    eta_rel = torch.where(outside, eta, 1.0 / eta)
    nl = torch.where(outside[..., None], n, -n)
    ci = torch.abs(cos_i)
    F, ct, tir = fresnel_dielectric(ci, eta_rel)
    inv_eta = 1.0 / eta_rel
    d_t = inv_eta[..., None] * d + (inv_eta * ci - ct)[..., None] * nl
    d_r = d + (2.0 * ci)[..., None] * nl
    return d_t, d_r, F, tir, eta_rel
