"""Homogeneous medium and phase functions (counterpart of
drtvam_tpu/ops/medium.py).

    free flight    t  = -log(1 - u) / sigma_t
    transmittance  Tr = exp(-sigma_t * t)

Phase sampling is perfect importance sampling (weight 1): cos(theta)
from the named phase function, the azimuth uniform, around the current
direction d with a branchless orthonormal basis.
"""
from __future__ import annotations

import torch

from ..core.warp import TWO_PI

# float32(1 - 1e-7), the clip of every free-flight draw
U_MAX = 1.0 - 1e-7

# registry: name -> sample_cos(u, g) returning cos(theta); PHASE_IDS
# numbers them for the CUDA kernels (csrc/wf_trace.cuh)
phase_functions = {}
PHASE_IDS = {}


def register_phase(name, fn):
    PHASE_IDS.setdefault(name, len(PHASE_IDS))
    phase_functions[name] = fn


def _rayleigh_cos(u, g):
    # invert the Rayleigh CDF: x^3 + 3x = 8u - 4 (Cardano, x = w - 1/w).
    # The cube root's argument is positive; torch has no cbrt, so it is
    # pow(., 1/3), as in the kernel (ulps from the JAX package's cbrt).
    c = 4.0 * (2.0 * u - 1.0)
    w = torch.pow(c / 2.0 + torch.sqrt(c * c / 4.0 + 1.0), 1.0 / 3.0)
    return torch.clamp(w - 1.0 / w, -1.0, 1.0)


def _hg_cos(u, g):
    g = torch.as_tensor(g, dtype=torch.float32, device=u.device)
    sqr = (1.0 - g * g) / (1.0 - g + 2.0 * g * u)
    cos_iso = 1.0 - 2.0 * u
    cos_hg = (1.0 + g * g - sqr * sqr) / \
        (2.0 * torch.where(g == 0.0, torch.ones_like(g), g))
    return torch.clamp(torch.where(g == 0.0, cos_iso, cos_hg), -1.0, 1.0)


def _isotropic_cos(u, g):
    return 1.0 - 2.0 * u


def _forward_delta_cos(u, g):
    # always continue straight ahead (the reference's delta_phase test)
    return torch.ones_like(u)


register_phase("rayleigh", _rayleigh_cos)
register_phase("hg", _hg_cos)
register_phase("isotropic", _isotropic_cos)
register_phase("forward_delta", _forward_delta_cos)


def build_onb(d):
    """Branchless orthonormal basis (t1, t2) around unit vectors d."""
    s = torch.where(d[..., 2] >= 0.0, 1.0, -1.0).to(d.dtype)
    a = -1.0 / (s + d[..., 2])
    b = d[..., 0] * d[..., 1] * a
    t1 = torch.stack([1.0 + s * (d[..., 0] * d[..., 0]) * a, s * b,
                      -s * d[..., 0]], -1)
    t2 = torch.stack([b, s + (d[..., 1] * d[..., 1]) * a, -d[..., 1]], -1)
    return t1, t2


def sample_phase_direction(phase_name, g, d, u1, u2):
    """Outgoing unit directions (..., 3) around forward axes d: u1
    drives cos(theta) through the named phase function, u2 the
    azimuth."""
    cos_t = phase_functions[phase_name](u1, g)
    sin_t = torch.sqrt(torch.clamp(1.0 - cos_t * cos_t, min=0.0))
    phi = TWO_PI * u2
    t1, t2 = build_onb(d)
    return (sin_t * torch.cos(phi))[..., None] * t1 + \
        (sin_t * torch.sin(phi))[..., None] * t2 + cos_t[..., None] * d


def sample_free_flight(u, sigma_t):
    """Exponential free-flight distance; u in [0, 1), sigma_t a tensor."""
    return -torch.log1p(-torch.clamp(u, 0.0, U_MAX)) / sigma_t


def transmittance(sigma_t, t):
    return torch.exp(-sigma_t * t)
