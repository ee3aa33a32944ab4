"""Sampling warps (counterpart of drtvam_tpu/core/warp.py).

square_to_uniform_sphere, square_to_cosine_hemisphere (diffuse
occlusion BSDFs) and square_to_uniform_disk_concentric (projector
apertures). u is (..., 2) in [0, 1)^2; float32 throughout.
"""
from __future__ import annotations

import math

import torch

TWO_PI = 2.0 * math.pi        # rounds to float32 6.2831855 at use, as
QUARTER_PI = math.pi / 4.0    # the JAX package's python constants do
HALF_PI = math.pi / 2.0


def square_to_uniform_sphere(u):
    """(..., 2) -> unit vectors (..., 3)."""
    z = 1.0 - 2.0 * u[..., 1]
    r = torch.sqrt(torch.clamp(1.0 - z * z, min=0.0))
    phi = TWO_PI * u[..., 0]
    return torch.stack([r * torch.cos(phi), r * torch.sin(phi), z], -1)


def square_to_uniform_disk_concentric(u):
    """Concentric (Shirley) map of [0, 1)^2 to the unit disk, (..., 2)."""
    x = 2.0 * u[..., 0] - 1.0
    y = 2.0 * u[..., 1] - 1.0
    use_x = torch.abs(x) > torch.abs(y)
    r = torch.where(use_x, x, y)
    origin = (x == 0.0) & (y == 0.0)
    safe = torch.where(origin, torch.ones_like(r), r)
    ratio = torch.where(use_x, y / safe, x / safe)
    phi = torch.where(use_x, QUARTER_PI * ratio,
                      HALF_PI - QUARTER_PI * ratio)
    phi = torch.where(origin, torch.zeros_like(phi), phi)
    return torch.stack([r * torch.cos(phi), r * torch.sin(phi)], -1)


def square_to_cosine_hemisphere(u):
    """Cosine-weighted unit hemisphere (z >= 0) via the concentric disk;
    pdf = cos(theta) / pi."""
    d = square_to_uniform_disk_concentric(u)
    z = torch.sqrt(torch.clamp(
        1.0 - (d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1]), min=0.0))
    return torch.cat([d, z[..., None]], -1)
