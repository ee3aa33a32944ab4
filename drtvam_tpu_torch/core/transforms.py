"""Minimal 3D transform math on torch tensors (counterpart of
drtvam_tpu/core/transforms.py).

Mitsuba's Transform4f.look_at frame: dir = normalize(target - origin),
left = normalize(cross(up, dir)), up2 = cross(dir, left), with columns
[left, up2, dir | origin]. Everything is float32, shaped (..., 3).
"""
from __future__ import annotations

import torch


def normalize(v, dim=-1, eps=0.0):
    n = torch.linalg.norm(v, dim=dim, keepdim=True)
    if eps:
        n = torch.clamp(n, min=eps)
    return v / n


def look_at(origin, target, up):
    """Return (R, t): world-from-camera rotation (columns left, up2,
    dir) and translation, batched over the leading dims of origin."""
    origin = torch.as_tensor(origin, dtype=torch.float32)
    target = torch.as_tensor(target, dtype=torch.float32,
                             device=origin.device)
    up = torch.as_tensor(up, dtype=torch.float32, device=origin.device)
    d = normalize(target - origin)
    left = normalize(torch.linalg.cross(up.expand_as(d), d))
    up2 = torch.linalg.cross(d, left)
    R = torch.stack([left, up2, d], dim=-1)
    return R, origin


def apply_rt_point(R, t, p):
    return torch.einsum("...ij,...j->...i", R, p) + t


def apply_rt_vector(R, v):
    return torch.einsum("...ij,...j->...i", R, v)


def rotz(angle):
    """Rotation matrix about +z by `angle` (radians). Batched."""
    c, s = torch.cos(angle), torch.sin(angle)
    z = torch.zeros_like(c)
    o = torch.ones_like(c)
    return torch.stack(
        [torch.stack([c, -s, z], -1),
         torch.stack([s, c, z], -1),
         torch.stack([z, z, o], -1)], -2)
