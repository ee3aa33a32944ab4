"""Per-angle 2D transport fields for the ballistic path and the
in-medium chord bank of the hybrid engine (counterpart of
drtvam_tpu/ops/transport2d.py:40-92, :273-377 and :380-430).

For a collimated projector orbiting a z-invariant vial, a ray's (x, y)
trajectory does not depend on its DMD row, so the volumetric transport
factors into

    dose(z, y, x) = sum_a  W_a(y, x) * P_a(z_row, u_map_a(y, x))

with W_a the per-cell absorbed-dose weight of angle a's 2D ray fan and
u_map_a the fractional DMD column feeding that cell. The fields come
from the host C++ rasterizer (native.rasterize_fan), the only builder
in the port: the JAX package's jitted device builder is not ported.
The chord bank (`build_chords`) is the same 2D fan traced once more,
recording each ray's in-medium segments instead of rasterizing them;
plain torch, built where the scene's tensors are (the host).
"""
from __future__ import annotations

import dataclasses

import math

import numpy as np
import torch

from ..models.geometry import DIELECTRIC, MESH, NULL
from ..native import rasterize_fan
from .fresnel import dot3, refract
from .march import MarchStatic, intersect_scene


def unscattered_eligible(static: MarchStatic) -> bool:
    """Can the unscattered transport be precomputed as per-angle 2D
    fields? Collimated projector, analytic vials, transmission-only
    BSDFs; a null-BSDF target mesh is allowed (it only selects the
    deposit channel)."""
    return (
        static.mode == "volume"
        and static.projector.kind == "collimated"
        and static.transmission_only
        and all(s.kind != MESH or (s.is_target and s.bsdf == NULL)
                for s in static.surfaces)
    )


def ballistic_eligible(static: MarchStatic) -> bool:
    """Unscattered-precomputable geometry, pure absorption, dda
    estimator: the whole render is the backprojection."""
    return (
        unscattered_eligible(static)
        and not static.has_scattering
        and static.sensor.estimator == "dda"
    )


def strip_target(static: MarchStatic, arr):
    """Remove target surfaces (no-ops for ballistic rays) so the 2D
    trace only sees the z-invariant interfaces."""
    keep = [i for i, s in enumerate(static.surfaces) if not s.is_target]
    if len(keep) == len(static.surfaces):
        return static, arr
    idx = np.asarray(keep)
    static2 = dataclasses.replace(
        static, surfaces=tuple(static.surfaces[i] for i in keep))
    arr2 = dict(arr)
    arr2["surf_params"] = arr["surf_params"][idx]
    arr2["surf_eta"] = arr["surf_eta"][idx]
    if "surf_refl" in arr:
        arr2["surf_refl"] = arr["surf_refl"][idx]
    return static2, arr2


def build_transport(static: MarchStatic, arr, supersample: int = 1):
    """(W, UW) numpy float32 (A, Y, X) fields of the 2D ray fan.

    Folded into W: per-cell (sigma_a/sigma_t) exp(-st t)(1 - exp(-st dt))
    Beer-Lambert absorption and the Fresnel transmission products. The
    ray-weight scalar and 1/voxel_volume are applied by the engine."""
    return rasterize_fan(static, arr, supersample)


def build_chords(static: MarchStatic, arr, K: int = 2):
    """Per-(angle, DMD column) in-medium chord bank of the forced
    first-scatter residual (march `_first_scatter_from_chords`).

    For z-invariant transmission-only geometry a pixel's in-medium
    trajectory is a fixed 2D polyline, independent of its DMD row and of
    the pattern. Traced here once per (a, u) at the column centre: up to
    K straight medium segments with entry point, direction, length and
    the Fresnel amplitude at entry. Target surfaces must be stripped
    first (`strip_target`): after that every surface is a vial wall, so
    each in-medium intersection step is one whole segment.

    arr: the scene's tensors (`march.scene_tensors`). Returns float32
    tensors seg_o (A*U, K, 2), seg_d (A*U, K, 2), seg_L (A*U, K) (0 for
    absent segments) and seg_amp (A*U, K)."""
    p = static.projector
    A, U = p.n_patterns, p.resx
    n = A * U
    dev = arr["surf_params"].device
    f32 = dict(dtype=torch.float32, device=dev)

    lane = torch.arange(n, dtype=torch.int64, device=dev)
    a_idx = (lane // U).to(torch.float32)
    u_idx = (lane % U).to(torch.float32)
    alpha = 2.0 * math.pi * a_idx / A
    if static.clockwise:
        alpha = -alpha
    dist = arr["motion_distance"]
    origin = dist * torch.stack([torch.cos(alpha), torch.sin(alpha),
                                 torch.zeros_like(alpha)], -1)
    dirw = -origin / dist
    up = torch.zeros_like(dirw)
    up[:, 2] = 1.0
    left = torch.linalg.cross(up, dirw)
    left = left / torch.linalg.norm(left, dim=-1, keepdim=True)
    ex = U * arr["pixel_size"][0]
    cam_x = (0.5 - (u_idx + 0.5) / U) * ex
    o = origin + cam_x[:, None] * left
    d = dirw

    bsdf_kind = torch.tensor([s.bsdf for s in static.surfaces], device=dev)
    med_side = torch.tensor([s.medium_side for s in static.surfaces],
                            device=dev)
    amp = torch.ones((n,), **f32)
    in_medium = torch.zeros((n,), dtype=torch.bool, device=dev)
    active = torch.ones((n,), dtype=torch.bool, device=dev)
    sg_o = torch.zeros((n, K, 2), **f32)
    sg_d = torch.zeros((n, K, 2), **f32)
    sg_L = torch.zeros((n, K), **f32)
    sg_amp = torch.zeros((n, K), **f32)
    cnt = torch.zeros((n,), dtype=torch.int64, device=dev)
    slots = torch.arange(K, device=dev)
    zeros, ones = torch.zeros((n,), **f32), torch.ones((n,), **f32)
    for _ in range(2 * len(static.surfaces) + 2):
        if not bool(active.any()):
            break
        t_si, n_si, sid, valid = intersect_scene(static, arr, o, d, active)
        active = active & valid
        seg = in_medium & active & (cnt < K)
        onehot = (slots[None, :] == torch.clamp(cnt, max=K - 1)[:, None]) \
            & seg[:, None]
        sg_o = torch.where(onehot[..., None], o[:, None, :2], sg_o)
        sg_d = torch.where(onehot[..., None], d[:, None, :2], sg_d)
        sg_L = torch.where(onehot, t_si[:, None], sg_L)
        sg_amp = torch.where(onehot, amp[:, None], sg_amp)
        cnt = cnt + seg.to(torch.int64)

        sid0 = torch.clamp(sid, min=0)
        kind = bsdf_kind[sid0]
        d_t, _, F, tir, eta_rel = refract(d, n_si, arr["surf_eta"][sid0])
        w_diel = torch.where(tir, zeros, (1.0 - F) / (eta_rel * eta_rel))
        is_diel = kind == DIELECTRIC
        w = torch.where(is_diel, w_diel, torch.where(kind == NULL, ones,
                                                     zeros))
        d_new = torch.where(is_diel[:, None], d_t, d)
        o = torch.where(active[:, None], o + t_si[:, None] * d, o)
        d = torch.where(active[:, None], d_new, d)
        amp = torch.where(active, amp * w, amp)

        ms = med_side[sid0]
        dn = dot3(d, n_si)
        enters = ((ms == 1) & (dn < 0.0)) | ((ms == 2) & (dn > 0.0))
        in_medium = active & enters
        active = active & (amp > 0.0)
    return sg_o, sg_d, sg_L, sg_amp


def chord_pack(seg_o, seg_d, seg_L, seg_amp):
    """The bank as one (A*U, 12) float32 record per (angle, column), so
    that a lane reads one record: the K = 2 segments' entry points
    (x0, y0, x1, y1), directions (4), lengths (2) and amplitudes (2),
    laid out as drtvam_tpu/ops/hybrid.py:126-131 lays it out."""
    n = seg_L.shape[0]
    return torch.cat([seg_o.reshape(n, 4), seg_d.reshape(n, 4), seg_L,
                      seg_amp], 1).to(torch.float32)


def build_z_resample(static: MarchStatic, arr):
    """(Zf, resy) binning matrix from DMD rows to film z-rows (numpy).

    Row r's collimated rays travel at z = (0.5 - (r+0.5)/resy) * ey.
    Regular sampling deposits the whole row into the voxel containing
    that z; jittered sampling splits it by the pixel footprint's box
    overlap with each voxel (the expectation of the reference's MC
    jitter)."""
    p = static.projector
    resy = p.resy
    _, _, Z = static.sensor.res
    psize = np.asarray(arr["pixel_size"])
    bmin = np.asarray(arr["bbox_min"])
    bmax = np.asarray(arr["bbox_max"])
    ey = resy * np.float32(psize[1])
    bz0 = float(bmin[2])
    bz1 = float(bmax[2])
    vs_z = (bz1 - bz0) / Z
    ph = float(ey) / resy  # pixel z-footprint
    Sz = np.zeros((Z, resy), np.float32)
    for r in range(resy):
        z_r = (0.5 - (r + 0.5) / resy) * float(ey)
        if static.regular_sampling:
            k = int(np.floor((z_r - bz0) / vs_z))
            if 0 <= k < Z:
                Sz[k, r] = 1.0
        else:
            lo, hi = z_r - 0.5 * ph, z_r + 0.5 * ph
            k0 = int(np.floor((lo - bz0) / vs_z))
            k1 = int(np.floor((hi - bz0) / vs_z + 1.0))
            for k in range(max(k0, 0), min(k1 + 1, Z)):
                vlo, vhi = bz0 + k * vs_z, bz0 + (k + 1) * vs_z
                ov = max(0.0, min(hi, vhi) - max(lo, vlo)) / ph
                if ov > 0:
                    Sz[k, r] = ov
    return Sz
