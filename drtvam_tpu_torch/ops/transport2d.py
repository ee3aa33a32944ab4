"""Per-angle 2D transport fields for the ballistic path (counterpart of
drtvam_tpu/ops/transport2d.py:40-92 and :380-430).

For a collimated projector orbiting a z-invariant vial, a ray's (x, y)
trajectory does not depend on its DMD row, so the volumetric transport
factors into

    dose(z, y, x) = sum_a  W_a(y, x) * P_a(z_row, u_map_a(y, x))

with W_a the per-cell absorbed-dose weight of angle a's 2D ray fan and
u_map_a the fractional DMD column feeding that cell. The fields come
from the host C++ rasterizer (native.rasterize_fan), the only builder
in the port: the JAX package's jitted device builder is not ported.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from ..models.geometry import MESH, NULL
from ..native import rasterize_fan
from .march import MarchStatic


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
