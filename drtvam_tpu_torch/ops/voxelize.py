"""Mesh voxelization (counterpart of drtvam_tpu/ops/voxelize.py).

Binary occupancy by voxel-center crossing parity along z-columns, and
the surface-aware inside / outside fractional volumes (exact along z by
parity intervals, supersampled oversample^2 in xy), both run by the host
C++ voxelizer (the port's copy, csrc/host/mesh_accel.cpp, modes 0 and
1) — the only path: a failed build raises.
"""
from __future__ import annotations

import numpy as np

from ..native import voxelize_mesh_native


def occupancy(tri_bank, bbox_min, bbox_max, res):
    """Binary occupancy grid (Z, Y, X, 1) float32 numpy.

    res = (X, Y, Z); bbox_* world coordinates of the sensor volume."""
    return voxelize_mesh_native(tri_bank, bbox_min, bbox_max, res,
                                mode=0)[..., None]


def fractional_volumes(tri_bank, bbox_min, bbox_max, res, oversample=4):
    """Surface-aware per-voxel (inside, outside) volumes (Z, Y, X, 2)
    float32 numpy: channel 0 the volume inside the target, channel 1
    the rest, summing to the voxel volume (the JAX package's native
    path, drtvam_tpu/ops/voxelize.py:102-121)."""
    frac = voxelize_mesh_native(tri_bank, bbox_min, bbox_max, res, mode=1,
                                oversample=oversample)
    bmin = np.asarray(bbox_min, np.float32)
    bmax = np.asarray(bbox_max, np.float32)
    voxel_vol = np.prod((bmax - bmin) / np.asarray(res, np.float32))
    return np.stack([frac * voxel_vol, (1.0 - frac) * voxel_vol], -1)
