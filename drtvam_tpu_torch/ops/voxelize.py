"""Mesh voxelization (counterpart of drtvam_tpu/ops/voxelize.py).

Binary occupancy by voxel-center crossing parity along z-columns, run by
the host C++ voxelizer (the port's copy, csrc/host/mesh_accel.cpp) —
the only path: a failed build raises. Surface-aware fractional volumes are
ROADMAP queue 1 item 14.
"""
from __future__ import annotations

from ..native import voxelize_mesh_native


def occupancy(tri_bank, bbox_min, bbox_max, res):
    """Binary occupancy grid (Z, Y, X, 1) float32 numpy.

    res = (X, Y, Z); bbox_* world coordinates of the sensor volume."""
    return voxelize_mesh_native(tri_bank, bbox_min, bbox_max, res,
                                mode=0)[..., None]


def fractional_volumes(tri_bank, bbox_min, bbox_max, res, oversample=4):
    raise NotImplementedError(
        "surface-aware fractional volumes are not ported yet — ROADMAP "
        "queue 1 item 14")
