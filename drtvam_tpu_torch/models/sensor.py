"""Volumetric sensor and film (counterpart of
drtvam_tpu/models/sensor.py).

The film is a dose tensor (Z, Y, X, C). The reference's resolution
quirk is kept: config 'resx' sets the Y extent and 'resy' sets X.
Surface-aware (2-channel) films are ROADMAP queue 1 item 14.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import numpy as np

from ..ops.voxelize import occupancy


@dataclass(frozen=True)
class SensorStatic:
    estimator: str            # 'dda' | 'ratio' | 'delta'
    res: Tuple[int, int, int]  # (X, Y, Z)
    surface_aware: bool

    @property
    def channels(self):
        return 2 if self.surface_aware else 1

    @property
    def shape(self):
        X, Y, Z = self.res
        return (Z, Y, X, self.channels)

    @property
    def n_cells(self):
        X, Y, Z = self.res
        return X * Y * Z * self.channels


class Sensor:
    def __init__(self, props):
        est = props["type"]
        if est not in ("dda", "ratio", "delta"):
            raise ValueError(f"Unknown sensor type '{est}'")
        film = props.get("film", {})
        if film.get("type", "vfilm") != "vfilm":
            raise ValueError("The film must be of type vfilm.")
        resz = int(film.get("resz", 256))
        res_y = int(film.get("resx", 256))  # quirk: resx -> Y
        res_x = int(film.get("resy", 256))  # quirk: resy -> X
        self.surface_aware = bool(film.get("surface_aware", False))
        self.static = SensorStatic(est, (res_x, res_y, resz),
                                   self.surface_aware)
        sx = float(props.get("scalex", 1.0))
        sy = float(props.get("scaley", 1.0))
        sz = float(props.get("scalez", 1.0))
        self.bbox_min = np.array([-0.5 * sx, -0.5 * sy, -0.5 * sz],
                                 np.float32)
        self.bbox_max = -self.bbox_min
        self.majorant = float(props.get("majorant", 0.0))
        if est == "ratio" and self.majorant <= 0.0:
            raise ValueError("Ratio sensor requires a positive 'majorant'.")

    @property
    def voxel_size(self):
        X, Y, Z = self.static.res
        return (self.bbox_max - self.bbox_min) / np.array([X, Y, Z],
                                                          np.float32)

    @property
    def voxel_volume(self):
        return float(np.prod(self.voxel_size))

    def _no_surface_aware(self):
        if self.surface_aware:
            raise NotImplementedError(
                "surface-aware films are not ported yet — ROADMAP queue 1 "
                "item 14")

    def compute_volume(self):
        """Per-voxel integration volume (float32 scalar)."""
        self._no_surface_aware()
        return np.float32(self.voxel_volume)

    def inv_volume(self):
        """1 / voxel volume in float32 arithmetic, as the JAX package."""
        vol = self.compute_volume()
        if vol == 0.0:
            return np.float32(0.0)
        return np.float32(1.0) / np.maximum(vol, np.float32(1e-30))

    def discretize(self, target_bank):
        """Binary occupancy (Z, Y, X, 1) of the target in this grid."""
        return occupancy(target_bank, self.bbox_min, self.bbox_max,
                         self.static.res)
