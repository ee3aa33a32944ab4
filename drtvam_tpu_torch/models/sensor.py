"""Volumetric sensor and film (counterpart of
drtvam_tpu/models/sensor.py).

The film is a dose tensor (Z, Y, X, C): C = 2 on a surface-aware film
(channel 0 the dose inside the target, 1 outside), else 1. The
reference's resolution quirk is kept: config 'resx' sets the Y extent
and 'resy' sets X.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import numpy as np

from ..ops.voxelize import fractional_volumes, occupancy


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
        self._volumes = None

    @property
    def voxel_size(self):
        X, Y, Z = self.static.res
        return (self.bbox_max - self.bbox_min) / np.array([X, Y, Z],
                                                          np.float32)

    @property
    def voxel_volume(self):
        return float(np.prod(self.voxel_size))

    def compute_volume(self, target_bank=None, oversample=4):
        """Per-voxel integration volume: the voxel volume (a float32
        scalar), or on a surface-aware film the (Z, Y, X, 2) inside /
        outside fractional volumes of the target, computed once."""
        if not self.surface_aware:
            return np.float32(self.voxel_volume)
        if self._volumes is None:
            if target_bank is None:
                raise ValueError("surface-aware sensor needs the target "
                                 "mesh to compute fractional volumes")
            self._volumes = fractional_volumes(
                target_bank, self.bbox_min, self.bbox_max,
                self.static.res, oversample=oversample)
        return self._volumes

    def inv_volume(self, target_bank=None, oversample=4):
        """1 / volume in float32 arithmetic, 0 where the volume is 0, as
        the JAX package: a float32 scalar, or a (Z, Y, X, 2) array on a
        surface-aware film."""
        vol = self.compute_volume(target_bank, oversample)
        with np.errstate(divide="ignore"):
            inv = np.float32(1.0) / np.maximum(vol, np.float32(1e-30))
        return np.where(vol != 0.0, inv, np.float32(0.0)).astype(np.float32)[()]

    def discretize(self, target_bank):
        """Binary occupancy (Z, Y, X, 1) of the target in this grid."""
        return occupancy(target_bank, self.bbox_min, self.bbox_max,
                         self.static.res)
