"""Static scene descriptions (counterpart of the dataclasses in
drtvam_tpu/ops/march.py:72-145).

Only the two dataclasses come over in this slice; the wavefront march
itself is ROADMAP queue 1 item 10. Field names and defaults match the
JAX package so `convert.scene_from_jax` maps them one to one.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

from ..models.projector import ProjectorStatic
from ..models.sensor import SensorStatic


@dataclass(frozen=True)
class SurfaceStatic:
    kind: int            # CYLINDER | BOX | MESH
    bsdf: int            # DIELECTRIC | NULL | ABSORB | DIFFUSE
    medium_side: int     # 0 none, 1 interior is medium, 2 exterior
    is_target: bool
    tri_slice: Tuple[int, int]  # (start, count) into the triangle bank
    # mesh-grid acceleration; always None here (mesh surfaces are
    # ROADMAP queue 1 item 17)
    grid: Optional[object] = None


@dataclass(frozen=True)
class MarchStatic:
    surfaces: Tuple[SurfaceStatic, ...]
    projector: ProjectorStatic
    sensor: SensorStatic
    has_scattering: bool
    phase: Optional[str]
    max_depth: int
    rr_depth: int
    transmission_only: bool
    regular_sampling: bool
    sample_time: bool
    clockwise: bool
    mode: str = "volume"      # 'volume' | 'radon'
    medium_grads: bool = False
    scattered_only: bool = False
    first_scatter: bool = False
    fast_residual: bool = False
