"""Scene assembly: JSON config -> (MarchStatic, host arrays)
(counterpart of drtvam_tpu/models/scene.py).

A scene compiles to a static, hashable description (surface kinds,
BSDFs, topology, projector and sensor configuration) and a flat dict of
numpy arrays, key for key and bit for bit the JAX package's.

The target mesh is normalized into the print volume with
v' = (v - bbox_center) * size / max(extent) + box_center. In volume
mode without a surface-aware film the target is left out of the render
scene, as the reference does. Mesh surfaces in the render scene raise
NotImplementedError: the target kept in for a surface-aware film is
ROADMAP queue 1 item 14, mesh vials and occlusions item 17.
"""
from __future__ import annotations

import numpy as np

from .geometry import geometries, SurfaceSpec, MESH, NULL
from .projector import Projector
from .sensor import Sensor
from ..ops.mesh import TriMesh, load_mesh
from ..ops.march import MarchStatic, SurfaceStatic


def _mesh_transform(mesh: TriMesh, cfg):
    bmin, bmax = mesh.bbox
    c = 0.5 * (bmin + bmax)
    size = float(cfg.get("size", 1.0))
    center = np.array([cfg.get("box_center_x", 0.0),
                       cfg.get("box_center_y", 0.0),
                       cfg.get("box_center_z", 0.0)], np.float32)
    scale = size / float((bmax - bmin).max())
    return mesh.transformed(scale=scale, translate=center - c * scale)


class Scene:
    """Host-side scene: parsed config + mesh/array staging."""

    def __init__(self, config, resolve_path=lambda p: p):
        for key in ("target", "vial", "projector", "sensor"):
            if key not in config:
                raise ValueError(
                    f"Missing field '{key}' in the configuration file.")
        vcfg = config["vial"]
        if "type" not in vcfg:
            raise ValueError("The vial geometry must have a 'type' field.")
        if vcfg["type"] not in geometries:
            raise ValueError(f"Unknown vial geometry: '{vcfg['type']}'")
        self.vial = geometries[vcfg["type"]](vcfg, resolve_path)
        self.medium = self.vial.medium

        # target: a mesh, or a recorded (Z, Y, X[, 1]) dose volume
        self.target_dose = None
        if "dose_npy" in config["target"]:
            dose = np.load(resolve_path(config["target"]["dose_npy"]))
            if dose.ndim == 3:
                dose = dose[..., None]
            self.target_dose = np.asarray(dose, np.float32)
            self.target_mesh = None
        elif "filename" not in config["target"]:
            raise ValueError("Missing field 'filename' for the target shape.")
        else:
            raw_target = load_mesh(resolve_path(config["target"]["filename"]))
            self.target_mesh = _mesh_transform(raw_target, config["target"])

        self.projector = Projector(config["projector"], resolve_path)
        self.sensor = Sensor(config["sensor"])
        if self.target_dose is not None:
            want = self.sensor.static.shape
            got = self.target_dose.shape
            if got[:3] != want[:3]:
                raise ValueError(
                    f"target dose_npy volume has shape {got[:3]} but the "
                    f"sensor film is (resz, resy, resx) = {want[:3]}; "
                    "they must match voxel-for-voxel")
        self.final_sensor = Sensor(config["final_sensor"]) \
            if "final_sensor" in config else self.sensor
        if self.final_sensor.surface_aware:
            raise ValueError(
                "The final sensor is used to generate visualizations and "
                "metrics of the final simulated print. Therefore, it must "
                "not be surface-aware. If you are using the surface-aware "
                "discretization for optimization, please specify another "
                "sensor called 'final_sensor' in the configuration file.")
        self.config = config
        self._target_bank = None

    def target_bank(self):
        """Host triangle bank (v0, e1, e2, n) of the transformed target."""
        if self.target_mesh is None:
            raise ValueError(
                "this scene's target is a recorded dose volume "
                "('dose_npy'); no target mesh is available")
        if self._target_bank is None:
            self._target_bank = self.target_mesh.triangle_bank()
        return self._target_bank

    def _surface_specs(self, include_target):
        specs = list(self.vial.surfaces())
        if include_target:
            specs.append(SurfaceSpec(kind=MESH, bsdf=NULL,
                                     mesh=self.target_mesh, is_target=True,
                                     name="target"))
        return specs

    def build(self, mode="volume", include_target=None, max_depth=6,
              rr_depth=6, print_time=1.0, transmission_only=True,
              regular_sampling=False, sample_time=False, sensor=None):
        """Compile to (MarchStatic, arrays).

        include_target defaults to the reference's behavior: present for
        radon/corner filters and for surface-aware films."""
        if include_target is None:
            include_target = (mode != "volume") or self.sensor.surface_aware
        sensor = sensor if sensor is not None else self.sensor
        specs = self._surface_specs(include_target)
        if any(s.kind == MESH for s in specs):
            raise NotImplementedError(
                "mesh surfaces in the render scene are not ported yet: the "
                "target kept in for a surface-aware film is ROADMAP queue 1 "
                "item 14, mesh vials and occlusions item 17")

        statics = [SurfaceStatic(kind=s.kind, bsdf=s.bsdf,
                                 medium_side=s.medium_side,
                                 is_target=s.is_target, tri_slice=(0, 0))
                   for s in specs]
        m = self.medium
        static = MarchStatic(
            surfaces=tuple(statics),
            projector=self.projector.static(),
            sensor=sensor.static,
            has_scattering=m.albedo > 0.0,
            phase=m.phase,
            max_depth=max_depth,
            rr_depth=rr_depth,
            transmission_only=transmission_only,
            regular_sampling=regular_sampling,
            sample_time=sample_time,
            clockwise=self.projector.motion.clockwise,
            mode=mode,
        )
        # no mesh surfaces: the triangle and grid banks keep the JAX
        # package's placeholder entries so both dicts match key for key
        tri0 = np.zeros((1, 3), np.float32)
        arr = {
            "surf_params": np.asarray([s.params for s in specs], np.float32),
            "surf_eta": np.asarray([s.eta for s in specs], np.float32),
            "surf_refl": np.asarray([s.refl for s in specs], np.float32),
            "tri_v0": tri0, "tri_e1": tri0.copy(), "tri_e2": tri0.copy(),
            "tri_n": tri0.copy(),
            "grid_cell_start": np.zeros((1,), np.int32),
            "grid_tri_ids": np.zeros((1,), np.int32),
            "grid_bbox": np.zeros((1, 2, 3), np.float32),
            "bbox_min": np.asarray(sensor.bbox_min, np.float32),
            "bbox_max": np.asarray(sensor.bbox_max, np.float32),
            "sigma_t": np.float32(m.sigma_t),
            "albedo": np.float32(m.albedo),
            "phase_g": np.float32(m.phase_g),
            "majorant": np.float32(max(sensor.majorant, 1e-30)),
            "print_time": np.float32(print_time),
        }
        arr.update(self.projector.arrays())
        return static, arr
