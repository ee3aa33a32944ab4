"""Scene assembly: JSON config -> (MarchStatic, host arrays)
(counterpart of drtvam_tpu/models/scene.py).

A scene compiles to a static, hashable description (surface kinds,
BSDFs, topology, projector and sensor configuration) and a flat dict of
numpy arrays, key for key and bit for bit the JAX package's.

The target mesh is normalized into the print volume with
v' = (v - bbox_center) * size / max(extent) + box_center. In volume
mode without a surface-aware film the target is left out of the render
scene, as the reference does; the radon and corner renders keep it, as
a mesh surface: its triangles in the tri_* banks and, from GRID_MIN_TRIS
triangles on, a uniform grid over them in the grid_* banks
(ops/mesh_grid.py), assembled as the JAX package assembles them.
"""
from __future__ import annotations

import numpy as np

from .geometry import geometries, SurfaceSpec, MESH, NULL
from .projector import Projector
from .sensor import Sensor
from ..ops.mesh import TriMesh, load_mesh
from ..ops.march import MarchStatic, SurfaceStatic
from ..ops.mesh_grid import GRID_MIN_TRIS, TriGridStatic, build_tri_grid


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

        statics, params, etas, refls = [], [], [], []
        tri_v0, tri_e1, tri_e2, tri_n = [], [], [], []
        grid_cs, grid_ids, grid_bbox = [], [], []
        tri_cursor = cs_cursor = ids_cursor = 0
        for s in specs:
            tri_slice = (0, 0)
            grid = None
            if s.kind == MESH:
                v0, e1, e2, n = s.mesh.triangle_bank()
                tri_v0.append(v0)
                tri_e1.append(e1)
                tri_e2.append(e2)
                tri_n.append(n)
                tri_slice = (tri_cursor, v0.shape[0])
                tri_cursor += v0.shape[0]
                if v0.shape[0] >= GRID_MIN_TRIS:
                    res, cs, ids, gb0, gb1 = build_tri_grid(v0, e1, e2)
                    grid = TriGridStatic(
                        res=res, cell_offset=cs_cursor,
                        ids_offset=ids_cursor, n_ids=ids.shape[0],
                        bbox_row=len(grid_bbox))
                    grid_cs.append(cs)
                    grid_ids.append(ids)
                    grid_bbox.append(np.stack([gb0, gb1]))
                    cs_cursor += cs.shape[0]
                    ids_cursor += ids.shape[0]
            statics.append(SurfaceStatic(
                kind=s.kind, bsdf=s.bsdf, medium_side=s.medium_side,
                is_target=s.is_target, tri_slice=tri_slice, grid=grid))
            params.append(s.params)
            etas.append(s.eta)
            refls.append(s.refl)
        if tri_cursor == 0:
            # the keys stay, as in the JAX package: never indexed
            tri_v0 = tri_e1 = tri_e2 = tri_n = [np.zeros((1, 3), np.float32)]
        if cs_cursor == 0:
            grid_cs = grid_ids = [np.zeros((1,), np.int32)]
            grid_bbox = [np.zeros((2, 3), np.float32)]

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
        arr = {
            "surf_params": np.asarray(params, np.float32),
            "surf_eta": np.asarray(etas, np.float32),
            "surf_refl": np.asarray(refls, np.float32),
            "tri_v0": np.concatenate(tri_v0).astype(np.float32),
            "tri_e1": np.concatenate(tri_e1).astype(np.float32),
            "tri_e2": np.concatenate(tri_e2).astype(np.float32),
            "tri_n": np.concatenate(tri_n).astype(np.float32),
            "grid_cell_start": np.concatenate(grid_cs).astype(np.int32),
            "grid_tri_ids": np.concatenate(grid_ids).astype(np.int32),
            "grid_bbox": np.stack(grid_bbox).astype(np.float32),
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
