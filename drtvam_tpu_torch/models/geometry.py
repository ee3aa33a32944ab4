"""Vial geometry -> interface stacks (counterpart of
drtvam_tpu/models/geometry.py).

Each container describes the printing medium (IOR, extinction sigma_t,
albedo, phase function) and a stack of refractive interfaces emitted as
`SurfaceSpec` records. `medium_side` marks which side of a surface holds
the printing medium (1 = interior, 2 = exterior, 0 = none).

The four analytic vials, the mesh vial (`custom`: an outer and an inner
wall mesh) and, on every vial, `occlusions`: meshes with a black diffuse
(default), reflective diffuse, null or dielectric BSDF, the printing
medium on their outside (medium_side 2). A scene with a mesh vial or an
occlusion is not z-invariant, so it runs on the wavefront engine
(ops/transport2d.py unscattered_eligible).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

from ..ops.mesh import TriMesh, load_mesh

IOR_AIR = 1.000277  # Mitsuba's named "air" IOR, the dielectric default

# surface kinds
CYLINDER, BOX, MESH = 0, 1, 2
# bsdf kinds
DIELECTRIC, NULL, ABSORB, DIFFUSE = 0, 1, 2, 3

# Mitsuba's named IORs accepted in dielectric occlusion BSDF dicts
_NAMED_IOR = {"air": IOR_AIR, "vacuum": 1.0, "water": 1.3330,
              "bk7": 1.5046, "fused quartz": 1.458, "pyrex": 1.470,
              "acrylic glass": 1.49, "polypropylene": 1.49, "pet": 1.5750,
              "diamond": 2.419}


@dataclass
class SurfaceSpec:
    kind: int
    bsdf: int
    # cylinder: params = (radius, z0, z1); box: (hx, hy, hz)
    params: tuple = (0.0, 0.0, 0.0)
    eta: float = 1.0          # int_ior / ext_ior
    refl: float = 0.0         # diffuse reflectance (DIFFUSE surfaces)
    medium_side: int = 0      # 0 none, 1 interior is medium, 2 exterior
    is_target: bool = False
    mesh: Optional[TriMesh] = None
    name: str = ""


@dataclass
class MediumSpec:
    sigma_t: float
    albedo: float
    ior: float
    phase: Optional[str]      # 'rayleigh' | 'hg' | None
    phase_g: float = 0.0


geometries = {}


def register_geometry(name, cls):
    geometries[name] = cls


def _parse_medium(params, cls_name):
    if "medium" not in params:
        raise ValueError(f"[{cls_name}] Missing field 'medium'.")
    m = params["medium"]
    albedo = m["albedo"]
    phase = None
    g = 0.0
    if "phase" in m:
        p = m["phase"]
        if isinstance(p, dict):
            phase = p["type"]
            g = float(p.get("g", 0.0))
        else:
            phase = p
    elif albedo > 0.0:
        raise ValueError(
            f"[{cls_name}] Tried to load a scattering medium without "
            "specifying a phase function.")
    return MediumSpec(sigma_t=float(m["extinction"]), albedo=float(albedo),
                      ior=float(m["ior"]), phase=phase, phase_g=g)


def _ior_value(v):
    if isinstance(v, str):
        return _NAMED_IOR[v.lower()]
    return float(v)


def _reflectance_value(v):
    # a Mitsuba spectrum dict ({"type": "spectrum", "value": x}) or a
    # scalar: one channel
    if isinstance(v, dict):
        return float(v.get("value", 0.5))
    return float(v)


def _occlusion_specs(params, resolve_path):
    """The vial's occlusion meshes: a BSDF dict each, default black
    diffuse (a pure absorber); diffuse (any reflectance), null or
    dielectric. The printing medium is every occlusion's exterior, so a
    ray leaving one on its outside resumes medium transport
    (medium_side 2)."""
    specs = []
    for occ in params.get("occlusions", []):
        mesh = load_mesh(resolve_path(occ["filename"]))
        bsdf, eta, refl = ABSORB, 1.0, 0.0
        b = occ.get("bsdf")
        if isinstance(b, dict):
            btype = b.get("type", "diffuse")
            if btype == "null":
                bsdf = NULL
            elif btype == "dielectric":
                bsdf = DIELECTRIC
                eta = _ior_value(b.get("int_ior", "bk7")) / \
                    _ior_value(b.get("ext_ior", "air"))
            elif btype == "diffuse":
                refl = _reflectance_value(b.get("reflectance", 0.5))
                bsdf = ABSORB if refl == 0.0 else DIFFUSE
            else:
                raise ValueError(
                    f"unsupported occlusion BSDF type '{btype}' "
                    "(diffuse | null | dielectric)")
        specs.append(SurfaceSpec(kind=MESH, bsdf=bsdf, mesh=mesh,
                                 eta=eta, refl=refl, medium_side=2,
                                 name=f"occlusion:{occ['filename']}"))
    return specs


class Container:
    def __init__(self, params, resolve_path=lambda p: p):
        self.medium = _parse_medium(params, type(self).__name__)
        self.params = params
        self.resolve_path = resolve_path

    def surfaces(self):
        raise NotImplementedError


class IndexMatchedVial(Container):
    """Single null interface: the medium boundary refracts nothing."""

    def surfaces(self):
        r = float(self.params["r"])
        h = float(self.params.get("height", 40.0))
        return [SurfaceSpec(kind=CYLINDER, bsdf=NULL,
                            params=(r, -0.5 * h, 0.5 * h),
                            medium_side=1, name="vial")] + \
            _occlusion_specs(self.params, self.resolve_path)


class CylindricalVial(Container):
    """Two nested dielectric cylinders."""

    def surfaces(self):
        p = self.params
        h = float(p.get("height", 40.0))
        vior = float(p["ior"])
        return [
            SurfaceSpec(kind=CYLINDER, bsdf=DIELECTRIC,
                        params=(float(p["r_ext"]), -0.5 * h, 0.5 * h),
                        eta=vior / IOR_AIR, name="vial_exterior"),
            SurfaceSpec(kind=CYLINDER, bsdf=DIELECTRIC,
                        params=(float(p["r_int"]), -0.5 * h, 0.5 * h),
                        eta=self.medium.ior / vior, medium_side=1,
                        name="vial_interior"),
        ] + _occlusion_specs(p, self.resolve_path)


class SquareVial(Container):
    """Two nested dielectric boxes; the inner cavity is 0.9x the height."""

    def surfaces(self):
        p = self.params
        h = float(p.get("height", 100.0))
        vior = float(p["ior"])
        we, wi = float(p["w_ext"]), float(p["w_int"])
        return [
            SurfaceSpec(kind=BOX, bsdf=DIELECTRIC,
                        params=(0.5 * we, 0.5 * we, 0.5 * h),
                        eta=vior / IOR_AIR, name="vial_exterior"),
            SurfaceSpec(kind=BOX, bsdf=DIELECTRIC,
                        params=(0.5 * wi, 0.5 * wi, 0.5 * 0.9 * h),
                        eta=self.medium.ior / vior, medium_side=1,
                        name="vial_interior"),
        ] + _occlusion_specs(p, self.resolve_path)


class CustomVial(Container):
    """Mesh vial walls: the outer wall air -> glass, the inner wall glass
    -> medium, the medium inside the inner mesh (outward normals on both
    meshes)."""

    def surfaces(self):
        p = self.params
        for k in ("filename_vial_outer", "filename_vial_inner"):
            if k not in p:
                raise ValueError(
                    "[CustomVial] Missing fields 'filename_vial_outer' or "
                    "'filename_vial_inner' for custom vial.")
        vior = float(p["ior"])
        outer = load_mesh(self.resolve_path(p["filename_vial_outer"]))
        inner = load_mesh(self.resolve_path(p["filename_vial_inner"]))
        return [
            SurfaceSpec(kind=MESH, bsdf=DIELECTRIC, mesh=outer,
                        eta=vior / IOR_AIR, name="vial_exterior"),
            SurfaceSpec(kind=MESH, bsdf=DIELECTRIC, mesh=inner,
                        eta=self.medium.ior / vior, medium_side=1,
                        name="vial_interior"),
        ] + _occlusion_specs(p, self.resolve_path)


class DoubleCylindricalVial(Container):
    """Vial-in-vial overprinting: four nested dielectric cylinders, the
    medium between the outer vial's interior and the inner vial's
    exterior."""

    def surfaces(self):
        p = self.params
        h = float(p.get("height", 40.0))
        ior_o = float(p["ior_outer"])
        ior_i = float(p["ior_inner"])
        ior_fill = float(p["ior_inside_inner"])
        m = self.medium.ior

        def cyl(r):
            return (float(r), -0.5 * h, 0.5 * h)

        return [
            SurfaceSpec(kind=CYLINDER, bsdf=DIELECTRIC,
                        params=cyl(p["r_ext_outer"]), eta=ior_o / IOR_AIR,
                        name="outer_vial"),
            SurfaceSpec(kind=CYLINDER, bsdf=DIELECTRIC,
                        params=cyl(p["r_int_outer"]), eta=m / ior_o,
                        medium_side=1, name="outer_vial_interior"),
            SurfaceSpec(kind=CYLINDER, bsdf=DIELECTRIC,
                        params=cyl(p["r_ext_inner"]), eta=ior_i / m,
                        medium_side=2, name="inner_vial"),
            SurfaceSpec(kind=CYLINDER, bsdf=DIELECTRIC,
                        params=cyl(p["r_int_inner"]), eta=ior_fill / ior_i,
                        name="inner_vial_interior"),
        ] + _occlusion_specs(p, self.resolve_path)


register_geometry("index_matched", IndexMatchedVial)
register_geometry("cylindrical", CylindricalVial)
register_geometry("square", SquareVial)
register_geometry("custom", CustomVial)
register_geometry("double_cylindrical", DoubleCylindricalVial)
