"""The wavefront volumetric path tracer, plain PyTorch version
(counterpart of drtvam_tpu/ops/march.py).

Static scene descriptions (`SurfaceStatic`, `MarchStatic`, field for
field the JAX package's, so `convert.scene_from_jax` maps them one to
one) and the march itself, vectorized over a wavefront of lanes with
per-lane active masks, float32 throughout:

  * attenuation tracks Fresnel / BSDF weights and albedo^n_scat only;
    without scattering the analytic transmittance exp(-sigma_t t_prev)
    is applied at deposit time, and Russian roulette reads
    A exp(-sigma_t total_t);
  * dda deposits A (sa/st) em exp(-st t) (1 - exp(-st dt)) per voxel,
    walking voxels Amanatides-Woo style;
  * ratio tracking marches exponential steps against the majorant with
    weight (sa/st) (1 - st/M)^k (st/M);
  * delta deposits A (sa/st) em at the sampled interaction voxel.

The adjoint replays the same paths (the counter-based sampler) and
gathers the loss gradient at each deposit into a per-lane emitter
gradient. The CUDA kernels (csrc/wf_trace.cuh, wrapped in
ops/render.py) run the same per-lane arithmetic; this version is what
the wrappers run on CPU tensors, and what the kernels are held to.

Deviations from the JAX package, by design:
  * deposits go per step with `index_add_` (primal) or a gather
    (adjoint); the TPU's staged flush (`DDA_FLUSH`) is not ported;
  * ratio tracking gives each lane its own random stream: a lane
    advances its counter only for the draws it consumes, the
    terminating one included. The JAX package draws for every lane of
    a chunk until the chunk's longest track ends, in rounds of 8, so a
    lane's later draws there depend on its chunk (ROADMAP queue 3).

The hybrid engine's residual modes (ops/hybrid.py), as in the JAX
package (drtvam_tpu/ops/march.py:107-144):
  * `scattered_only`: the analog paths with every deposit made while
    n_scat == 0 dropped (the ballistic engine owns those);
  * `first_scatter` (with scattered_only, scattering and transmission
    only): every lane starts at its forced first scatter event, sampled
    on its pixel's in-medium chord from the chord bank
    (`chord_pack`, ops/transport2d.py) or, without one, on the chord
    the lane's own transmission-only march records (the geometric
    prologue, drtvam_tpu/ops/march.py:198-325), with weight albedo * M,
    n_scat 1 and depth 1, then runs the general loop;
  * `fast_residual` (first_scatter, delta, one convex analytic medium
    region): the general loop collapses to max_depth - 1 unrolled
    scatter events, each against one convex exit distance; it draws in
    the general loop's order, so both replay the same paths.

A surface-aware film (two channels, drtvam_tpu/ops/march.py:556-565):
each lane carries `inside_target`, flipped at every crossing of the
target mesh (kept in the scene), and a deposit goes to channel
2 flat + (outside) of the (Z, Y, X, 2) accumulator: channel 0 the dose
inside the target, 1 outside. The first-scatter residual seeds the flag
from the voxelized inside mask at the lane's first scatter event
(arr["inside_mask"]), and the fast residual reads the mask at each
event voxel, as the JAX package does. A one-channel render that keeps
the target (the final render of a surface-aware scene) splits its
segments at the crossings and deposits as without it.

The radon mode (drtvam_tpu/ops/march.py:917-923, the `filter_radon`
culling render): scattering off, no deposits; each lane accumulates
A exp(-sigma_t total_t) (1 - exp(-sigma_t t)) over the segments it runs
inside the target and in the medium, total_t summing every segment, and
makes every random draw of the volume mode in its slot. Mesh surfaces
(the target, kept in the radon and corner renders and on a
surface-aware film; a custom vial's walls; occlusions) intersect
through the triangle bank or its uniform grid (ops/mesh_grid.py), each
mesh with its own BSDF and medium side: a lane enters the medium
through a mesh vial's inner wall (medium_side 1) or leaving an
occlusion on its outside (2), the normal of the hit triangle giving the
side. A diffuse occlusion reflects into the hemisphere of the incident
side with weight `refl` (not at depth 0, nor under
transmission_only, where it absorbs). The inside flag flips at the
target's crossings only.

The medium cotangents (`medium_grads`, drtvam_tpu/ops/march.py:586-903,
the reference's st_grad / ss_grad, volume.py:277-280): in the adjoint,
given `sg`, each deposit c of a segment also adds dc/d sigma_t * dL and
dc/d sigma_s * dL to its lane's two sums, with (sigma_t, sigma_s) leaves
in the analytic transmittance exp(-sigma_t t), the albedo factor and the
scattering power sigma_s^n_scat, the sampling pdfs detached, in the
JAX package's formulas and operation order: dda per voxel step (E =
exp(-st t), G = 1 - exp(-st dt)), ratio per tracking step (k, the
(M - st) term clamped at 1e-30), delta at the event (the transmittance
attached, the pdf detached). The n_scat term is dropped where
sigma_s = 0, as there. A residual mode with medium_grads raises: no
driver path of the JAX package reaches it (ROADMAP queue 1 item 21).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import torch

from ..core.rng import MASK, Sampler
from ..core.warp import square_to_cosine_hemisphere
from ..models.geometry import BOX, CYLINDER, DIELECTRIC, DIFFUSE, NULL
from ..models.projector import ProjectorStatic, ray_weight, sample_rays
from ..models.sensor import SensorStatic
from .fresnel import dot3, refract
from .intersect import INF, ray_box, ray_cylinder, ray_triangles
from .medium import U_MAX, phase_functions, sample_free_flight, \
    sample_phase_direction
from .mesh_grid import TriGridStatic, ray_triangles_grid

RAY_EPS = 1e-4
RATIO_MAX_STEPS = 65536
ESTIMATORS = ("dda", "ratio", "delta")
# residual modes, as the kernels number them (csrc/wf_trace.cuh)
ANALOG, SCAT_ONLY, FIRST_SCATTER, FAST_RESIDUAL = range(4)


@dataclass(frozen=True)
class SurfaceStatic:
    kind: int            # CYLINDER | BOX | MESH
    bsdf: int            # DIELECTRIC | NULL | ABSORB | DIFFUSE
    medium_side: int     # 0 none, 1 interior is medium, 2 exterior
    is_target: bool
    tri_slice: Tuple[int, int]  # (start, count) into the triangle bank
    # a mesh's uniform grid (from GRID_MIN_TRIS triangles), else None
    grid: Optional[TriGridStatic] = None


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


def _not_ported(what, item):
    return NotImplementedError(
        f"{what} is not ported yet — ROADMAP queue 1 item {item}")


def check_supported(static: MarchStatic):
    """Raise for what the port's wavefront does not run."""
    if static.mode not in ("volume", "radon"):
        raise ValueError(f"unknown render mode '{static.mode}'")
    if static.medium_grads and static.scattered_only:
        raise _not_ported("medium gradients of a residual mode "
                          "(medium_grads with scattered_only, which no "
                          "driver path of the JAX package reaches)", 21)
    if static.sensor.estimator not in ESTIMATORS:
        raise ValueError(f"unknown estimator '{static.sensor.estimator}'")
    if static.has_scattering and static.phase not in phase_functions:
        raise ValueError(f"unknown phase function '{static.phase}'")


def residual_mode(static: MarchStatic):
    """ANALOG (the full dose), SCAT_ONLY (the analog paths' scattered
    deposits), FIRST_SCATTER (lanes start at a forced first scatter on
    the chord bank) or FAST_RESIDUAL (that, then the unrolled convex
    event loop), from the static flags as trace_wavefront reads them
    (drtvam_tpu/ops/march.py:968-991)."""
    if not static.scattered_only:
        return ANALOG
    if not (static.first_scatter and static.has_scattering
            and static.transmission_only and not static.medium_grads):
        return SCAT_ONLY
    if static.fast_residual and static.sensor.estimator == "delta":
        return FAST_RESIDUAL
    return FIRST_SCATTER


def fast_residual_eligible(static: MarchStatic) -> bool:
    """True when the medium region is a single convex analytic volume:
    exactly one non-target surface with medium_side != 0, a cylinder or
    box whose interior is the medium (cylindrical, square and
    index-matched vials)."""
    med = [s for s in static.surfaces
           if s.medium_side != 0 and not s.is_target]
    return (len(med) == 1 and med[0].medium_side == 1
            and med[0].kind in (CYLINDER, BOX))


def residual_surface(static: MarchStatic):
    """The index of the fast residual's one medium surface."""
    if not fast_residual_eligible(static):
        raise ValueError("fast_residual needs one convex analytic medium "
                         "region (fast_residual_eligible)")
    return [i for i, s in enumerate(static.surfaces)
            if s.medium_side != 0 and not s.is_target][0]


def dda_max_steps(res):
    """The JAX package's DDA walk cap: X + Y + Z + 2 steps, run in
    rounds of min(32, that), so rounded up to whole rounds."""
    n = sum(res) + 2
    k = min(32, n)
    return -(-n // k) * k


def scene_tensors(arr, device):
    """The scene's numpy arrays as torch tensors on `device` (dtypes
    kept: float32 values, int32 indices)."""
    return {k: torch.as_tensor(v).to(device) for k, v in arr.items()}


# --------------------------------------------------------------------------
# scene intersection over the static surface list


def _onb(n):
    """Branchless orthonormal basis around unit vectors n (Duff et al.
    2017). Returns (tangent, bitangent)."""
    s = torch.where(n[..., 2] >= 0.0, 1.0, -1.0).to(n.dtype)
    a = -1.0 / (s + n[..., 2])
    b = n[..., 0] * n[..., 1] * a
    t = torch.stack([1.0 + s * n[..., 0] * n[..., 0] * a, s * b,
                     -s * n[..., 0]], -1)
    bt = torch.stack([b, s + n[..., 1] * n[..., 1] * a, -n[..., 1]], -1)
    return t, bt


def _ray_mesh(s: SurfaceStatic, arr, o, d, stats=None, count=None):
    """Nearest hit of rays (N, 3) on mesh surface s: (t, normal), the
    normal of the hit triangle (of triangle 0 of the mesh on a miss), as
    drtvam_tpu/ops/march.py:171-190 takes it. stats: adds the mesh work
    of the rays where `count` is set (ray_triangles_grid; a mesh without
    a grid tests every triangle)."""
    a, c = s.tri_slice
    v0, e1, e2 = (arr[k][a:a + c] for k in ("tri_v0", "tri_e1", "tri_e2"))
    tmin = torch.full(o.shape[:1], RAY_EPS, dtype=torch.float32,
                      device=o.device)
    g = s.grid
    if g is None:
        t, tri = ray_triangles(o, d, tmin, v0, e1, e2)
        if stats is not None:
            stats["triangles"] = stats.get("triangles", 0) + \
                c * int(count.sum())
    else:
        n_cells = g.res[0] * g.res[1] * g.res[2]
        t, tri = ray_triangles_grid(
            o, d, tmin, v0, e1, e2,
            arr["grid_cell_start"][g.cell_offset:g.cell_offset + n_cells + 1],
            arr["grid_tri_ids"][g.ids_offset:g.ids_offset + g.n_ids],
            arr["grid_bbox"][g.bbox_row, 0], arr["grid_bbox"][g.bbox_row, 1],
            g.res, stats=stats, count=count)
    return t, arr["tri_n"][a:a + c][torch.clamp(tri, 0, c - 1)]


def intersect_scene(static: MarchStatic, arr, o, d, active, stats=None):
    """Nearest surface hit: (t, normal, surface id, valid). stats: adds
    the mesh surfaces' work for the active lanes (_ray_mesh)."""
    shape = o.shape[:-1]
    t_best = torch.full(shape, INF, dtype=torch.float32, device=o.device)
    n_best = torch.zeros_like(o)
    sid = torch.full(shape, -1, dtype=torch.int64, device=o.device)
    for i, s in enumerate(static.surfaces):
        p = arr["surf_params"][i]
        if s.kind == CYLINDER:
            t, n = ray_cylinder(o, d, RAY_EPS, p[0], p[1], p[2])
        elif s.kind == BOX:
            t, n = ray_box(o, d, RAY_EPS, p[:3])
        else:
            t, n = _ray_mesh(s, arr, o.reshape(-1, 3), d.reshape(-1, 3),
                             stats, None if stats is None
                             else active.reshape(-1))
            t, n = t.reshape(shape), n.reshape(o.shape)
        better = t < t_best
        t_best = torch.where(better, t, t_best)
        n_best = torch.where(better[..., None], n, n_best)
        sid = torch.where(better, i, sid)
    valid = active & torch.isfinite(t_best)
    return t_best, n_best, sid, valid


# --------------------------------------------------------------------------
# dose estimators: one straight segment [o, o + maxt d]


def _grid(static: MarchStatic, arr):
    """(bbox_min, voxel size, 1 / voxel size, res as int32)."""
    X, Y, Z = static.sensor.res
    bmin, bmax = arr["bbox_min"], arr["bbox_max"]
    resf = torch.tensor([X, Y, Z], dtype=torch.float32, device=bmin.device)
    vs = (bmax - bmin) / resf
    res = torch.tensor([X, Y, Z], dtype=torch.int32, device=bmin.device)
    return bmin, vs, 1.0 / vs, res


def _voxel_index(static, v):
    X, Y, _ = static.sensor.res
    v = v.to(torch.int64)
    return v[..., 0] + X * (v[..., 1] + Y * v[..., 2])


def _flat(static, v, inside=None):
    """The accumulator index of voxels v; on a two-channel film channel
    0 for the lanes inside the target, 1 for the others."""
    flat = _voxel_index(static, v)
    if static.sensor.channels == 2:
        flat = 2 * flat + torch.where(inside, 0, 1)
    return flat


def _voxel_flat(static: MarchStatic, p, bmin, inv_vs, res, inside=None):
    v = torch.floor((p - bmin) * inv_vs).to(torch.int32)
    in_grid = (v >= 0).all(-1) & (v < res).all(-1)
    return _flat(static, v, inside), in_grid


def _inside_at(static: MarchStatic, arr, p, bmin, inv_vs, res):
    """The inside mask (arr["inside_mask"], (Z Y X,) uint8) at points p,
    False outside the film (drtvam_tpu/ops/march.py:405-417)."""
    v = torch.floor((p - bmin) * inv_vs).to(torch.int32)
    in_grid = (v >= 0).all(-1) & (v < res).all(-1)
    flat = torch.where(in_grid, _voxel_index(static, v), 0)
    return in_grid & (arr["inside_mask"][flat] != 0)


def _deposit(primal, acc, g, dL, flat, val, mask):
    """primal: add val into acc at flat; adjoint: gather dL, add to g."""
    if primal:
        acc.index_add_(0, flat[mask], val[mask])
        return acc, g
    idx = torch.where(mask, flat, torch.zeros_like(flat))
    g = g + torch.where(mask, val * dL[idx], torch.zeros_like(val))
    return acc, g


def _history(static, arr, A, t_prev):
    if static.has_scattering:
        return A
    return A * torch.exp(-arr["sigma_t"] * t_prev)


def _count(stats, key, mask):
    if stats is not None:
        stats[key] = stats.get(key, 0) + int(mask.sum())


class _Med:
    """The medium cotangents of one segment's lanes (the adjoint with
    medium_grads): their emitted intensities em, hist_em = hist em, their
    n_scat (k, None without scattering), and their running sums stg and
    ssg, which `done` writes back into the wavefront's sg."""

    def __init__(self, static, arr, sg, lanes, hist, em, n_scat):
        self.sg, self.lanes = sg, lanes
        self.st, self.al = arr["sigma_t"], arr["albedo"]
        self.sa = 1.0 - self.al
        self.ss = self.al * self.st
        self.em, self.hist_em = em, hist * em
        self.k = n_scat if static.has_scattering else None
        pick = (lambda t: t) if lanes is None else (lambda t: t[lanes])
        self.stg, self.ssg = pick(sg[0]), pick(sg[1])

    def add(self, dst, dss, c_full, gathered, mask):
        """dst, dss: the deposit's partials without the n_scat term; adds
        it (c_full k / ss where ss > 0), then their products with the
        gathered dL to the lanes' sums where mask."""
        if self.k is not None:
            dss = dss + torch.where(
                self.ss > 0, c_full * self.k / torch.clamp(self.ss, min=1e-30),
                torch.zeros_like(dss))
        zero = torch.zeros_like(dst)
        self.stg = self.stg + torch.where(mask, dst * gathered, zero)
        self.ssg = self.ssg + torch.where(mask, dss * gathered, zero)

    def done(self):
        for i, v in enumerate((self.stg, self.ssg)):
            if self.lanes is None:
                self.sg[i] = v
            else:
                self.sg[i] = self.sg[i].clone()
                self.sg[i][self.lanes] = v


def _gathered(dL, flat, mask):
    idx = torch.where(mask, flat, torch.zeros_like(flat))
    return torch.where(mask, dL[idx], torch.zeros(flat.shape, dtype=dL.dtype,
                                                  device=dL.device))


def dda_segment(static, arr, primal, acc, g, dL, o, d, t_prev, maxt, A, em,
                active, stats=None, inside=None, n_scat=None, sg=None):
    """Amanatides-Woo voxel walk with analytic per-voxel absorption,
    on the lanes of `active`; inside: the lanes' target flag (two
    channels). sg: the adjoint's per-lane medium cotangent sums (_Med;
    em the lanes' emitted intensities, n_scat their scatter counts)."""
    lanes = torch.nonzero(active).squeeze(1)
    if lanes.numel() == 0:
        return acc, g
    o, d, t_prev, maxt, A = o[lanes], d[lanes], t_prev[lanes], \
        maxt[lanes], A[lanes]
    if inside is not None:
        inside = inside[lanes]
    bmin, vs, _, res = _grid(static, arr)
    bmax = arr["bbox_max"]
    st = arr["sigma_t"]
    sa_over_st = 1.0 - arr["albedo"]

    tiny = torch.full_like(d, 1e-20)
    safe_d = torch.where(torch.abs(d) > 1e-20, d, tiny)
    t_b0 = (bmin - o) / safe_d
    t_b1 = (bmax - o) / safe_d
    mint_box = torch.clamp(torch.minimum(t_b0, t_b1).amax(-1), min=0.0)
    maxt_box = torch.maximum(t_b0, t_b1).amin(-1)
    t_start = torch.clamp(mint_box, min=0.0)
    t_end = torch.minimum(maxt_box, maxt)
    act = torch.isfinite(t_start) & torch.isfinite(t_end) & \
        (t_start < t_end)

    grid_start = o + t_start[:, None] * d
    grid_end = o + t_end[:, None] * d
    step_dir = torch.where(d > 0, 1, -1).to(torch.int32)
    zero_i = torch.zeros_like(res)
    start_voxel = torch.clamp(((grid_start - bmin) / vs).to(torch.int32),
                              zero_i, res - 1)
    end_voxel = torch.clamp(((grid_end - bmin) / vs).to(torch.int32),
                            zero_i, res - 1)
    next_voxel_pos = bmin + (start_voxel + step_dir).to(torch.float32) * vs \
        + torch.where(d < 0, vs, torch.zeros_like(d))
    valid_dir = torch.abs(d) > 1e-8
    inf = torch.full_like(d, INF)
    dtmax = torch.where(valid_dir, (next_voxel_pos - grid_start) / safe_d,
                        inf)
    dtmax = torch.where(dtmax < 0, inf, dtmax)
    tstep = torch.where(valid_dir, vs / safe_d * step_dir.to(torch.float32),
                        inf)

    hist = _history(static, arr, A, t_prev)
    base = hist * sa_over_st
    if primal:
        base = base * em[lanes]
    g_l = None if primal else g[lanes]
    med = None if primal or sg is None else _Med(
        static, arr, sg, lanes, hist, em[lanes], n_scat[lanes])

    voxel, t, remaining = start_voxel, t_start, t_end - t_start
    for _ in range(dda_max_steps(static.sensor.res)):
        if not bool(act.any()):
            break
        t_at = t
        dt = torch.minimum(dtmax.amin(-1), remaining)
        flat = _flat(static, voxel, inside)
        dep_act = act
        remaining = torch.where(act, remaining - dt, remaining)
        act = act & (end_voxel != voxel).any(-1) & (remaining > 1e-6)
        mask = dtmax == dt[:, None]
        dtmax = torch.where(mask, tstep, dtmax - dt[:, None])
        upd = torch.where(mask, step_dir, torch.zeros_like(step_dir))
        voxel = torch.where(act[:, None], voxel + upd, voxel)
        act = act & (voxel >= 0).all(-1) & (voxel < res).all(-1)
        t = torch.where(act, t + dt, t)
        E = torch.exp(-st * t_at)
        dtc = torch.clamp(dt, min=0.0)
        expdt = torch.exp(-st * dtc)
        G = 1.0 - expdt
        contrib = base * E * G
        acc, g_l = _deposit(primal, acc, g_l, dL, flat, contrib, dep_act)
        _count(stats, "steps", dep_act)
        if med is not None:
            # c = hist em (st - ss) / st e^{-st (t_prev + t)} (1 - e^{-st
            # dt}), its partials at the detached point
            HG = med.hist_em * E * G
            c_full = HG * sa_over_st
            dst = -c_full * (t_prev + t_at) + HG * (arr["albedo"] / st) + \
                med.hist_em * E * sa_over_st * dtc * expdt
            med.add(dst, -HG / st, c_full, _gathered(dL, flat, dep_act),
                    dep_act)
    if med is not None:
        med.done()
    if not primal:
        g = g.clone()
        g[lanes] = g_l
    return acc, g


def ratio_segment(static, arr, primal, acc, g, dL, o, d, t_prev, maxt, A,
                  em, active, sampler, lane, ctr, stats=None, inside=None,
                  n_scat=None, sg=None):
    """Ratio tracking on the lanes of `active`, each on its own random
    stream: a lane draws (and advances its counter) only while it is
    tracking, the terminating draw included. sg: as dda_segment's."""
    lanes = torch.nonzero(active).squeeze(1)
    if lanes.numel() == 0:
        return acc, g, ctr
    o, d, t_prev, maxt, A = o[lanes], d[lanes], t_prev[lanes], \
        maxt[lanes], A[lanes]
    lane_l, ctr_l = lane[lanes], ctr[lanes]
    if inside is not None:
        inside = inside[lanes]
    bmin, _, inv_vs, res = _grid(static, arr)
    st = arr["sigma_t"]
    M = arr["majorant"]
    hist = _history(static, arr, A, t_prev)
    base = hist * (1.0 - arr["albedo"])
    if primal:
        base = base * em[lanes]
    base = base * (st / M)
    log_ratio = torch.log(torch.clamp(1.0 - st / M, min=1e-30))
    g_l = None if primal else g[lanes]
    med = None if primal or sg is None else _Med(
        static, arr, sg, lanes, hist, em[lanes], n_scat[lanes])

    act = torch.ones_like(maxt, dtype=torch.bool)
    t = torch.zeros_like(maxt)
    k = torch.zeros_like(maxt)
    for _ in range(RATIO_MAX_STEPS):
        if not bool(act.any()):
            break
        _count(stats, "steps", act)
        u, _ = sampler.next_1d(lane_l, ctr_l)
        ctr_l = torch.where(act, (ctr_l + 1) & MASK, ctr_l)
        t = torch.where(act, t + sample_free_flight(u, M), t)
        act = act & (t < maxt)
        p = o + t[:, None] * d
        flat, in_grid = _voxel_flat(static, p, bmin, inv_vs, res, inside)
        ratio_k = torch.exp(k * log_ratio)
        mask = act & in_grid
        k_at = k
        k = torch.where(act, k + 1.0, k)
        contrib = base * ratio_k
        acc, g_l = _deposit(primal, acc, g_l, dL, flat, contrib, mask)
        if med is not None:
            # c = hist em (st - ss) (1 - st/M)^k / M e^{-st t_prev}: the
            # st / st of the pdf cancels
            H4 = med.hist_em * ratio_k / M
            c_full = contrib * med.em
            dst = -c_full * t_prev - \
                c_full * k_at / torch.clamp(M - st, min=1e-30) + H4
            med.add(dst, -H4, c_full, _gathered(dL, flat, mask), mask)
    if med is not None:
        med.done()
    ctr = ctr.clone()
    ctr[lanes] = ctr_l
    if not primal:
        g = g.clone()
        g[lanes] = g_l
    return acc, g, ctr


def delta_segment(static, arr, primal, acc, g, dL, o, d, t_prev, mei_t, A,
                  em, active, stats=None, inside=None, n_scat=None, sg=None):
    """Delta-tracking deposit at the sampled interaction point; the
    importance-sampled transmittance cancels: A (sa/st) em. sg: as
    dda_segment's."""
    bmin, _, inv_vs, res = _grid(static, arr)
    act = active & torch.isfinite(mei_t)
    p = o + mei_t[:, None] * d
    flat, in_grid = _voxel_flat(static, p, bmin, inv_vs, res, inside)
    hist = _history(static, arr, A, t_prev)
    contrib = hist * (1.0 - arr["albedo"])
    if primal:
        contrib = contrib * em
    mask = act & in_grid
    _count(stats, "steps", mask)
    acc, g = _deposit(primal, acc, g, dL, flat, contrib, mask)
    if not primal and sg is not None:
        # c = hist em (st - ss) e^{-st (t_prev + t_m)} / detach(st
        # e^{-st t_m}): the transmittance attached, the pdf detached
        med = _Med(static, arr, sg, None, hist, em, n_scat)
        c_full = med.hist_em * med.sa
        H3 = med.hist_em / med.st
        t_m = torch.where(torch.isfinite(mei_t), mei_t,
                          torch.zeros_like(mei_t))
        med.add(-c_full * (t_prev + t_m) + H3, -H3, c_full,
                _gathered(dL, flat, mask), mask)
        med.done()
    return acc, g


# --------------------------------------------------------------------------
# the hybrid engine's first scatter and its fast event loop


def _sample_first_scatter(static, arr, sg_o, sg_d, sg_L, sg_amp, sampler,
                          lane, ctr):
    """Importance-sample the first scatter event on K = 2 in-medium
    segments: segment k with probability mass_k / M, mass_k = amp_k
    exp(-st tau_k) (1 - exp(-st L_k)), then the truncated exponential
    along it; the lane's weight is albedo * M. Two draws: u1 (1d), u2
    (2d, the phase function). Returns (o1, d1, A_fs, inside1, alive,
    ctr): inside1 the inside mask at o1 on a two-channel film, else
    False."""
    n = sg_L.shape[0]
    st = arr["sigma_t"]
    tau = torch.cat([torch.zeros((n, 1), dtype=torch.float32,
                                 device=sg_L.device), sg_L[:, :1]], 1)
    mass = sg_amp * torch.exp(-st * tau) * (1.0 - torch.exp(-st * sg_L))
    M = mass[:, 0] + mass[:, 1]
    alive = M > 1e-12

    u1, ctr = sampler.next_1d(lane, ctr)
    pick1 = (u1 * M > mass[:, 0]) & (sg_L[:, 1] > 0.0)
    o_k = torch.where(pick1[:, None], sg_o[:, 1], sg_o[:, 0])
    d_k = torch.where(pick1[:, None], sg_d[:, 1], sg_d[:, 0])
    L_k = torch.where(pick1, sg_L[:, 1], sg_L[:, 0])
    m_k = torch.where(pick1, mass[:, 1], mass[:, 0])
    um = torch.clamp((u1 * M - torch.where(pick1, mass[:, 0],
                                           torch.zeros_like(M))) /
                     torch.clamp(m_k, min=1e-30), 0.0, U_MAX)
    t_ev = -torch.log1p(-um * (1.0 - torch.exp(-st * L_k))) / \
        torch.clamp(st, min=1e-30)
    t_ev = torch.minimum(torch.clamp(t_ev, min=0.0), L_k)
    o1 = o_k + t_ev[:, None] * d_k

    u2, ctr = sampler.next_2d(lane, ctr)
    d1 = sample_phase_direction(static.phase, arr["phase_g"], d_k,
                                u2[:, 0], u2[:, 1])
    if static.sensor.channels == 2:
        bmin, _, _, res = _grid(static, arr)
        inside1 = _inside_at(static, arr, o1, bmin, _inv_extent(static, arr),
                             res)
    else:
        inside1 = torch.zeros((n,), dtype=torch.bool, device=sg_L.device)
    return o1, d1, arr["albedo"] * M, inside1, alive, ctr


def _first_scatter_prologue(static: MarchStatic, arr, o, d, sampler, lane,
                            ctr, stats=None):
    """The forced first scatter without a chord bank
    (drtvam_tpu/ops/march.py:198-325): each lane marches from its ray
    through the scene's surfaces, transmitting only, with no draw and no
    deposit, and records its in-medium chord as up to K = 2 straight 3D
    segments (origin, direction, length, Fresnel amplitude). A null or
    target crossing keeps the direction and the amplitude, so it extends
    the open segment; a dielectric or a change of medium closes it into
    slot min(count, K - 1). A lane whose amplitude reaches 0 ends; after
    2 n_surf + 8 iterations an open segment is closed. Then
    _sample_first_scatter on the 3D segments. stats: counts the lanes'
    iterations ("prologue_iters") and, on a scene with mesh surfaces,
    their mesh work (intersect_scene)."""
    n = o.shape[0]
    dev = o.device
    surfaces = static.surfaces
    bsdf_kind = torch.tensor([s.bsdf for s in surfaces], device=dev)
    med_side = torch.tensor([s.medium_side for s in surfaces], device=dev)
    is_target = torch.tensor([s.is_target for s in surfaces], device=dev)
    K = 2
    f32 = dict(dtype=torch.float32, device=dev)
    amp = torch.ones((n,), **f32)
    in_medium = torch.zeros((n,), dtype=torch.bool, device=dev)
    active = torch.ones((n,), dtype=torch.bool, device=dev)
    sg_o = torch.zeros((n, K, 3), **f32)
    sg_d = torch.zeros((n, K, 3), **f32)
    sg_L = torch.zeros((n, K), **f32)
    sg_amp = torch.zeros((n, K), **f32)
    cnt = torch.zeros((n,), dtype=torch.int64, device=dev)
    cs_o, cs_d = torch.zeros((n, 3), **f32), torch.zeros((n, 3), **f32)
    cs_L, cs_amp = torch.zeros((n,), **f32), torch.zeros((n,), **f32)
    opened = torch.zeros((n,), dtype=torch.bool, device=dev)
    slots = torch.arange(K, device=dev)[None, :]

    def flush(close):
        """The open segment into slot min(cnt, K - 1) of the `close`
        lanes."""
        nonlocal sg_o, sg_d, sg_L, sg_amp, cnt, opened
        onehot = (slots == torch.clamp(cnt, max=K - 1)[:, None]) & \
            close[:, None]
        sg_o = torch.where(onehot[..., None], cs_o[:, None, :], sg_o)
        sg_d = torch.where(onehot[..., None], cs_d[:, None, :], sg_d)
        sg_L = torch.where(onehot, cs_L[:, None], sg_L)
        sg_amp = torch.where(onehot, cs_amp[:, None], sg_amp)
        cnt = cnt + close.to(torch.int64)
        opened = opened & ~close

    for _ in range(2 * len(surfaces) + 8):
        if not bool(active.any()):
            break
        _count(stats, "prologue_iters", active)
        t_si, n_si, sid, valid = intersect_scene(static, arr, o, d, active,
                                                 stats)
        active = active & valid
        sid0 = torch.clamp(sid, min=0)
        hit_target = active & is_target[sid0] & (sid >= 0)
        trav = in_medium & active

        # open a segment at the start of an in-medium stretch
        newseg = trav & ~opened
        cs_o = torch.where(newseg[:, None], o, cs_o)
        cs_d = torch.where(newseg[:, None], d, cs_d)
        cs_amp = torch.where(newseg, amp, cs_amp)
        cs_L = torch.where(newseg, torch.zeros_like(cs_L), cs_L)
        opened = opened | newseg
        cs_L = torch.where(trav, cs_L + t_si, cs_L)

        # the transmission-only BSDF (the prologue never reflects)
        kind = bsdf_kind[sid0]
        d_t, _, F, tir, eta_rel = refract(d, n_si, arr["surf_eta"][sid0])
        is_diel = kind == DIELECTRIC
        w = torch.where(is_diel,
                        torch.where(tir, torch.zeros_like(F),
                                    (1.0 - F) / (eta_rel * eta_rel)),
                        torch.where(kind == NULL, 1.0, 0.0).to(F.dtype))
        d_new = torch.where(is_diel[:, None], d_t, d)
        o = torch.where(active[:, None], o + t_si[:, None] * d, o)
        d = torch.where(active[:, None], d_new, d)
        amp = torch.where(active, amp * w, amp)

        ms = med_side[sid0]
        dn = dot3(d, n_si)
        enters = ((ms == 1) & (dn < 0.0)) | ((ms == 2) & (dn > 0.0))
        in_med_next = active & (hit_target | enters)
        # the stretch ends where the direction or the medium changes; a
        # null or target crossing that stays in the medium extends it
        flush(opened & trav & (is_diel | ~in_med_next))
        active = active & (amp > 0.0)
        in_medium = in_med_next
    flush(opened)  # the iteration cap's flush
    return _sample_first_scatter(static, arr, sg_o, sg_d, sg_L, sg_amp,
                                 sampler, lane, ctr)


def _first_scatter_from_chords(static: MarchStatic, arr, o, aidx, sampler,
                               lane, ctr):
    """The forced first scatter on the pixel's chord: one (12,) record
    of arr["chord_pack"] per lane, read at the pixel's centre column
    (cid = emitter * U + column), lifted to 3D at the lane's own
    jittered z (drtvam_tpu/ops/march.py:328-370)."""
    p = static.projector
    U, h = p.resx, p.resy
    idx = aidx if p.identity else arr["active_pixels"][aidx].to(torch.int64)
    cid = (idx // (h * U)) * U + (idx % (h * U)) % U
    rec = arr["chord_pack"][cid]
    z = o[:, 2][:, None, None].expand(-1, 2, 1)
    sg_o = torch.cat([rec[:, 0:4].reshape(-1, 2, 2), z], -1)
    sg_d = torch.cat([rec[:, 4:8].reshape(-1, 2, 2), torch.zeros_like(z)],
                     -1)
    return _sample_first_scatter(static, arr, sg_o, sg_d, rec[:, 8:10],
                                 rec[:, 10:12], sampler, lane, ctr)


def _inv_extent(static: MarchStatic, arr):
    """Voxels per unit length as the JAX first-scatter seed and fast loop
    compute it (res over the extent, not 1 / voxel size)."""
    X, Y, Z = static.sensor.res
    bmin = arr["bbox_min"]
    return torch.tensor([X, Y, Z], dtype=torch.float32,
                        device=bmin.device) / (arr["bbox_max"] - bmin)


def _exit_distance(static: MarchStatic, arr):
    """The convex medium region's exit distance from inside, (o, d) ->
    t: the far root of a cylinder's side quadratic (0 when the exit lies
    beyond the open tube's z range: the lane dies without an event, as
    in the general march) or a box's far slab."""
    i = residual_surface(static)
    mp = arr["surf_params"][i]
    if static.surfaces[i].kind == CYLINDER:
        r, z0, z1 = mp[0], mp[1], mp[2]

        def exit_dist(o, d):
            ox, oy = o[:, 0], o[:, 1]
            dx, dy, dz = d[:, 0], d[:, 1], d[:, 2]
            a = dx * dx + dy * dy
            b = 2.0 * (ox * dx + oy * dy)
            c = ox * ox + oy * oy - r * r
            disc = torch.clamp(b * b - 4.0 * a * c, min=0.0)
            t_side = torch.where(a > 1e-20, (-b + torch.sqrt(disc)) * 0.5 /
                                 torch.clamp(a, min=1e-20),
                                 torch.full_like(a, INF))
            z_hit = o[:, 2] + t_side * dz
            ok = torch.isfinite(t_side) & (z_hit >= z0) & (z_hit <= z1)
            return torch.where(ok, torch.clamp(t_side, min=0.0),
                               torch.zeros_like(a))
        return exit_dist
    h = mp[:3]

    def exit_dist(o, d):
        inv_d = 1.0 / torch.where(torch.abs(d) > 1e-20, d,
                                  torch.full_like(d, 1e-20))
        t_far = torch.maximum((-h - o) * inv_d, (h - o) * inv_d).amin(-1)
        return torch.clamp(t_far, min=0.0)
    return exit_dist


def _fast_residual_loop(static: MarchStatic, arr, primal, acc, g, dL, o, d,
                        A, em, alive, sampler, lane, ctr, stats=None):
    """The delta residual's events after the forced first scatter, in
    one convex medium region: per event the free flight against the
    exit distance (a lane reaching it is dead), the delta deposit
    A ((1 - albedo) em) at the event voxel, the albedo factor, Russian
    roulette past rr_depth and the phase sample. Up to max_depth - 1
    events; each draws u_rr, u_ff, u_b (unused) and u_ph (2d), the
    general loop's order (drtvam_tpu/ops/march.py:433-549)."""
    st, al = arr["sigma_t"], arr["albedo"]
    bmin, _, _, res = _grid(static, arr)
    inv_vs = _inv_extent(static, arr)
    two = static.sensor.channels == 2
    exit_dist = _exit_distance(static, arr)
    inv_st = 1.0 / torch.clamp(st, min=1e-30)
    base_w = (1.0 - al) * (em if primal else 1.0)
    for j in range(max(static.max_depth - 1, 0)):
        if not bool(alive.any()):
            break
        _count(stats, "iterations", alive)
        u_rr, ctr = sampler.next_1d(lane, ctr)
        if j + 1 > static.rr_depth:
            q = torch.clamp(A, max=0.99)
            survive = u_rr < q
            A = torch.where(alive & survive, A / torch.clamp(q, min=1e-12),
                            A)
            alive = alive & survive
        t_exit = exit_dist(o, d)
        u, ctr = sampler.next_1d(lane, ctr)
        t = -torch.log1p(-torch.clamp(u, 0.0, U_MAX)) * inv_st
        hit = alive & (t < t_exit)
        p = o + t[:, None] * d
        # the event voxel's channel from the inside mask
        inside = _inside_at(static, arr, p, bmin, inv_vs, res) if two \
            else None
        flat, in_grid = _voxel_flat(static, p, bmin, inv_vs, res, inside)
        m = hit & in_grid
        acc, g = _deposit(primal, acc, g, dL, flat, A * base_w, m)
        _count(stats, "steps", m)
        A = torch.where(hit, A * al, A)
        _, ctr = sampler.next_1d(lane, ctr)   # u_b (the BSDF's, unused)
        u_ph, ctr = sampler.next_2d(lane, ctr)
        d = sample_phase_direction(static.phase, arr["phase_g"], d,
                                   u_ph[:, 0], u_ph[:, 1])
        o = p
        alive = hit
    return acc, g


# --------------------------------------------------------------------------
# the bounce loop


def trace_wavefront(static: MarchStatic, arr, lane, seed, spp, dL_flat=None,
                    acc=None, em=None, stats=None, sg=None):
    """Trace the lanes `lane` ((n,) int64 global lane ids, uint32
    values; active index lane // spp).

    arr: the scene's tensors (`scene_tensors`) with "active_data"; the
    first-scatter residual reads its chords from "chord_pack"
    (ops/transport2d.py) where arr holds it, else marches each lane to
    its chord (_first_scatter_prologue).
    primal (dL_flat None): adds the lanes' dose into acc (n_cells,) and
    returns (acc, None); em: optional per-lane emitted intensity before
    the ray-weight scalar (default active_data[lane // spp]).
    adjoint: returns (acc, g) with g the per-lane emitter gradient
    (without em or the ray weight); sg (a static with medium_grads): a
    list of two (n,) float32 tensors, to whose entries each lane's
    d loss / d sigma_t and d loss / d sigma_s partials are added (em
    then the emitted intensity as in the primal, default
    active_data[lane // spp]).
    stats: optional dict counting the estimator's steps ("steps"), the
    lanes' bounce iterations ("iterations"), the prologue's
    ("prologue_iters") and, on a scene that keeps a
    mesh, its grid walks, cells and triangle tests ("walks", "cells",
    "triangles"; intersect_scene).
    radon mode (static.mode "radon"): returns (L, None), L (n,) the
    lanes' in-target absorption (drtvam_tpu/ops/march.py:917-923)."""
    check_supported(static)
    radon = static.mode == "radon"
    primal = dL_flat is None or radon
    dev = lane.device
    n = lane.shape[0]
    sampler = Sampler(seed)
    ctr = sampler.init(n, dev)
    o, d, aidx, ctr = sample_rays(
        static.projector, arr, arr["active_pixels"], lane, spp, sampler,
        ctr, static.regular_sampling, static.sample_time, static.clockwise)
    if sg is not None and (primal or not static.medium_grads):
        raise ValueError("sg: the medium cotangents of an adjoint with "
                         "medium_grads")
    if (primal and not radon) or sg is not None:
        if em is None:
            em = arr["active_data"][aidx]
        em = em * ray_weight(static.projector, arr, spp, arr["print_time"])
    if primal and not radon:
        if acc is None:
            acc = torch.zeros((static.sensor.n_cells,), dtype=torch.float32,
                              device=dev)
    g = None if primal else torch.zeros((n,), dtype=torch.float32,
                                        device=dev)

    surfaces = static.surfaces
    bsdf_kind = torch.tensor([s.bsdf for s in surfaces], device=dev)
    med_side = torch.tensor([s.medium_side for s in surfaces], device=dev)
    is_target = torch.tensor([s.is_target for s in surfaces], device=dev)
    has_diffuse = any(s.bsdf == DIFFUSE for s in surfaces)
    st = arr["sigma_t"]
    est = static.sensor.estimator
    # the radon mode turns scattering off; its Russian roulette still
    # reads the scene's (has_scattering), as the JAX package's does
    scat = static.has_scattering and not radon
    tonly = static.transmission_only

    f32 = dict(dtype=torch.float32, device=dev)
    A = torch.ones((n,), **f32)
    total_t = torch.zeros((n,), **f32)
    n_scat = torch.zeros((n,), **f32)
    inside_target = torch.zeros((n,), dtype=torch.bool, device=dev)
    in_medium = torch.zeros((n,), dtype=torch.bool, device=dev)
    depth = torch.zeros((n,), dtype=torch.int32, device=dev)
    active = torch.ones((n,), dtype=torch.bool, device=dev)
    ones, zeros, infs = (torch.ones((n,), **f32), torch.zeros((n,), **f32),
                         torch.full((n,), INF, **f32))
    L = torch.zeros((n,), **f32) if radon else None
    res_mode = ANALOG if radon else residual_mode(static)
    if res_mode in (FIRST_SCATTER, FAST_RESIDUAL):
        # every lane starts at its forced first scatter event: the
        # pre-scatter attenuation and the event's albedo live in A, so
        # total_t restarts at 0, n_scat at 1 and depth at 1
        if "chord_pack" in arr:
            o, d, A_fs, inside_target, active, ctr = \
                _first_scatter_from_chords(static, arr, o, aidx, sampler,
                                           lane, ctr)
        else:
            o, d, A_fs, inside_target, active, ctr = \
                _first_scatter_prologue(static, arr, o, d, sampler, lane,
                                        ctr, stats)
        A = torch.where(active, A_fs, zeros)
        if res_mode == FAST_RESIDUAL:
            return _fast_residual_loop(static, arr, primal, acc, g, dL_flat,
                                       o, d, A, em, active, sampler, lane,
                                       ctr, stats)
        n_scat = ones.clone()
        in_medium = active.clone()
        depth = torch.ones((n,), dtype=torch.int32, device=dev)

    for _ in range(2 * static.max_depth + 16):
        if not bool(active.any()):
            break
        _count(stats, "iterations", active)
        # Russian roulette; without scattering its survival probability
        # carries the analytic transmittance, as the reference's
        # attenuation does
        rr_A = A if static.has_scattering else A * torch.exp(-st * total_t)
        q = torch.clamp(rr_A, max=0.99)
        perform_rr = depth > static.rr_depth
        u_rr, ctr = sampler.next_1d(lane, ctr)
        active = active & ((u_rr < q) | ~perform_rr)
        A = torch.where(perform_rr & active, A / torch.clamp(q, min=1e-12), A)
        active = active & (A != 0.0)
        in_medium = in_medium & active

        # next surface
        t_si, n_si, sid, si_valid = intersect_scene(static, arr, o, d,
                                                    active, stats)
        active = active & si_valid
        in_medium = in_medium & active
        sid0 = torch.clamp(sid, min=0)
        hit_target = active & is_target[sid0] & (sid >= 0)

        # medium interaction sampling
        u_ff, ctr = sampler.next_1d(lane, ctr)
        if scat:
            mei_t = sample_free_flight(u_ff, st)
            reached_surface = in_medium & (t_si < mei_t)
            mei_t = torch.where(reached_surface, infs, mei_t)
            w_med = torch.where(reached_surface, ones, 1.0 / st)
        else:
            mei_t = infs
            reached_surface = in_medium
            w_med = ones
        medium_event = in_medium & ~reached_surface

        # dose deposit along this segment
        dep_active = (medium_event | reached_surface) & active
        if res_mode != ANALOG:
            # the unscattered deposits belong to the ballistic engine
            dep_active = dep_active & (n_scat > 0.0)
        if radon:
            # the in-target absorption, t summed over every segment
            contrib = A * torch.exp(-st * total_t) * \
                (1.0 - torch.exp(-st * t_si))
            L = L + torch.where(inside_target & in_medium & active, contrib,
                                zeros)
        elif est == "dda":
            acc, g = dda_segment(static, arr, primal, acc, g, dL_flat, o, d,
                                 total_t, t_si, A, em, dep_active, stats,
                                 inside_target, n_scat, sg)
        elif est == "ratio":
            acc, g, ctr = ratio_segment(static, arr, primal, acc, g, dL_flat,
                                        o, d, total_t, t_si, A, em,
                                        dep_active, sampler, lane, ctr,
                                        stats, inside_target, n_scat, sg)
        else:
            acc, g = delta_segment(static, arr, primal, acc, g, dL_flat, o, d,
                                   total_t, mei_t, A, em, dep_active, stats,
                                   inside_target, n_scat, sg)

        # inside / outside parity flip at the target's crossings (may
        # leak, as the reference's)
        inside_target = inside_target ^ hit_target

        # BSDF sampling at surfaces
        active_surface = active & ~medium_event
        kind = bsdf_kind[sid0]
        d_t, d_r, F, tir, eta_rel = refract(d, n_si, arr["surf_eta"][sid0])
        inv_eta2 = 1.0 / (eta_rel * eta_rel)
        u_b, ctr = sampler.next_1d(lane, ctr)
        u_ph, ctr = sampler.next_2d(lane, ctr)
        w_tr = torch.where(tir, zeros, (1.0 - F) * inv_eta2)
        if tonly:
            w_diel, d_diel = w_tr, d_t
        else:
            force_tr = depth == 0
            reflectp = ~force_tr & (u_b < F)
            d_diel = torch.where(reflectp[:, None], d_r, d_t)
            w_diel = torch.where(reflectp, ones, inv_eta2)
            w_diel = torch.where(force_tr, w_tr, w_diel)
        is_diel = kind == DIELECTRIC
        w_bsdf = torch.where(is_diel, w_diel,
                             torch.where(kind == NULL, ones, zeros))
        d_new = torch.where(is_diel[:, None], d_diel, d)
        if has_diffuse and not tonly:
            # diffuse occlusions: cosine-hemisphere reflection on the
            # incident side, weight = reflectance
            is_diff = (kind == DIFFUSE) & ~force_tr
            nl = torch.where((dot3(d, n_si) < 0.0)[:, None], n_si, -n_si)
            tg, btg = _onb(nl)
            h = square_to_cosine_hemisphere(u_ph)
            d_diff = h[:, 0:1] * tg + h[:, 1:2] * btg + h[:, 2:3] * nl
            w_bsdf = torch.where(is_diff, arr["surf_refl"][sid0], w_bsdf)
            d_new = torch.where(is_diff[:, None], d_diff, d_new)

        # phase sampling at medium events
        if scat:
            d_scat = sample_phase_direction(static.phase, arr["phase_g"], d,
                                            u_ph[:, 0], u_ph[:, 1])
            w_event = w_med * (st * arr["albedo"])
            n_scat = torch.where(medium_event, n_scat + 1.0, n_scat)
        else:
            d_scat, w_event = d, ones

        seg_t = torch.where(medium_event, mei_t, t_si)
        o = torch.where(active[:, None], o + seg_t[:, None] * d, o)
        d = torch.where(medium_event[:, None], d_scat,
                        torch.where(active_surface[:, None], d_new, d))
        w = torch.where(medium_event, w_event,
                        torch.where(active_surface, w_bsdf, ones))
        A = torch.where(active, A * w, A)
        if radon:
            total_t = torch.where(active, total_t + t_si, total_t)
        else:
            total_t = torch.where((medium_event | reached_surface) & active,
                                  total_t + seg_t, total_t)

        # medium transition: does the new direction enter the medium?
        ms = med_side[sid0]
        dn = dot3(d, n_si)
        enters = ((ms == 1) & (dn < 0.0)) | ((ms == 2) & (dn > 0.0))
        in_medium = (in_medium & ~reached_surface) | \
            (active_surface & (hit_target | enters))

        active = active & (active_surface | in_medium) & (A != 0.0)
        depth = torch.where(active & ~hit_target, depth + 1, depth)
        active = active & (depth < static.max_depth)
    if radon:
        return L, None
    return acc, g
