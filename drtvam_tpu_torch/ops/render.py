"""Render entry points of the wavefront path tracer (counterpart of
drtvam_tpu/ops/render.py:1-190): the forward dose, its adjoint with
path replay, and the autograd Function around them.

  * `forward(static, arr, data, seed, spp, chunk)` returns the
    unnormalized flat dose accumulator (n_cells,), linear in `data`
    (the active pixels' intensities). The dose volume is
    `raw.reshape(Z, Y, X, C) * inv_vol` (`render`); that multiply lies
    outside the Function, so the chain rule delivers upstream * inv_vol
    to the adjoint, as in the JAX package.
  * `adjoint(static, arr, seed, spp, chunk, dL_flat)` re-traces the same
    paths (same seed) gathering dL_flat at each deposit, sums each
    pixel's lanes in lane order and multiplies by the ray weight:
    the pattern gradient (n_active,).
  * Lane ids are global: lane = active index * spp + k, uint32 values
    as in the JAX package, so a run with 2**32 or more lanes raises.
  * A static whose projector has a `block` (lo, hi) traces the active
    pixels [lo, hi) only (a rank's block, parallel/shard.py): the same
    lanes, with the same ids and streams, as the whole render traces for
    them; the inputs stay (n_active,), and the pattern gradient is 0
    outside the block. The kernels take the block as a launch order over
    its pixels (block_order), with no other change.

Four kernel wrappers, each with its plain version beside it:

    wf_fwd      <- forward   (plain: _forward, trace_wavefront chunk by
                              chunk)
    wf_bwd      <- adjoint   (plain: _adjoint)
    wf_res_fwd  <- forward   of a residual static (scattered_only: the
                              hybrid engine's residual, ops/hybrid.py)
    wf_res_bwd  <- adjoint   of a residual static

and, for a static with medium_grads given the patterns (RenderRaw's
backward where sigma_t or albedo needs a gradient),

    wf_med      <- adjoint(..., data=)  (plain: _adjoint(..., data=): the
                              pattern gradient and the medium cotangents
                              (stg, ssg))

and beside wf_res_fwd its parts, counted apart in `launches`: the dda
forward's walk pass (res_walk, plain: _walk) and the chord table
(_res_chords, plain: _chord_table). The DMD-pixel culling renders
(counterparts of drtvam_tpu/ops/render.py:193-268), forward only, with
the dense (n_patterns * resy * resx,) image as their result:

    wf_radon    <- render_radon   (plain: _radon, trace_wavefront in its
                                   radon mode chunk by chunk)
    wf_corner   <- render_corner  (plain: _corner, one intersect_scene)

The CUDA kernels are csrc/wf_fwd.cu, csrc/wf_bwd.cu, csrc/wf_res_fwd.cu
and csrc/wf_res_bwd.cu, entry points of the one per-lane path template
csrc/wf_trace.cuh (the culling renders csrc/wf_radon.cu and
csrc/wf_corner.cu, through csrc/wf_cull.cuh's persistent kernel); they
replace the XLA code of drtvam_tpu/ops/march.py:913 `trace_wavefront`,
the residual pair in its
residual modes (there is no Pallas kernel on this path). Given CPU
tensors `forward` / `adjoint` run the plain version; given CUDA tensors
they launch the kernel or raise. `launches` counts kernel launches per
kernel.

A CTA traces one DMD row over a group of angles (`block_order`), so
that most deposits land in the row's home z-slice (`home_slices`), with
all lane state in registers (no chunking). The forward gives each
thread one lane, adds deposits with float atomics (into the home
slice's medium voxels, `tile_rows`, held in shared memory, or into the
accumulator), so its sums are not bitwise reproducible; the adjoint
gives each thread one pixel's spp lanes, writes their sum once, in
lane order, and is. The residual pair (csrc/wf_residual.cuh) runs the
same order without the tile (its deposits follow a scatter out of the
row's slice), its lanes handed their angle's frame and their chord's
table entry (without a chord bank, a first-scatter static runs the
kernels' prologue instantiations: each lane marches to its chord, the
geometric prologue; `form_launches` counts them apart, PROLOGUE_FORMS);
its dda forward runs in two passes per batch of CTAs, the
lanes' paths recording their segments (res_path) and persistent threads
walking them (res_walk), so that no warp waits on its longest walk.

A scene with mesh surfaces (the target kept: a surface-aware film, or
the final render of a surface-aware scene; a custom vial's walls;
occlusions) runs the four loop kernels' target instantiations
(WfParams.target, `target_mode`), which intersect every mesh surface
with its own BSDF and medium side and flip the inside flag at the
target's crossings only: each launch also takes the scene's meshes
(WfMesh), their triangle rows (cull_rows) and, for a two-channel
first-scatter residual, the inside mask as bytes (arr["inside_mask"],
set by ops/hybrid.py). A two-channel film's
accumulator holds two floats a voxel; the forward's tile keeps the home
slice's widest rows that fit (tile_rows lays them out widest first, the
kernel keeps what its shared memory holds), and a dda residual record
carries its channel in the sign of its maxt. `form_launches` counts these
instantiations' launches apart. Where the mesh banks fit a CTA's
shared memory, the analog pair runs csrc/wf_target.cu's forms
(tgt_route: the staged adjoint; the dda and ratio forwards' path and walk
passes, a ratio record with its lane's random stream; the delta forward's
one pass). The dda residual's path pass of a scene that transmits only
runs csrc/wf_res_target.cu's (res_tgt_route: persistent threads refilled
lane by lane, the banks staged where they fit, else read from global
memory; the same records in another order).
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..core.rng import Sampler
from ..models.projector import PROJECTOR_KINDS, ray_weight, sample_rays
from ..models.geometry import CYLINDER, MESH
from .march import (ANALOG, ESTIMATORS, FAST_RESIDUAL, FIRST_SCATTER,
                    MarchStatic, _grid, check_supported, dda_max_steps,
                    dda_segment, intersect_scene, ratio_segment,
                    residual_mode, residual_surface, trace_wavefront)
from .medium import PHASE_IDS

DEFAULT_CHUNK = 1 << 16   # plain version: lanes per pass
MAX_SURF = 8              # surfaces a kernel launch takes (WF_MAX_SURF)
# angles a kernel CTA traces one DMD row over, at most: 16 groups of 25
# on the bench scene's 400 angles, 6,400 CTAs over its 400 rows
ANGLES_PER_GROUP = 25
# what the kernels count when asked (`stats`): bounce iterations,
# estimator steps, deposits into the home-slice tile and to global
# memory, and lane slots (32 per warp for each step of its longest lane;
# the residual's delta: each event; the dda residual forward and the
# target forms' split forward: each step of the walk pass's warps); with
# mesh surfaces, their grid cells visited, triangles tested and grid
# walks that entered a grid's box (MESH_COUNTERS)
COUNTERS = ("iterations", "steps", "tile_deposits", "global_deposits",
            "lane_slots", "cells", "triangles", "walks")
MESH_COUNTERS = COUNTERS[5:]
# what the dda residual's path passes count beside them: 32 lane slots
# for each bounce iteration and each triangle test of a warp's longest
# lane (the one-pass instantiation: over a lane's whole path; the target
# form: over each bounce), so that iterations / iteration_slots and
# triangles / triangle_slots are their SIMT efficiencies
SLOT_COUNTERS = ("iteration_slots", "triangle_slots")
# what a first-scatter residual launch without a chord bank counts beside
# the COUNTERS: the lanes' iterations of the geometric prologue (its
# intersections count with the mesh work)
PROLOGUE_COUNTER = "prologue_iters"

KERNELS = ("wf_fwd", "wf_bwd")              # the analog pair
RES_KERNELS = ("wf_res_fwd", "wf_res_bwd")  # the residual pair
CULL_KERNELS = ("wf_radon", "wf_corner")    # the culling renders
# the analog pair's target forms (csrc/wf_target.cu: the staged adjoint,
# the dda forward's path and walk passes), one library beside the others
TGT_LIB = "wf_target"
# the residual pair's target form (csrc/wf_res_target.cu: the dda
# residual forward's path pass with the target kept), one library too
RES_TGT_LIB = "wf_res_target"
# the medium adjoint (csrc/wf_med.cu): the analog adjoint's paths for
# the medium cotangents of a medium_grads static alone, given the
# patterns, over the pixels that emit
MED_LIB = "wf_med"
LIBS = KERNELS + RES_KERNELS + CULL_KERNELS + (TGT_LIB, RES_TGT_LIB, MED_LIB)
# entry points of csrc/wf_res_fwd.cu beside its per-lane kernel, counted
# apart: the dda forward's walk pass and the chord table's prologue
RES_PARTS = ("wf_res_walk", "wf_res_chords")
# the target forms' forwards: the dda and ratio path passes count as
# wf_fwd, their walk pass apart; the delta form as wf_fwd and apart
TGT_PARTS = ("wf_tgt_walk", "wf_tgt_delta")
# the residual's target path pass: counted as wf_res_fwd (and its form)
# and apart
RES_TGT_PARTS = ("wf_res_tgt_path",)
launches = {k: 0 for k in KERNELS + RES_KERNELS + CULL_KERNELS + RES_PARTS
            + TGT_PARTS + RES_TGT_PARTS + (MED_LIB,)}
# the launches of the target instantiations of the loop kernels, beside
# their kernel's count in `launches`: "<kernel>:target1" (the target mesh
# kept, one channel) and "<kernel>:target2" (a two-channel film); the
# residual's walk pass has a two-channel form only (one channel walks as
# without a target); the medium adjoint's staged form "wf_med:staged"
# (the banks in shared memory) beside its target forms
TARGET_FORMS = tuple(f"{k}:target{t}" for k in KERNELS + RES_KERNELS
                     + TGT_PARTS + (MED_LIB,) for t in (1, 2)) + (
                         "wf_res_walk:target2", f"{MED_LIB}:staged")
# the residual's launches without a chord bank (the geometric prologue's
# instantiations), beside their kernel's count: "wf_res_fwd:prologue" each
# forward's single pass or path pass, "wf_res_tgt_path:prologue" those of
# them on the target path pass, "wf_res_bwd:prologue" each adjoint
PROLOGUE_FORMS = ("wf_res_fwd:prologue", "wf_res_bwd:prologue",
                  "wf_res_tgt_path:prologue")
form_launches = {k: 0 for k in TARGET_FORMS + PROLOGUE_FORMS}
# what the culling kernels count when asked: bounce iterations, mesh grid
# cells visited, triangles tested, triangle slots (32 for each test of a
# warp task's busiest lane: the tests' SIMT efficiency is triangles /
# slots), grid walks that entered their box, lanes with one or more, and
# tests of a triangle the walk had tested in an earlier cell
CULL_COUNTERS = ("iterations", "cells", "triangles", "triangle_slots",
                 "walks", "lanes_in_box", "repeats")
# bytes of shared memory the culling kernels' staged mesh banks may take:
# past the CTA's share of the SM (csrc/wf_cull.cuh cull_shape) they read
# the global copies; 0 forces that path
CULL_SMEM_LIMIT = 1 << 30
# the lane modes of the culling kernels (csrc/wf_trace.cuh)
RADON, CORNER = 4, 5
# the dda residual forward's segment records (32 bytes each): a buffer of
# at most SPLIT_MAX_RECORDS (2 GB), allocated once per engine; batches of
# CTAs sized from the records a lane made so far (SPLIT_GUESS before the
# first batch), with SPLIT_MARGIN to spare
SPLIT_MAX_RECORDS = (2 << 30) // 32
SPLIT_GUESS = 2.0
SPLIT_MARGIN = 1.25
# z-slabs the walk pass runs a batch's records in, one pass each, so that
# the part of the dose grid its float atomics reach fits the card's L2
WALK_SLABS = 2
# bytes the residual target form's staged banks may take at most (0: read
# from global memory; the kernel also caps them by a CTA's share of the SM)
RES_TGT_SMEM_LIMIT = 1 << 30
# the target forms' dda forward (tgt_forward): units of at most
# TGT_UNIT_LANES lanes of one launch-order CTA; a record buffer of at most
# TGT_MAX_RECORDS 32-byte records (512 MB) a launch; each unit's region
# sized from the records a lane of that unit made in the last launch
# (TGT_GUESS before the first), with TGT_MARGIN and TGT_SLACK records to
# spare (a segment past it is walked by the path pass at once)
TGT_UNIT_LANES = 16384
TGT_MAX_RECORDS = (512 << 20) // 32
TGT_GUESS = 2.0
TGT_MARGIN = 1.125
TGT_SLACK = 32
# on the card the buffer's two halves take turns, a batch's walk pass on a
# second stream beside the next batch's path pass
TGT_OVERLAP = True


def reset_launches():
    for k in launches:
        launches[k] = 0
    for k in form_launches:
        form_launches[k] = 0


def _count(name, P, prologue=False):
    """One launch of kernel `name` in the instantiation P selects
    (prologue: the geometric prologue's)."""
    launches[name] += 1
    for form in (f"{name}:target{P.target}",
                 f"{name}:prologue" if prologue else None):
        if form in form_launches:
            form_launches[form] += 1


def _chunking(n_lanes, chunk, spp=1):
    """Pixel-aligned chunks: every spp lanes of a pixel in one chunk."""
    chunk = max(spp, min(chunk, n_lanes))
    chunk -= chunk % spp
    return chunk, -(-n_lanes // chunk)


def _n_lanes(static: MarchStatic, spp):
    n = static.projector.n_active * spp
    if n >= 2 ** 32:
        raise ValueError(f"{static.projector.n_active} active pixels x spp "
                         f"{spp} = {n} lanes: lane ids are uint32")
    return n


def pixel_range(static: MarchStatic):
    """[lo, hi): the active indices the static traces (its block, or
    every active pixel)."""
    p = static.projector
    return (0, p.n_active) if p.block is None else p.block


def arithmetic_order(p):
    """Whether the kernels compute projector p's launch order themselves:
    the identity store, traced whole (a block of it runs as a sparse
    store, its order given: block_order)."""
    return p.identity and p.block is None


def _grad_out(static: MarchStatic, dev):
    """The pattern gradient's output (n_active,): zeros for a block, whose
    kernels write its pixels only."""
    n = static.projector.n_active
    f32 = dict(dtype=torch.float32, device=dev)
    return torch.empty((n,), **f32) if static.projector.block is None \
        else torch.zeros((n,), **f32)


# --------------------------------------------------------------------------
# plain versions


def _forward(static: MarchStatic, arr, data, seed, spp, chunk, stats=None):
    """The dose accumulator, chunk by chunk through trace_wavefront."""
    _n_lanes(static, spp)
    lo, hi = (spp * i for i in pixel_range(static))
    chunk, n_chunks = _chunking(hi - lo, chunk, spp)
    arr = dict(arr, active_data=data)
    acc = torch.zeros((static.sensor.n_cells,), dtype=torch.float32,
                      device=data.device)
    for i in range(n_chunks):
        lane = torch.arange(lo + i * chunk, min(lo + (i + 1) * chunk, hi),
                            dtype=torch.int64, device=data.device)
        acc, _ = trace_wavefront(static, arr, lane, seed, spp, acc=acc,
                                 em=data[lane // spp], stats=stats)
    return acc


def _adjoint(static: MarchStatic, arr, seed, spp, chunk, dL_flat,
             stats=None, data=None):
    """The pattern gradient (n_active,): per-lane emitter gradients
    summed per pixel in lane order, times the ray weight. data (a static
    with medium_grads): the patterns, whose emitted intensities the
    medium cotangents take (drtvam_tpu/ops/render.py:91-133); returns
    (pattern gradient, stg, ssg) then, stg and ssg the summed
    d loss / d sigma_t and d loss / d sigma_s (float32 0-d tensors)."""
    n_active = static.projector.n_active
    _n_lanes(static, spp)
    l0, l1 = (spp * i for i in pixel_range(static))
    chunk, n_chunks = _chunking(l1 - l0, chunk, spp)
    dev = dL_flat.device
    pg = torch.zeros((n_active,), dtype=torch.float32, device=dev)
    sums = torch.zeros((2,), dtype=torch.float32, device=dev)
    for i in range(n_chunks):
        lo, hi = l0 + i * chunk, min(l0 + (i + 1) * chunk, l1)
        lane = torch.arange(lo, hi, dtype=torch.int64, device=dev)
        sg = None if data is None else [
            torch.zeros((hi - lo,), dtype=torch.float32, device=dev)
            for _ in range(2)]
        _, g = trace_wavefront(
            static, arr, lane, seed, spp, dL_flat=dL_flat, stats=stats,
            em=None if data is None else data[lane // spp], sg=sg)
        g = g.reshape(-1, spp)
        g_pix = g[:, 0]
        for k in range(1, spp):
            g_pix = g_pix + g[:, k]
        pg[lo // spp:hi // spp] = g_pix
        if sg is not None:
            sums = sums + torch.stack([sg[0].sum(), sg[1].sum()])
    pg = pg * ray_weight(static.projector, arr, spp, arr["print_time"])
    return pg if data is None else (pg, sums[0], sums[1])


# --------------------------------------------------------------------------
# CUDA kernels


class WfParams(ctypes.Structure):
    """Mirror of `WfParams` in csrc/wf_trace.cuh: every field 4 bytes."""
    _fields_ = [
        ("kind", ctypes.c_int), ("n_patterns", ctypes.c_int),
        ("resx", ctypes.c_int), ("resy", ctypes.c_int),
        ("n_active", ctypes.c_int), ("identity", ctypes.c_int),
        ("spp", ctypes.c_int), ("regular_sampling", ctypes.c_int),
        ("sample_time", ctypes.c_int), ("clockwise", ctypes.c_int),
        ("pixel_size", ctypes.c_float * 2),
        ("aperture_radius", ctypes.c_float),
        ("focus_distance", ctypes.c_float),
        ("motion_distance", ctypes.c_float), ("ray_w", ctypes.c_float),
        ("res", ctypes.c_int * 3), ("bbox_min", ctypes.c_float * 3),
        ("bbox_max", ctypes.c_float * 3),
        ("sigma_t", ctypes.c_float), ("albedo", ctypes.c_float),
        ("phase_g", ctypes.c_float), ("majorant", ctypes.c_float),
        ("phase", ctypes.c_int),
        ("estimator", ctypes.c_int), ("has_scattering", ctypes.c_int),
        ("transmission_only", ctypes.c_int),
        ("max_depth", ctypes.c_int), ("rr_depth", ctypes.c_int),
        ("dda_max_steps", ctypes.c_int), ("seed", ctypes.c_uint),
        ("n_surf", ctypes.c_int),
        ("surf_kind", ctypes.c_int * MAX_SURF),
        ("surf_bsdf", ctypes.c_int * MAX_SURF),
        ("surf_medium_side", ctypes.c_int * MAX_SURF),
        ("surf_is_target", ctypes.c_int * MAX_SURF),
        ("surf_params", ctypes.c_float * (3 * MAX_SURF)),
        ("surf_eta", ctypes.c_float * MAX_SURF),
        ("surf_refl", ctypes.c_float * MAX_SURF),
        ("n_groups", ctypes.c_int), ("group", ctypes.c_int),
        ("tile_n", ctypes.c_int),
        ("residual", ctypes.c_int), ("res_surf", ctypes.c_int),
        ("target", ctypes.c_int),
    ]


def _host(x):
    return x.detach().cpu().reshape(-1).tolist()


def target_mode(static: MarchStatic):
    """WfParams.target: 0 the scene has no mesh surface; 1 it has one (the
    target kept, a one-channel render whose segments split at the target's
    crossings; a mesh vial's walls; occlusions); 2 a two-channel
    (surface-aware) film."""
    if static.sensor.channels == 2:
        return 2
    return int(any(s.kind == MESH for s in static.surfaces))


def make_params(static: MarchStatic, arr, seed, spp):
    """The kernels' WfParams from the static description and the scene
    tensors. Every float is the scene's float32 value (exact through
    ctypes); ray_w is the plain version's float32 ray weight."""
    check_supported(static)
    surfaces = static.surfaces
    if len(surfaces) > MAX_SURF:
        raise ValueError(f"wf kernels take at most {MAX_SURF} surfaces, "
                         f"the scene has {len(surfaces)}")
    p = static.projector
    P = WfParams()
    P.kind = PROJECTOR_KINDS.index(p.kind)
    P.n_patterns, P.resx, P.resy, P.n_active = (p.n_patterns, p.resx, p.resy,
                                                p.n_active)
    P.identity = int(arithmetic_order(p))
    P.spp = int(spp)
    P.regular_sampling = int(static.regular_sampling)
    P.sample_time = int(static.sample_time)
    P.clockwise = int(static.clockwise)
    P.pixel_size[:] = _host(arr["pixel_size"])[:2]
    P.aperture_radius = _host(arr["aperture_radius"])[0]
    P.focus_distance = _host(arr["focus_distance"])[0]
    P.motion_distance = _host(arr["motion_distance"])[0]
    P.ray_w = _host(ray_weight(p, arr, spp, arr["print_time"]))[0]
    P.res[:] = list(static.sensor.res)
    P.bbox_min[:] = _host(arr["bbox_min"])
    P.bbox_max[:] = _host(arr["bbox_max"])
    for k in ("sigma_t", "albedo", "phase_g", "majorant"):
        setattr(P, k, _host(arr[k])[0])
    P.phase = PHASE_IDS.get(static.phase, -1)
    P.estimator = ESTIMATORS.index(static.sensor.estimator)
    P.has_scattering = int(static.has_scattering)
    P.transmission_only = int(static.transmission_only)
    P.max_depth, P.rr_depth = static.max_depth, static.rr_depth
    P.dda_max_steps = dda_max_steps(static.sensor.res)
    P.seed = int(seed) & 0xFFFFFFFF
    P.n_surf = len(surfaces)
    params = _host(arr["surf_params"])
    eta, refl = _host(arr["surf_eta"]), _host(arr["surf_refl"])
    for i, s in enumerate(surfaces):
        P.surf_kind[i], P.surf_bsdf[i] = s.kind, s.bsdf
        P.surf_medium_side[i] = s.medium_side
        P.surf_is_target[i] = int(s.is_target)
        P.surf_params[3 * i:3 * i + 3] = params[3 * i:3 * i + 3]
        P.surf_eta[i], P.surf_refl[i] = eta[i], refl[i]
    P.n_groups, P.group = angle_groups(p.n_patterns)
    P.residual = residual_mode(static)
    P.res_surf = residual_surface(static) \
        if P.residual == FAST_RESIDUAL else 0
    P.target = target_mode(static)
    return P


class WfMesh(ctypes.Structure):
    """Mirror of `WfMesh` in csrc/wf_mesh.cuh: the mesh banks' pointers
    (8 bytes each, first), then per surface its triangles and its grid
    (4-byte ints; grid_res 0: brute force)."""
    _fields_ = [(k, ctypes.c_void_p) for k in (
        "v0", "e1", "e2", "n", "cell_start", "tri_ids", "grid_bbox")] + [
        ("tri_start", ctypes.c_int * MAX_SURF),
        ("tri_count", ctypes.c_int * MAX_SURF),
        ("grid_res", ctypes.c_int * (3 * MAX_SURF)),
        ("cell_offset", ctypes.c_int * MAX_SURF),
        ("ids_offset", ctypes.c_int * MAX_SURF),
        ("n_ids", ctypes.c_int * MAX_SURF),
        ("bbox_row", ctypes.c_int * MAX_SURF),
        ("n_rows", ctypes.c_int), ("n_cell_start", ctypes.c_int),
        ("n_tri_ids", ctypes.c_int),
    ]


# (WfMesh field, scene tensor, dtype)
_MESH_BANKS = (("v0", "tri_v0", torch.float32),
               ("e1", "tri_e1", torch.float32),
               ("e2", "tri_e2", torch.float32),
               ("n", "tri_n", torch.float32),
               ("cell_start", "grid_cell_start", torch.int32),
               ("tri_ids", "grid_tri_ids", torch.int32),
               ("grid_bbox", "grid_bbox", torch.float32))


class CullArgs(ctypes.Structure):
    """Mirror of `CullArgs` in csrc/wf_cull.cuh: the culling launch's
    buffers (8-byte pointers), then its 4-byte fields."""
    _fields_ = [(k, ctypes.c_void_p) for k in (
        "active_pixels", "rows", "frames", "img", "next", "counters")] + [
        ("dist", ctypes.c_float), ("radius", ctypes.c_float),
        ("n_rows", ctypes.c_int), ("n_cell_start", ctypes.c_int),
        ("n_tri_ids", ctypes.c_int), ("smem_limit", ctypes.c_int),
    ]


class TgtArgs(ctypes.Structure):
    """Mirror of `TgtArgs` in csrc/wf_target.cuh: a batch of the target
    forms' split forward (the record buffer, the units' regions and record
    counts, the units, the accumulator), then its units' range, then the
    ratio records' streams (lane, counter: two uint32 a record)."""
    _fields_ = [(k, ctypes.c_void_p) for k in (
        "recs", "region", "counts", "units", "acc")] + [
        ("u0", ctypes.c_int), ("u1", ctypes.c_int),
        ("keys", ctypes.c_void_p),
    ]


def cull_rows(arr):
    """The culling kernels' triangle rows, (3 T, 4) float32: triangle i's
    v0, e1 and e2 at rows 3 i, 3 i + 1 and 3 i + 2 as (x, y, z, 0), so that
    a test reads three 16-byte rows (csrc/wf_mesh.cuh MeshBanks). Built
    from the scene tensors' banks once and cached in their dict."""
    v0, e1, e2 = arr["tri_v0"], arr["tri_e1"], arr["tri_e2"]
    key = tuple(t.data_ptr() for t in (v0, e1, e2)) + (v0.shape[0],)
    cached = arr.get("_cull_rows")
    if cached is None or cached[0] != key:
        rows = torch.zeros((v0.shape[0], 3, 4), dtype=torch.float32,
                           device=v0.device)
        for k, t in enumerate((v0, e1, e2)):
            rows[:, k, :3] = t
        cached = (key, rows.reshape(-1, 4))
        arr["_cull_rows"] = cached
    return cached[1]


def make_mesh(name, static: MarchStatic, arr):
    """The kernels' WfMesh: pointers into the scene tensors' mesh banks
    (which must outlive the launch) and each mesh surface's slices of
    them."""
    M = WfMesh()
    for field, key, dtype in _MESH_BANKS:
        t = arr[key]
        _check(name, t, dtype, tuple(t.shape))
        setattr(M, field, t.data_ptr())
    M.n_rows = 3 * arr["tri_v0"].shape[0]
    M.n_cell_start = arr["grid_cell_start"].shape[0]
    M.n_tri_ids = arr["grid_tri_ids"].shape[0]
    for i, s in enumerate(static.surfaces):
        if s.kind != MESH:
            continue
        M.tri_start[i], M.tri_count[i] = s.tri_slice
        g = s.grid
        if g is not None:
            M.grid_res[3 * i:3 * i + 3] = list(g.res)
            M.cell_offset[i], M.ids_offset[i] = g.cell_offset, g.ids_offset
            M.n_ids[i], M.bbox_row[i] = g.n_ids, g.bbox_row
    return M


# --------------------------------------------------------------------------
# the kernels' launch order


def angle_groups(n_patterns):
    """(groups per DMD row, angles per group): as few groups as keep each
    at most ANGLES_PER_GROUP angles, the angles spread evenly."""
    n_groups = -(-n_patterns // ANGLES_PER_GROUP)
    return n_groups, -(-n_patterns // n_groups)


def home_slices(static: MarchStatic, arr):
    """(resy,) int64: the film z-slice holding each DMD row's centre
    height, where a collimated ray of the row deposits; -1 outside the
    film. The float32 operations of csrc/wf_trace.cuh `home_slice`."""
    h, Z = static.projector.resy, static.sensor.res[2]
    bmin, _, inv_vs, _ = _grid(static, arr)
    ey = torch.tensor(float(h), dtype=torch.float32) * \
        arr["pixel_size"][1].cpu()
    sy = (torch.arange(h, dtype=torch.float32) + 0.5) / float(h)
    k = torch.floor(((0.5 - sy) * ey - bmin[2].cpu()) * inv_vs[2].cpu())
    return torch.where((k >= 0) & (k < Z), k, -1.0).to(torch.int64)


def block_order(static: MarchStatic, arr):
    """The active indices in the order the kernels trace them, sorted by
    (DMD row, angle, pixel), and each CTA's first position: CTA
    c = row * n_groups + angle // group traces positions
    [starts[c], starts[c + 1]). Returns int64 (order (n_active,), starts
    (resy * n_groups + 1,)) on the scene tensors' device. For the
    identity store the kernels compute the same order arithmetically
    (csrc/wf_trace.cuh block_range, lane_aidx). A static with a block
    orders the block's active indices alone (order (hi - lo,)), and the
    kernels take it as a sparse store's."""
    p = static.projector
    A, h, w = p.n_patterns, p.resy, p.resx
    n_groups, group = angle_groups(A)
    dev = arr["active_pixels"].device
    if arithmetic_order(p):
        j = torch.arange(p.n_active, device=dev)
        py, r = j // (A * w), j % (A * w)
        order = ((r // w) * h + py) * w + r % w
        c = torch.arange(h * n_groups + 1, device=dev)
        starts = (c // n_groups) * (A * w) + \
            torch.clamp((c % n_groups) * group, max=A) * w
        return order, starts
    lo, hi = pixel_range(static)
    idx = arr["active_pixels"][lo:hi].to(torch.int64)
    a, pix = idx // (h * w), idx % (h * w)
    py, px = pix // w, pix % w
    order = torch.argsort((py * A + a) * w + px, stable=True)
    block = py[order] * n_groups + a[order] // group
    order = order + lo
    starts = torch.searchsorted(
        block, torch.arange(h * n_groups + 1, device=dev))
    return order, starts


def tile_rows(static: MarchStatic, arr):
    """The home-slice tile's layout, the same for every slice: for each
    film row y the n voxel columns from lo that the medium may reach and
    the tile index of column 0 (offset - lo), as int32 rows (lo, n,
    offset - lo, 0), (resy, 4); and the tile's voxel count. The medium
    lies inside the surfaces whose interior is medium (cylinders and
    boxes about the z axis, a mesh vial's inner wall): a row keeps the
    columns whose voxels meet their cross-section (a mesh's: the x range
    of its triangles within the row, mesh_row_spans), one more each
    side; with no such surface, the whole row. A deposit elsewhere goes
    to global memory, so the layout only has to hold most of them. On a
    two-channel film a voxel takes two floats, and the whole layout may
    not fit the CTA's shared memory: the rows are laid out widest first,
    and the kernel keeps those that fit (csrc/wf_trace.cuh shape())."""
    X, Y, _ = static.sensor.res
    bmin = arr["bbox_min"].detach().cpu().double().numpy()
    bmax = arr["bbox_max"].detach().cpu().double().numpy()
    params = arr["surf_params"].detach().cpu().double().numpy().reshape(
        -1, 3)
    vs = (bmax - bmin) / np.asarray(static.sensor.res, np.float64)
    y0 = bmin[1] + np.arange(Y) * vs[1]
    y1 = y0 + vs[1]
    lo, hi = np.full(Y, X), np.zeros(Y, np.int64)
    inner = [(s, params[i]) for i, s in enumerate(static.surfaces)
             if s.medium_side == 1]
    if not inner:
        lo[:] = 0
        hi[:] = X
    for s, p in inner:
        if s.kind == CYLINDER:
            near = np.where((y0 <= 0) & (y1 >= 0), 0.0,
                            np.minimum(np.abs(y0), np.abs(y1)))
            meets = near <= p[0]
            half = np.sqrt(np.maximum(p[0] ** 2 - near ** 2, 0.0))
            x0, x1 = -half, half
        elif s.kind == MESH:
            meets, x0, x1 = mesh_row_spans(s, arr, y0, y1)
        else:
            meets = (y1 >= -p[1]) & (y0 <= p[1])
            x0, x1 = np.full(Y, -p[0]), np.full(Y, p[0])
        a = np.clip(np.floor((x0 - bmin[0]) / vs[0]) - 1, 0, X)
        b = np.clip(np.floor((x1 - bmin[0]) / vs[0]) + 2, 0, X)
        lo = np.where(meets, np.minimum(lo, a), lo).astype(np.int64)
        hi = np.where(meets, np.maximum(hi, b), hi).astype(np.int64)
    n = np.maximum(hi - lo, 0)
    lo = np.where(n > 0, lo, 0)
    first = (np.argsort(-n, kind="stable") if static.sensor.channels == 2
             else np.arange(Y))
    off = np.empty(Y, np.int64)
    off[first] = np.cumsum(n[first]) - n[first]
    rows = np.stack([lo, n, off - lo, np.zeros_like(n)], 1)
    return torch.from_numpy(rows.astype(np.int32)), int(n.sum())


def mesh_row_spans(s, arr, y0, y1):
    """The x range of mesh surface s's triangles within each band
    [y0, y1] of y (float64, the film's rows): (meets, x0, x1), meets
    False where no triangle reaches the band. A triangle's part in a band
    is convex and bounded by its edges' parts, so the range is the x
    range of the edges clipped to the band (bands taken in chunks of at
    most 2 M band-edge pairs)."""
    a, c = s.tri_slice
    v0, e1, e2 = (arr[k][a:a + c].detach().cpu().double().numpy()[:, :2]
                  for k in ("tri_v0", "tri_e1", "tri_e2"))
    v1, v2 = v0 + e1, v0 + e2
    p = np.concatenate([v0, v1, v2])[None]       # the edges' ends
    q = np.concatenate([v1, v2, v0])[None]
    dy = q[..., 1] - p[..., 1]
    flat = dy == 0.0
    safe = np.where(flat, 1.0, dy)
    n = y0.shape[0]
    meets = np.zeros(n, bool)
    x0, x1 = np.zeros(n), np.zeros(n)
    step = max(1, (2 << 20) // p.shape[1])
    for r in range(0, n, step):
        lo_y, hi_y = y0[r:r + step, None], y1[r:r + step, None]
        ta, tb = (lo_y - p[..., 1]) / safe, (hi_y - p[..., 1]) / safe
        t0 = np.where(flat, 0.0, np.maximum(np.minimum(ta, tb), 0.0))
        t1 = np.where(flat, 1.0, np.minimum(np.maximum(ta, tb), 1.0))
        hit = np.where(flat, (p[..., 1] >= lo_y) & (p[..., 1] <= hi_y),
                       t0 <= t1)
        xa = p[..., 0] + t0 * (q[..., 0] - p[..., 0])
        xb = p[..., 0] + t1 * (q[..., 0] - p[..., 0])
        m = hit.any(1)
        meets[r:r + step] = m
        x0[r:r + step] = np.where(
            m, np.where(hit, np.minimum(xa, xb), np.inf).min(1), 0.0)
        x1[r:r + step] = np.where(
            m, np.where(hit, np.maximum(xa, xb), -np.inf).max(1), 0.0)
    return meets, x0, x1


def _launch_layout(static: MarchStatic, arr):
    """(order, starts, rows, tile_n) for a launch on the scene tensors
    `arr`, built once per scene and cached in their dict: the sparse
    store's order as int32 (None, None for the identity store, whose
    order the kernels compute; a block's is given) and the tile layout on
    arr's device."""
    p = static.projector
    key = (p.n_patterns, p.resx, p.resy, p.n_active, p.identity, p.block,
           static.sensor.res, static.sensor.channels, static.surfaces)
    cached = arr.get("_wf_layout")
    if cached is None or cached[0] != key:
        dev = arr["active_pixels"].device
        order = starts = None
        if not arithmetic_order(p):
            order, starts = (t.to(torch.int32).contiguous()
                             for t in block_order(static, arr))
        rows, n = tile_rows(static, arr)
        cached = (key, order, starts, rows.to(dev), n)
        arr["_wf_layout"] = cached
    return cached[1:]


_PTR = ctypes.c_void_p
# every loop entry point takes (P, M, tris) first: the scene's mesh and
# the target's triangle rows; the residual's then the inside mask
# (_target_args)
_TGT = [ctypes.POINTER(WfParams), ctypes.POINTER(WfMesh), _PTR]
_ARGS = {
    # (P, M, tris, in, active_pixels, order, starts, rows, out, counters,
    # stream)
    "wf_fwd": _TGT + [_PTR] * 8,
    "wf_bwd": _TGT + [_PTR] * 8,
    # (P, M, tris, mask, in, active_pixels, order, starts, chords,
    # chord_tab, out, counters, stream)
    "wf_res_fwd": _TGT + [_PTR] * 10,
    "wf_res_bwd": _TGT + [_PTR] * 10,
    # (P, M, tris, mask, c0, c1, in, active_pixels, order, starts, chords,
    # chord_tab, recs, n_recs, cap, counters, slots, stream); the target
    # form's path pass the same with smem_limit before the stream
    "wf_res_path": _TGT + [_PTR, ctypes.c_int, ctypes.c_int] +
                   [_PTR] * 8 + [ctypes.c_uint, _PTR, _PTR, _PTR],
    "wf_res_tgt_path": _TGT + [_PTR, ctypes.c_int, ctypes.c_int] +
                       [_PTR] * 8 + [ctypes.c_uint, _PTR, _PTR,
                                     ctypes.c_int, _PTR],
    # (P, runs)
    "wf_res_tgt_runs": [ctypes.POINTER(WfParams),
                        ctypes.POINTER(ctypes.c_int)],
    # (P, recs, n, next, zlo, zhi, acc, counters, stream)
    "wf_res_walk": [ctypes.POINTER(WfParams), _PTR, ctypes.c_uint, _PTR,
                    ctypes.c_int, ctypes.c_int, _PTR, _PTR, _PTR],
    # (bank, n, sigma_t, tab, stream)
    "wf_res_chords": [_PTR, ctypes.c_int, ctypes.c_float, _PTR, _PTR],
    # (P, M, fits)
    "wf_tgt_fits": [ctypes.POINTER(WfParams), ctypes.POINTER(WfMesh),
                    ctypes.POINTER(ctypes.c_int)],
    # (P, M, tris, dL, active_pixels, order, starts, grad, counters, stream)
    "wf_tgt_bwd": _TGT + [_PTR] * 7,
    # (P, M, tris, data, active_pixels, order, starts, A, counters, stream)
    "wf_tgt_path": _TGT + [_PTR] * 4 + [ctypes.POINTER(TgtArgs), _PTR,
                                        _PTR],
    "wf_tgt_delta": _TGT + [_PTR] * 4 + [ctypes.POINTER(TgtArgs), _PTR,
                                         _PTR],
    # (P, A, rows, counters, stream)
    "wf_tgt_walk": [ctypes.POINTER(WfParams), ctypes.POINTER(TgtArgs),
                    _PTR, _PTR, _PTR],
    # (P, M, tris, dL, data, active_pixels, order, starts, task_base,
    # cidx, count, partials, n_tasks, sums, staged, stream)
    "wf_med": _TGT + [_PTR] * 9 + [ctypes.c_int, _PTR, ctypes.c_int, _PTR],
    # (P, M, fits)
    "wf_med_fits": [ctypes.POINTER(WfParams), ctypes.POINTER(WfMesh),
                    ctypes.POINTER(ctypes.c_int)],
    # (P, M, A, stream)
    "wf_radon": [ctypes.POINTER(WfParams), ctypes.POINTER(WfMesh),
                 ctypes.POINTER(CullArgs), _PTR],
    "wf_corner": [ctypes.POINTER(WfParams), ctypes.POINTER(WfMesh),
                  ctypes.POINTER(CullArgs), _PTR],
}
# the entry points each kernel library holds, and its launch-shape queries
_ENTRIES = {"wf_fwd": ("wf_fwd",), "wf_bwd": ("wf_bwd",),
            "wf_res_fwd": ("wf_res_fwd", "wf_res_path", "wf_res_walk",
                           "wf_res_chords"),
            "wf_res_bwd": ("wf_res_bwd",), "wf_radon": ("wf_radon",),
            "wf_corner": ("wf_corner",),
            TGT_LIB: ("wf_tgt_fits", "wf_tgt_bwd", "wf_tgt_path",
                      "wf_tgt_walk", "wf_tgt_delta", "wf_tgt_info"),
            RES_TGT_LIB: ("wf_res_tgt_runs", "wf_res_tgt_path",
                          "wf_res_tgt_info"),
            MED_LIB: ("wf_med", "wf_med_fits")}
_INFO = {"wf_fwd_info": [ctypes.POINTER(WfParams), ctypes.c_int],
         "wf_bwd_info": [ctypes.POINTER(WfParams), ctypes.c_int],
         "wf_med_info": [ctypes.POINTER(WfParams), ctypes.POINTER(WfMesh),
                         ctypes.c_int],
         "wf_res_fwd_info": [ctypes.POINTER(WfParams), ctypes.c_int],
         "wf_res_bwd_info": [ctypes.POINTER(WfParams), ctypes.c_int],
         "wf_res_walk_info": [ctypes.c_int, ctypes.c_int],
         "wf_radon_info": [ctypes.POINTER(WfParams),
                           ctypes.POINTER(CullArgs), ctypes.c_int],
         "wf_corner_info": [ctypes.POINTER(WfParams),
                            ctypes.POINTER(CullArgs), ctypes.c_int],
         "wf_tgt_info": [ctypes.POINTER(WfParams), ctypes.POINTER(WfMesh),
                         ctypes.c_int, ctypes.c_int],
         "wf_res_tgt_info": [ctypes.POINTER(WfParams),
                             ctypes.POINTER(WfMesh), ctypes.c_int,
                             ctypes.c_int]}


def _setup(lib, name):
    """Declare the argument types of library `name`'s entry points (and
    of its launch-shape queries, where it has them)."""
    for fn_name in _ENTRIES[name]:
        fn = getattr(lib, fn_name)
        fn.restype = ctypes.c_int
        if fn_name in _INFO:
            fn.argtypes = _INFO[fn_name] + [ctypes.POINTER(ctypes.c_int)]
            continue
        fn.argtypes = _ARGS[fn_name]
        info = getattr(lib, fn_name + "_info", None)
        if info is not None:
            info.argtypes = _INFO[fn_name + "_info"] + [
                ctypes.POINTER(ctypes.c_int)]
            info.restype = ctypes.c_int


_SETUP = {k: (lambda lib, k=k: _setup(lib, k)) for k in LIBS}
# the kernels round every float operation as the plain version's separate
# torch ops do (no FMA contraction): see csrc/wf_trace.cuh
_FLAGS = {k: ["--fmad=false"] for k in LIBS}


def build_kernels():
    """Build (nvcc, one process per source, in parallel) and load the
    wavefront's kernel libraries (LIBS). Returns {name: ctypes lib};
    raises on any failure."""
    from ..native import load_cuda
    return load_cuda(LIBS, _SETUP, _FLAGS)


def _check(name, t, dtype, shape):
    if t.dtype != dtype:
        raise ValueError(f"{name}: expected {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: tensors must be contiguous")


def _ptr(t):
    return None if t is None else t.data_ptr()


def _err(name, err):
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed, cudaError_t {err}")


def _keys(P, keys=COUNTERS):
    """The counters a launch of P reports: keys, without the mesh's when
    the scene has no target."""
    return keys if P.target else tuple(k for k in keys
                                       if k not in MESH_COUNTERS)


def _add(stats, counter, keys=COUNTERS):
    if stats is not None and counter is not None:
        for key, v in zip(COUNTERS, counter.tolist()):
            if key in keys:
                stats[key] = stats.get(key, 0) + v


def _prologue(P, bank):
    """Whether a residual launch of P with the chord bank `bank` runs the
    geometric prologue: a first-scatter mode without a bank."""
    return P.residual in (FIRST_SCATTER, FAST_RESIDUAL) and bank is None


def _counter(stats, dev, prologue=False):
    """The launch's counters (COUNTERS, and PROLOGUE_COUNTER after them
    for the prologue's), or None when nothing counts."""
    if stats is None:
        return None
    return torch.zeros((len(COUNTERS) + int(prologue),), dtype=torch.int64,
                       device=dev)


def _add_prologue(stats, counter):
    """The prologue's iterations of a launch's counters into stats."""
    if stats is not None and counter is not None and \
            counter.shape[0] > len(COUNTERS):
        stats[PROLOGUE_COUNTER] = stats.get(PROLOGUE_COUNTER, 0) + \
            int(counter[len(COUNTERS)])


def _stream(dev):
    return torch.cuda.current_stream(dev).cuda_stream \
        if dev.type == "cuda" else None


def _target_args(name, static, arr, P):
    """What a loop launch takes besides P: the WfMesh of the scene's mesh
    banks, the target's triangle rows (cull_rows; None without a target)
    and the inside mask (arr["inside_mask"], uint8, which a
    two-channel first-scatter residual reads). Returns (M, tris, mask);
    the analog pair takes no mask."""
    M = make_mesh(name, static, arr)
    tris = cull_rows(arr) if P.target else None
    mask = arr.get("inside_mask")
    if P.target == 2 and P.residual in (FIRST_SCATTER, FAST_RESIDUAL):
        X, Y, Z = static.sensor.res
        if mask is None:
            raise ValueError(f"{name}: a two-channel first-scatter residual "
                             "needs the inside mask (arr['inside_mask'])")
        _check(name, mask, torch.uint8, (X * Y * Z,))
    return M, tris, mask


def _family_params(name, static, arr, seed, spp):
    """make_params, checked against the kernel's family: the analog pair
    (and the medium adjoint) runs the full dose, the residual pair a
    residual static (scattering, transmission only) and takes no tile.
    Returns (P, order, starts, rows) for the analog pair, (P, order,
    starts, the chord bank or None) for the residual pair: a
    first-scatter residual without arr["chord_pack"] runs the geometric
    prologue (a null bank selects it in the kernels)."""
    if static.mode != "volume":
        raise ValueError(f"{name} renders the dose; the '{static.mode}' "
                         "mode runs on wf_radon")
    P = make_params(static, arr, seed, spp)
    order, starts, rows, P.tile_n = _launch_layout(static, arr)
    if name in KERNELS + (MED_LIB,):
        if P.residual != ANALOG:
            raise ValueError(f"{name} runs the full dose; a residual "
                             "static (scattered_only) runs on "
                             f"{RES_KERNELS}")
        return P, order, starts, rows
    if P.residual == ANALOG or not (static.has_scattering and
                                    static.transmission_only):
        raise ValueError(f"{name} runs the residual of a scattering, "
                         "transmission-only scene (scattered_only)")
    P.tile_n = 0
    bank = arr.get("chord_pack")
    if P.residual not in (FIRST_SCATTER, FAST_RESIDUAL) or bank is None:
        return P, order, starts, None
    _check(name, bank, torch.float32,
           (static.projector.n_patterns * static.projector.resx, 12))
    return P, order, starts, bank


def _launch(name, static, arr, x, out, seed, spp, stats):
    """One launch of the analog pair's kernel `name`."""
    dev = x.device
    pix = _pixels(name, static, arr, dev)
    P, order, starts, rows = _family_params(name, static, arr, seed, spp)
    M, tris, _ = _target_args(name, static, arr, P)
    counter = _counter(stats, dev)
    with torch.cuda.device(dev):
        fn = getattr(build_kernels()[name], name)
        err = fn(ctypes.byref(P), ctypes.byref(M), _ptr(tris), x.data_ptr(),
                 pix.data_ptr(), _ptr(order), _ptr(starts), _ptr(rows),
                 out.data_ptr(), _ptr(counter), _stream(dev))
    _count(name, P)
    _err(name, err)
    _add(stats, counter, _keys(P))


def _pixels(name, static, arr, dev):
    pix = arr["active_pixels"]
    if pix.device != dev:
        raise ValueError(f"{name}: scene tensors on {pix.device}, input on "
                         f"{dev}")
    _check(name, pix, torch.int32, (static.projector.n_active,))
    return pix


# --------------------------------------------------------------------------
# the residual pair: the chord table, the single pass, the dda forward's
# path and walk passes. `libs` holds the loaded libraries by name (the
# card's build_kernels(), or a host build of the template in the tests)


def _chord_table(bank, st):
    """Plain version of the chord table (csrc/wf_trace.cuh chord_entry):
    (n, 16) float32 entries (m0, m1, M, 0, L0, L1, exp(-st L0),
    exp(-st L1), x0, y0, dx0, dy0, x1, y1, dx1, dy1) of the chord bank
    (n, 12) at sigma_t st, in the kernel's operation order."""
    st = torch.as_tensor(st, dtype=torch.float32, device=bank.device)
    L0, L1 = bank[:, 8], bank[:, 9]
    e0, e1 = torch.exp(-st * L0), torch.exp(-st * L1)
    m0 = bank[:, 10] * (1.0 - e0)
    m1 = bank[:, 11] * e0 * (1.0 - e1)
    z = torch.zeros_like(m0)
    return torch.stack([m0, m1, m0 + m1, z, L0, L1, e0, e1,
                        bank[:, 0], bank[:, 1], bank[:, 4], bank[:, 5],
                        bank[:, 2], bank[:, 3], bank[:, 6], bank[:, 7]], 1)


def _res_chords(libs, arr, bank, P):
    """The chord table of the bank at P.sigma_t, built by wf_res_chords
    once per engine (cached in the scene tensors' dict)."""
    if bank is None:
        return None
    key = (bank.data_ptr(), P.sigma_t)
    cached = arr.get("_wf_res_chords")
    if cached is None or cached[0] != key:
        tab = torch.empty((bank.shape[0], 16), dtype=torch.float32,
                          device=bank.device)
        err = libs["wf_res_fwd"].wf_res_chords(
            bank.data_ptr(), bank.shape[0], P.sigma_t, tab.data_ptr(),
            _stream(bank.device))
        launches["wf_res_chords"] += 1
        _err("wf_res_chords", err)
        cached = (key, tab)
        arr["_wf_res_chords"] = cached
    return cached[1]


def _res_one_pass(libs, name, static, arr, x, out, seed, spp, stats):
    """One launch of wf_res_fwd (ratio, delta) or wf_res_bwd."""
    dev = x.device
    pix = _pixels(name, static, arr, dev)
    P, order, starts, bank = _family_params(name, static, arr, seed, spp)
    M, tris, mask = _target_args(name, static, arr, P)
    tab = _res_chords(libs, arr, bank, P)
    prologue = _prologue(P, bank)
    counter = _counter(stats, dev, prologue)
    err = getattr(libs[name], name)(
        ctypes.byref(P), ctypes.byref(M), _ptr(tris), _ptr(mask),
        x.data_ptr(), pix.data_ptr(), _ptr(order), _ptr(starts), _ptr(bank),
        _ptr(tab), out.data_ptr(), _ptr(counter), _stream(dev))
    _count(name, P, prologue)
    _err(name, err)
    _add(stats, counter, _keys(P))
    _add_prologue(stats, counter)


def _split_buffer(static, arr, P, dev):
    """The record buffer (cap * 8 floats) and its two counters (records
    made, records claimed by the walk), allocated once per engine (cached
    in the scene tensors' dict). cap: SPLIT_MAX_RECORDS, or what a
    launch's lanes could make where that is less. A failed allocation
    raises."""
    lanes = static.projector.n_active * P.spp
    cta_lanes = P.group * P.resx * P.spp
    cap = min(SPLIT_MAX_RECORDS,
              max(2 * lanes, cta_lanes * (2 * P.max_depth + 16)))
    cached = arr.get("_wf_res_split")
    if cached is None or cached[0] < cap or cached[1].device != dev:
        cached = (cap, torch.empty((cap * 8,), dtype=torch.float32,
                                   device=dev),
                  torch.zeros((2,), dtype=torch.int32, device=dev))
        arr["_wf_res_split"] = cached
    return cached


def _lanes_before(static, arr, spp):
    """(CTAs + 1,) int64 numpy: the lanes before each CTA of the launch
    order (cached in the scene tensors' dict)."""
    key = (spp, static.projector.block)
    cached = arr.get("_wf_res_lanes")
    if cached is None or cached[0] != key:
        starts = block_order(static, arr)[1].cpu().numpy().astype(np.int64)
        cached = (key, starts * spp)
        arr["_wf_res_lanes"] = cached
    return cached[1]


def res_tgt_route(libs, static, arr):
    """Whether the dda residual forward's path pass runs this scene
    through the target form of csrc/wf_res_target.cu: a dda residual
    (first-scatter or scattered-only) of a scene that keeps the target
    and transmits only (wf_res_tgt_runs; its banks staged where they fit
    a CTA, else read from global memory). Decided before the launch; any
    other scene runs the one-pass instantiation (wf_res_path)."""
    P = make_params(static, arr, 0, 1)
    if not P.target or static.sensor.estimator != "dda" or \
            P.residual in (ANALOG, FAST_RESIDUAL):
        return False
    runs = ctypes.c_int(0)
    _err("wf_res_tgt_runs", libs[RES_TGT_LIB].wf_res_tgt_runs(
        ctypes.byref(P), ctypes.byref(runs)))
    return bool(runs.value)


def _half_counters(arr, dev):
    """The counters of the record buffer's two halves (the overlapped
    batches of _res_split), (2, 2) int32: records made, records claimed
    by the walk (cached in the scene tensors' dict)."""
    c = arr.get("_wf_res_halves")
    if c is None or c.device != dev:
        c = torch.zeros((2, 2), dtype=torch.int32, device=dev)
        arr["_wf_res_halves"] = c
    return c


def _split_part(static, arr, P, dev, half):
    """(cap, first record, counters) of the record buffer (half None) or
    of its half 0 or 1."""
    cap, _, ctr = _split_buffer(static, arr, P, dev)
    if half is None:
        return cap, 0, ctr
    return cap // 2, half * (cap // 2), _half_counters(arr, dev)[half]


def res_path(libs, static, arr, data, seed, spp, c0, c1, stats=None,
             half=None):
    """The dda residual forward's path pass over CTAs [c0, c1) of the
    launch order (the target form where res_tgt_route takes the scene):
    the segment records it made, (n, 8) float32 (o, d, maxt, base; a
    view of the engine's buffer, or of its half 0 or 1; on a two-channel
    film maxt < 0 for the channel outside the target), or None when they
    overflow it. stats: adds the bounce iterations, the target's mesh
    work, the SLOT_COUNTERS, the records and one batch."""
    dev = data.device
    pix = _pixels("wf_res_fwd", static, arr, dev)
    P, order, starts, bank = _family_params("wf_res_fwd", static, arr, seed,
                                            spp)
    M, tris, mask = _target_args("wf_res_fwd", static, arr, P)
    tab = _res_chords(libs, arr, bank, P)
    recs = _split_buffer(static, arr, P, dev)[1]
    cap, base, ctr = _split_part(static, arr, P, dev, half)
    recs = recs[8 * base:8 * (base + cap)]
    ctr.zero_()
    prologue = _prologue(P, bank)
    counter = _counter(stats, dev, prologue)
    slots = None if stats is None else torch.zeros(
        (len(SLOT_COUNTERS),), dtype=torch.int64, device=dev)
    args = (ctypes.byref(P), ctypes.byref(M), _ptr(tris), _ptr(mask), c0,
            c1, data.data_ptr(), pix.data_ptr(), _ptr(order), _ptr(starts),
            _ptr(bank), _ptr(tab), recs.data_ptr(), ctr.data_ptr(), cap,
            _ptr(counter), _ptr(slots))
    if res_tgt_route(libs, static, arr):
        entry = "wf_res_tgt_path"
        err = libs[RES_TGT_LIB].wf_res_tgt_path(*args, RES_TGT_SMEM_LIMIT,
                                                _stream(dev))
    else:
        entry = "wf_res_path"
        err = libs["wf_res_fwd"].wf_res_path(*args, _stream(dev))
    _count("wf_res_fwd", P, prologue)
    if entry in launches:
        launches[entry] += 1
        if prologue:
            form_launches[f"{entry}:prologue"] += 1
    _err(entry, err)
    n = int(ctr[0].item()) & 0xFFFFFFFF
    if n > cap:
        return None
    _add(stats, counter, _keys(P, ("iterations",) + MESH_COUNTERS))
    _add_prologue(stats, counter)
    if stats is not None:
        for key, v in zip(SLOT_COUNTERS, slots.tolist()):
            stats[key] = stats.get(key, 0) + v
        stats["records"] = stats.get("records", 0) + n
        stats["batches"] = stats.get("batches", 0) + 1
    return recs[:8 * n].view(n, 8)


def res_walk(libs, static, arr, recs, acc, seed=0, spp=1, stats=None,
             half=None):
    """The dda residual forward's walk pass: the segments recs (n, 8)
    walked into acc (n_cells,), one launch for each of WALK_SLABS
    z-slabs, on the current stream (half: the records lie in that half of
    the buffer, whose counter the walk claims them with). stats: adds the
    steps, the deposits, the walk's lane slots and the steps its walking
    threads took ("walk_steps": with those outside a slab)."""
    dev = acc.device
    P = make_params(static, arr, seed, spp)
    n = recs.shape[0]
    _check("wf_res_walk", recs, torch.float32, (n, 8))
    _check("wf_res_walk", acc, torch.float32, (static.sensor.n_cells,))
    ctr = _split_part(static, arr, P, dev, half)[2]
    Z = static.sensor.res[2]
    cuts = [Z * k // WALK_SLABS for k in range(WALK_SLABS + 1)]
    for zlo, zhi in zip(cuts[:-1], cuts[1:]):
        ctr[1].zero_()
        counter = _counter(stats, dev)
        err = libs["wf_res_fwd"].wf_res_walk(
            ctypes.byref(P), recs.data_ptr(), n, ctr[1:].data_ptr(), zlo, zhi,
            acc.data_ptr(), _ptr(counter), _stream(dev))
        _count("wf_res_walk", P)
        _err("wf_res_walk", err)
        _add(stats, counter, COUNTERS[1:5])
        if counter is not None:
            stats["walk_steps"] = stats.get("walk_steps", 0) + \
                int(counter[0])


def _walk(static, arr, recs, stats=None, keys=None, seed=0):
    """Plain version of the walk pass: the accumulator (n_cells,) of
    march.dda_segment on the records (o, d, maxt, base), with albedo 0
    and em 1 so that its deposit weight is the record's base exactly; on
    a two-channel film a record's channel is the sign of its maxt. keys
    (n, 2) int64 (a ratio static's records): each record's lane and
    counter, from which march.ratio_segment draws its tracking (the
    stream of seed). stats: adds the steps."""
    dev = recs.device
    n = recs.shape[0]
    acc = torch.zeros((static.sensor.n_cells,), dtype=torch.float32,
                      device=dev)
    at = dict(arr, albedo=torch.zeros_like(arr["albedo"]))
    zero = torch.zeros((n,), dtype=torch.float32, device=dev)
    maxt, inside = recs[:, 6], None
    if static.sensor.channels == 2:
        maxt, inside = maxt.abs(), maxt > 0.0
    args = (static, at, True, acc, None, None, recs[:, 0:3], recs[:, 3:6],
            zero, maxt, recs[:, 7], torch.ones_like(zero),
            torch.ones((n,), dtype=torch.bool, device=dev))
    if keys is None:
        acc, _ = dda_segment(*args, stats, inside)
    else:
        acc, _, _ = ratio_segment(*args, Sampler(seed), keys[:, 0],
                                  keys[:, 1], stats, inside)
    return acc


def _timed(times, key, fn):
    """fn(), its card time added to times[key] (CUDA events) when times
    is given."""
    if times is None:
        return fn()
    a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    a.record()
    out = fn()
    b.record()
    b.synchronize()
    times[key] = times.get(key, 0.0) + a.elapsed_time(b)
    return out


def _res_split(libs, static, arr, data, acc, seed, spp, stats,
               batch_ctas=None, times=None):
    """The dda residual forward in two passes, CTA batch by CTA batch:
    each batch's path pass and then the walk of its records. A batch is
    as many CTAs as fit the buffer at the records a lane has made so far
    (at most batch_ctas); one whose records overflow runs again in a
    smaller part. On the card, for the target form's path pass
    (res_tgt_route), the batches take the buffer's halves in turn, each
    batch's walk on a second stream beside the next batch's path pass
    (not when the passes are timed or counted: those read the card). The
    other path passes run their batches one after another: beside the
    persistent walk the one-pass target path pass took 1.8x its time; the
    mesh-free one gained 4 % and is left as it ran (PERF.md section 6).
    times: adds the passes' milliseconds ("path_ms", "walk_ms")."""
    dev = data.device
    P = make_params(static, arr, seed, spp)
    overlap = dev.type == "cuda" and times is None and stats is None and \
        res_tgt_route(libs, static, arr)
    cap = _split_buffer(static, arr, P, dev)[0] // (2 if overlap else 1)
    main = torch.cuda.current_stream(dev) if overlap else None
    side = torch.cuda.Stream(dev) if overlap else None
    # the event after each half's last walk
    walked = [None, None]
    before = _lanes_before(static, arr, spp)
    n_ctas = len(before) - 1
    per_lane, c0, c_max, k = SPLIT_GUESS, 0, n_ctas, 0
    while c0 < n_ctas:
        want = before[c0] + cap / (per_lane * SPLIT_MARGIN)
        c1 = int(np.searchsorted(before, want, side="right")) - 1
        c1 = max(c0 + 1, min(c1, c_max,
                             c0 + (batch_ctas or n_ctas)))
        half = k % 2 if overlap else None
        if overlap and walked[half] is not None:
            main.wait_event(walked[half])
        recs = _timed(times, "path_ms", lambda: res_path(
            libs, static, arr, data, seed, spp, c0, c1, stats, half))
        lanes = int(before[c1] - before[c0])
        if recs is None:
            if c1 - c0 == 1:
                raise RuntimeError(
                    f"wf_res_fwd: one CTA's segments overflow the {cap} "
                    "records of the buffer")
            c_max = c0 + (c1 - c0) // 2
            continue
        if recs.shape[0] and overlap:
            side.wait_stream(main)
            with torch.cuda.stream(side):
                res_walk(libs, static, arr, recs, acc, seed, spp, None, half)
            walked[half] = torch.cuda.Event()
            walked[half].record(side)
        elif recs.shape[0]:
            _timed(times, "walk_ms", lambda: res_walk(
                libs, static, arr, recs, acc, seed, spp, stats))
        if lanes and recs.shape[0]:
            per_lane = recs.shape[0] / lanes
        c0, c_max, k = c1, n_ctas, k + 1
    if overlap:
        main.wait_stream(side)


# --------------------------------------------------------------------------
# the analog pair's target forms (csrc/wf_target.cu): the staged adjoint,
# the dda forward's path and walk passes. `libs` as for the residual pair


def tgt_route(libs, name, static, arr):
    """Whether kernel `name` ("wf_fwd" or "wf_bwd") runs this scene through
    the target forms of csrc/wf_target.cu: the scene has mesh surfaces
    (target_mode) and its mesh banks fit a CTA's shared memory
    (wf_tgt_fits), for every estimator (the forward: the dda's and the
    ratio's path and walk passes, the delta form); a scene whose banks do
    not fit keeps wf_fwd's and wf_bwd's one-pass kernels."""
    P = make_params(static, arr, 0, 1)
    if not P.target or P.residual != ANALOG:
        return False
    M = make_mesh(name, static, arr)
    fits = ctypes.c_int(0)
    _err("wf_tgt_fits", libs[TGT_LIB].wf_tgt_fits(
        ctypes.byref(P), ctypes.byref(M), ctypes.byref(fits)))
    return bool(fits.value)


def tgt_adjoint(libs, static, arr, dL_flat, seed, spp, stats=None):
    """The analog adjoint's target form (wf_tgt_bwd: the banks staged in
    each CTA's shared memory): the pattern gradient (n_active,)."""
    dev = dL_flat.device
    pix = _pixels("wf_bwd", static, arr, dev)
    P, order, starts, _ = _family_params("wf_bwd", static, arr, seed, spp)
    M, tris, _ = _target_args("wf_bwd", static, arr, P)
    out = _grad_out(static, dev)
    counter = _counter(stats, dev)
    err = libs[TGT_LIB].wf_tgt_bwd(
        ctypes.byref(P), ctypes.byref(M), _ptr(tris), dL_flat.data_ptr(),
        pix.data_ptr(), _ptr(order), _ptr(starts), out.data_ptr(),
        _ptr(counter), _stream(dev))
    _count("wf_bwd", P)
    _err("wf_tgt_bwd", err)
    _add(stats, counter)
    return out


def tgt_units(static, arr, spp):
    """The target forms' split forward's units: each launch-order CTA with
    lanes (block_order) cut into equal ranges of its tasks (csrc/
    wf_trace.cuh task_count: spp tasks for each 32 positions) of at most
    TGT_UNIT_LANES lanes. Returns ((n_units, 3) int32 (CTA, first task,
    task end) on the scene tensors' device, (n_units,) int64 numpy lanes);
    cached in the scene tensors' dict."""
    before = _lanes_before(static, arr, spp)
    key = (spp, len(before), int(before[-1]), static.projector.block)
    cached = arr.get("_wf_tgt_units")
    if cached is None or cached[0] != key:
        n = np.diff(before) // spp
        c = np.nonzero(n)[0]  # CTAs with lanes (a block's, a sparse
        n = n[c]              # store's may have none)
        n_tasks = spp * ((n + 31) // 32)
        parts = -(-n * spp // TGT_UNIT_LANES)
        # unit i of its CTA's parts: tasks [n_tasks i // parts,
        # n_tasks (i + 1) // parts)
        k = np.repeat(np.arange(c.size), parts)
        i = np.arange(k.size) - np.repeat(np.cumsum(parts) - parts, parts)
        t0 = n_tasks[k] * i // parts[k]
        t1 = n_tasks[k] * (i + 1) // parts[k]

        def lanes_before(t):
            # task t traces lane t % spp of 32 pixels, the last group r
            full, r = spp * (n[k] // 32), n[k] % 32
            return 32 * np.minimum(t, full) + r * np.maximum(t - full, 0)
        dev = arr["active_pixels"].device
        units = np.stack([c[k], t0, t1], 1).astype(np.int32)
        cached = (key, torch.from_numpy(units).to(dev),
                  (lanes_before(t1) - lanes_before(t0)).astype(np.int64))
        arr["_wf_tgt_units"] = cached
    return cached[1], cached[2]


def _tgt_estimate(arr, P, lanes, block):
    """The records a lane of each unit made in the last launch on these
    units (TGT_GUESS before the first), float32 on the scene tensors'
    device, and the units' lanes there (cached in the scene tensors'
    dict; the wrapper updates the estimate in place)."""
    key = (P.spp, P.target, P.estimator, P.n_active, lanes.shape[0], block)
    cached = arr.get("_wf_tgt_est")
    if cached is None or cached[0] != key:
        dev = arr["active_pixels"].device
        cached = (key, torch.full((lanes.shape[0],), TGT_GUESS,
                                  dtype=torch.float32, device=dev),
                  torch.from_numpy(lanes.astype(np.float32)).to(dev))
        arr["_wf_tgt_est"] = cached
    return cached[1], cached[2]


def tgt_delta(libs, static, arr, data, seed, spp, stats=None, times=None):
    """The delta forward's target form (csrc/wf_target.cuh
    tgt_delta_kernel): one launch over every unit (tgt_units), the banks
    staged, each deposit a global atomic. Returns the accumulator
    (n_cells,). stats: adds the COUNTERS; times: adds its milliseconds
    ("delta_ms")."""
    dev = data.device
    pix = _pixels("wf_fwd", static, arr, dev)
    P, order, starts, _ = _family_params("wf_fwd", static, arr, seed, spp)
    M, tris, _ = _target_args("wf_fwd", static, arr, P)
    acc = torch.zeros((static.sensor.n_cells,), dtype=torch.float32,
                      device=dev)
    units, lanes = tgt_units(static, arr, spp)
    A = TgtArgs(None, None, None, units.data_ptr(), acc.data_ptr(), 0,
                lanes.shape[0])
    counter = _counter(stats, dev)
    err = _timed(times, "delta_ms", lambda: libs[TGT_LIB].wf_tgt_delta(
        ctypes.byref(P), ctypes.byref(M), _ptr(tris), data.data_ptr(),
        pix.data_ptr(), _ptr(order), _ptr(starts), ctypes.byref(A),
        _ptr(counter), _stream(dev)))
    _count("wf_fwd", P)
    _count("wf_tgt_delta", P)
    _err("wf_tgt_delta", err)
    _add(stats, counter, _keys(P))
    return acc


def tgt_forward(libs, static, arr, data, seed, spp, stats=None, times=None):
    """The forward's target form (csrc/wf_target.cuh). The delta
    estimator's is one pass (tgt_delta); the dda's and the ratio's run in
    two passes, batch by batch of units (tgt_units): each batch's path
    pass records the lanes' in-medium segments into its units' regions of
    a record buffer (a ratio record's lane and stream counter beside it;
    a segment past its region walked or tracked at once), then its walk
    pass walks each unit's records through its DMD row's home-slice tile
    (a ratio record's tracking replayed from its stream). A batch is as
    many units as their regions fit half the buffer; the halves take
    turns, and on the card (TGT_OVERLAP) a batch's walk pass runs on a
    second stream beside the next batch's path pass. A region is sized
    from the records the unit made in the last launch. Returns the
    accumulator (n_cells,). stats: adds the COUNTERS (lane slots: the
    walk's), the records, those walked at once and the batches; times:
    adds the passes' milliseconds ("path_ms", "walk_ms")."""
    if static.sensor.estimator == "delta":
        return tgt_delta(libs, static, arr, data, seed, spp, stats, times)
    dev = data.device
    pix = _pixels("wf_fwd", static, arr, dev)
    P, order, starts, rows = _family_params("wf_fwd", static, arr, seed, spp)
    M, tris, _ = _target_args("wf_fwd", static, arr, P)
    acc = torch.zeros((static.sensor.n_cells,), dtype=torch.float32,
                      device=dev)
    units, lanes = tgt_units(static, arr, spp)
    n_units = lanes.shape[0]
    est, lanes_t = _tgt_estimate(arr, P, lanes, static.projector.block)
    cum = (torch.ceil(lanes_t * est * TGT_MARGIN).to(torch.int64)
           + TGT_SLACK).cumsum(0)
    cum_h = cum.cpu().numpy()
    space = int(min(TGT_MAX_RECORDS // 2, max(cum_h[-1], 1))) if n_units \
        else 0
    recs = torch.empty((2 * space * 8,), dtype=torch.float32, device=dev)
    # a ratio record's (lane, counter), two uint32
    keys = torch.empty((2 * space * 2,), dtype=torch.int32, device=dev) \
        if static.sensor.estimator == "ratio" else None
    # the walk passes' stream, and the event after each half's last walk
    # (not when the passes are timed or counted: those read the card)
    overlap = TGT_OVERLAP and dev.type == "cuda" and times is None and \
        stats is None
    main = torch.cuda.current_stream(dev) if overlap else None
    side = torch.cuda.Stream(dev) if overlap else None
    walked = [None, None]
    u0, k = 0, 0
    while u0 < n_units:
        base = int(cum_h[u0 - 1]) if u0 else 0
        u1 = max(u0 + 1, int(np.searchsorted(cum_h, base + space,
                                             side="right")))
        nb = u1 - u0
        region = torch.cat([torch.zeros((1,), dtype=torch.int64, device=dev),
                            cum[u0:u1] - base]).clamp(max=space)
        region = region.to(torch.int32)
        cnt = torch.zeros((nb,), dtype=torch.int32, device=dev)
        half = k % 2
        A = TgtArgs(recs.data_ptr() + 32 * space * half, region.data_ptr(),
                    cnt.data_ptr(), units.data_ptr(), acc.data_ptr(), u0, u1,
                    None if keys is None else keys.data_ptr()
                    + 8 * space * half)
        if overlap and walked[half] is not None:
            main.wait_event(walked[half])
        counter = _counter(stats, dev)
        err = _timed(times, "path_ms", lambda: libs[TGT_LIB].wf_tgt_path(
            ctypes.byref(P), ctypes.byref(M), _ptr(tris), data.data_ptr(),
            pix.data_ptr(), _ptr(order), _ptr(starts), ctypes.byref(A),
            _ptr(counter), _stream(dev)))
        _count("wf_fwd", P)
        _err("wf_tgt_path", err)
        _add(stats, counter, ("iterations", "steps", "global_deposits")
             + MESH_COUNTERS)
        counter = _counter(stats, dev)
        stream = _stream(dev)
        if overlap:
            side.wait_stream(main)
            stream = side.cuda_stream
            region.record_stream(side)
            cnt.record_stream(side)
        err = _timed(times, "walk_ms", lambda: libs[TGT_LIB].wf_tgt_walk(
            ctypes.byref(P), ctypes.byref(A), _ptr(rows), _ptr(counter),
            stream))
        _count("wf_tgt_walk", P)
        _err("wf_tgt_walk", err)
        if overlap:
            walked[half] = torch.cuda.Event()
            walked[half].record(side)
        _add(stats, counter, COUNTERS[1:5])
        lb = lanes_t[u0:u1]
        est[u0:u1] = torch.where(lb > 0, cnt.to(torch.float32) /
                                 lb.clamp(min=1.0), est[u0:u1])
        if stats is not None:
            made = cnt.to(torch.int64)
            cap = (region[1:] - region[:-1]).to(torch.int64)
            stats["records"] = stats.get("records", 0) + int(made.sum())
            stats["records_walked_at_once"] = stats.get(
                "records_walked_at_once", 0) + int(
                    (made - cap).clamp(min=0).sum())
            stats["batches"] = stats.get("batches", 0) + 1
        u0, k = u1, k + 1
    if overlap:
        main.wait_stream(side)
    return acc


def kernel_info(name, static: MarchStatic, arr, count=False):
    """The launch shape of the kernel instantiation `name` runs on this
    scene (count: the counting one, as with `stats`), read from the
    card: threads a CTA, CTAs, shared memory, registers, local (stack
    and spill) bytes, CTAs an SM holds, and the tile's voxels. `name`
    "wf_res_walk": the dda residual forward's walk pass; "wf_res_fwd"
    of a dda static: its path pass. A static that keeps the target
    (target_mode) reads its target instantiation's shape: the mesh on,
    and with two channels where the film has them; on the target forms'
    route (tgt_route) "wf_fwd" the path pass, "wf_tgt_walk" the walk
    pass and "wf_bwd" the staged adjoint (a delta static's "wf_fwd": the
    delta form); on the residual's
    (res_tgt_route) "wf_res_fwd" its target path pass; on the medium
    adjoint's (med_route) "wf_med" its staged instantiation."""
    fam = {"wf_res_walk": "wf_res_fwd", "wf_tgt_walk": "wf_fwd"}.get(name,
                                                                     name)
    P, _, _, bank = _family_params(fam, static, arr, 0, 1)
    # the residual's queries: bit 0 the counting instantiation, bit 1 the
    # prologue's
    flags = int(count) | (2 if fam in RES_KERNELS and _prologue(P, bank)
                          else 0)
    out = (ctypes.c_int * 8)()
    with torch.cuda.device(arr["active_pixels"].device):
        libs = build_kernels()
        lib = libs[fam]
        if name == "wf_tgt_walk" or (name in KERNELS and tgt_route(
                libs, name, static, arr)):
            M = make_mesh(name, static, arr)
            delta = static.sensor.estimator == "delta"
            err = libs[TGT_LIB].wf_tgt_info(
                ctypes.byref(P), ctypes.byref(M),
                {"wf_fwd": 3 if delta else 0, "wf_tgt_walk": 1,
                 "wf_bwd": 2}[name], int(count), out)
        elif name == "wf_res_fwd" and res_tgt_route(libs, static, arr):
            err = libs[RES_TGT_LIB].wf_res_tgt_info(
                ctypes.byref(P), ctypes.byref(make_mesh(name, static, arr)),
                flags, RES_TGT_SMEM_LIMIT, out)
        elif name == "wf_res_walk":
            err = lib.wf_res_walk_info(int(count), int(P.target == 2), out)
        elif name == MED_LIB:
            err = lib.wf_med_info(ctypes.byref(P), ctypes.byref(make_mesh(
                name, static, arr)), int(med_route(libs, static, arr)), out)
        else:
            err = getattr(lib, name + "_info")(
                ctypes.byref(P), flags if name in RES_KERNELS else int(count),
                out)
    if err != 0:
        raise RuntimeError(f"{name}: occupancy query failed, cudaError_t "
                           f"{err}")
    keys = ("threads", "ctas", "dynamic_smem_bytes", "static_smem_bytes",
            "registers", "local_bytes", "ctas_per_sm", "tile_voxels")
    return dict(zip(keys, list(out)), angles_per_cta=P.group)


def wf_fwd(static: MarchStatic, arr, data, seed, spp, stats=None,
           times=None):
    """CUDA kernel csrc/wf_fwd.cu: the dose accumulator (n_cells,) of
    `data` (n_active,) float32 on the card. Replaces the primal of
    drtvam_tpu/ops/march.py:913 trace_wavefront (XLA). What bounds it
    on the H100: the float32 work of the voxel steps (~20 operations a
    step, two of them expf); the deposits of a CTA's DMD row in its
    home z-slice are atomic adds in shared memory, the rest go past the
    50 MB L2 into the 67 MB dose grid of a 256^3 film. A scene with mesh
    surfaces whose banks fit a CTA runs csrc/wf_target.cu's forms
    (tgt_forward: the dda and ratio forwards' path and walk passes, the
    delta forward's one pass; times: adds their milliseconds). stats:
    adds the COUNTERS."""
    _n_lanes(static, spp)
    _check("wf_fwd", data, torch.float32, (static.projector.n_active,))
    libs = _card_libs(data)
    if tgt_route(libs, "wf_fwd", static, arr):
        return tgt_forward(libs, static, arr, data, seed, spp, stats, times)
    acc = torch.zeros((static.sensor.n_cells,), dtype=torch.float32,
                      device=data.device)
    _launch("wf_fwd", static, arr, data, acc, seed, spp, stats)
    return acc


def wf_bwd(static: MarchStatic, arr, dL_flat, seed, spp, stats=None):
    """CUDA kernel csrc/wf_bwd.cu: the pattern gradient (n_active,) of
    dL_flat (n_cells,) float32 on the card, replaying the forward's
    paths. Replaces the adjoint of drtvam_tpu/ops/march.py:913 (XLA).
    Bound as wf_fwd, with gathers of dL in place of the atomics (a CTA's
    DMD row reads mostly one z-slice, so they mostly hit L1); every
    output is written once, so the result is bitwise reproducible. A
    scene with mesh surfaces runs csrc/wf_target.cu's staged adjoint
    (tgt_adjoint)."""
    _n_lanes(static, spp)
    _check("wf_bwd", dL_flat, torch.float32, (static.sensor.n_cells,))
    libs = _card_libs(dL_flat)
    if tgt_route(libs, "wf_bwd", static, arr):
        return tgt_adjoint(libs, static, arr, dL_flat, seed, spp, stats)
    out = _grad_out(static, dL_flat.device)
    _launch("wf_bwd", static, arr, dL_flat, out, seed, spp, stats)
    return out


def med_tasks(static: MarchStatic, arr):
    """(CTAs + 1,) int32 on the scene tensors' device: the adjoint's warp
    tasks (32 positions each) before each CTA of the launch order, the
    last entry their count (cached in the scene tensors' dict): the
    medium adjoint's task slots. Its tasks (32 emitting pixels each) take
    the first slots of their CTA's region."""
    p = static.projector
    key = (p.n_patterns, p.resx, p.resy, p.n_active, p.identity, p.block)
    cached = arr.get("_wf_med_tasks")
    if cached is None or cached[0] != key:
        starts = block_order(static, arr)[1]
        tasks = (starts[1:] - starts[:-1] + 31) // 32
        base = torch.cat([torch.zeros((1,), dtype=torch.int64,
                                      device=starts.device),
                          tasks.cumsum(0)])
        cached = (key, base.to(torch.int32).contiguous(), int(base[-1]))
        arr["_wf_med_tasks"] = cached
    return cached[1], cached[2]


def med_route(libs, static, arr):
    """Whether the medium adjoint (wf_med) runs this scene staged: the
    scene has mesh surfaces (target_mode) and its banks fit a CTA's
    shared memory beside the staged instantiation (wf_med_fits), as
    tgt_route routes wf_bwd to wf_tgt_bwd."""
    P = make_params(static, arr, 0, 1)
    if not P.target or P.residual != ANALOG:
        return False
    M = make_mesh(MED_LIB, static, arr)
    fits = ctypes.c_int(0)
    _err(f"{MED_LIB} fits", libs[MED_LIB].wf_med_fits(
        ctypes.byref(P), ctypes.byref(M), ctypes.byref(fits)))
    return bool(fits.value)


def med_adjoint(libs, static, arr, dL_flat, data, seed, spp,
                partials=False):
    """The medium adjoint through the libraries `libs` (wf_med), staged
    where med_route takes the scene: (stg, ssg); partials: also the
    (n_tasks, 2) task slots the sums are the fixed-order sum of and the
    emitting pixels per CTA of the launch order."""
    _n_lanes(static, spp)
    if not static.medium_grads:
        raise ValueError("wf_med: the static has no medium_grads")
    n = static.projector.n_active
    _check(MED_LIB, dL_flat, torch.float32, (static.sensor.n_cells,))
    _check(MED_LIB, data, torch.float32, (n,))
    dev = dL_flat.device
    pix = _pixels(MED_LIB, static, arr, dev)
    P, order, starts, _ = _family_params(MED_LIB, static, arr, seed, spp)
    M, tris, _ = _target_args(MED_LIB, static, arr, P)
    staged = med_route(libs, static, arr)
    base, n_tasks = med_tasks(static, arr)
    cidx = torch.empty((n,), dtype=torch.int32, device=dev)
    count = torch.empty((base.numel() - 1,), dtype=torch.int32, device=dev)
    part = torch.empty((max(n_tasks, 1), 2), dtype=torch.float32, device=dev)
    sums = torch.zeros((2,), dtype=torch.float32, device=dev)
    err = libs[MED_LIB].wf_med(
        ctypes.byref(P), ctypes.byref(M), _ptr(tris), dL_flat.data_ptr(),
        data.data_ptr(), pix.data_ptr(), _ptr(order), _ptr(starts),
        base.data_ptr(), cidx.data_ptr(), count.data_ptr(), part.data_ptr(),
        n_tasks, sums.data_ptr(), int(staged), _stream(dev))
    _count(MED_LIB, P)
    if staged:
        form_launches[f"{MED_LIB}:staged"] += 1
    _err(MED_LIB, err)
    res = (sums[0], sums[1])
    return res + (part, count) if partials else res


def wf_med(static: MarchStatic, arr, dL_flat, data, seed, spp,
           partials=False):
    """CUDA kernel csrc/wf_med.cu: the medium cotangents of a medium_grads
    static's adjoint, on the card. Returns (stg, ssg), float32 0-d
    tensors: the summed d loss / d sigma_t and d loss / d sigma_s of every
    deposit, at data's emitted intensities; it traces only the pixels
    that emit and forms no pattern gradient (adjoint takes that from
    wf_bwd). partials: also the task slots the sums are the fixed-order
    sum of and the emitting pixels per CTA. Replaces the
    medium-gradient branches of drtvam_tpu/ops/march.py:586, :747 and
    :865 (XLA). A scene with mesh surfaces runs the staged form where the
    banks fit a CTA (med_route), else the one-pass target form; two
    launches give the same bits. Bound: the emitting pixels' voxel steps
    at wf_bwd's work a step, plus the partials' float32 work."""
    return med_adjoint(_card_libs(dL_flat), static, arr, dL_flat, data, seed,
                       spp, partials)


def res_forward(libs, static, arr, data, seed, spp, stats=None,
                batch_ctas=None, times=None):
    """The residual forward through the libraries `libs`: the dda in two
    passes (_res_split), the other estimators in one."""
    acc = torch.zeros((static.sensor.n_cells,), dtype=torch.float32,
                      device=data.device)
    if static.sensor.estimator == "dda":
        _res_split(libs, static, arr, data, acc, seed, spp, stats,
                   batch_ctas, times)
    else:
        _res_one_pass(libs, "wf_res_fwd", static, arr, data, acc, seed, spp,
                      stats)
    return acc


def res_adjoint(libs, static, arr, dL_flat, seed, spp, stats=None):
    """The residual adjoint through the libraries `libs`, in one pass."""
    out = _grad_out(static, dL_flat.device)
    _res_one_pass(libs, "wf_res_bwd", static, arr, dL_flat, out, seed, spp,
                  stats)
    return out


def _card_libs(x):
    with torch.cuda.device(x.device):
        return build_kernels()


def wf_res_fwd(static: MarchStatic, arr, data, seed, spp, stats=None,
               batch_ctas=None, times=None):
    """CUDA kernels csrc/wf_res_fwd.cu: the residual dose accumulator
    (n_cells,) of `data` on the card, for a static with scattered_only
    (the hybrid engine's residual; the first-scatter modes read
    arr["chord_pack"], or without it march each lane to its chord: the
    geometric prologue). Replaces the primal of
    drtvam_tpu/ops/march.py:913 in its residual modes (XLA: the prologue
    :198-325 too). The dda
    runs a path pass and a walk pass per batch of CTAs (batch_ctas: at
    most that many a batch; with the target kept the path pass is
    csrc/wf_res_target.cu's where res_tgt_route takes the scene), the
    other estimators one pass. What bounds it on the H100: the delta fast
    loop by the per-lane work (ray set-up, random draws, the first
    scatter, one or two events); the dda by its voxel steps and their
    float atomics, and with the target kept by the path pass's grid walks
    and triangle tests. stats: adds the COUNTERS (the dda: lane slots are
    the walk's), the prologue's iterations (PROLOGUE_COUNTER) and, for the
    dda, the SLOT_COUNTERS, the records and batches; times: adds the dda's
    path and walk milliseconds."""
    _n_lanes(static, spp)
    _check("wf_res_fwd", data, torch.float32, (static.projector.n_active,))
    return res_forward(_card_libs(data), static, arr, data, seed, spp, stats,
                       batch_ctas, times)


def wf_res_bwd(static: MarchStatic, arr, dL_flat, seed, spp, stats=None):
    """CUDA kernel csrc/wf_res_bwd.cu: the residual's pattern gradient
    (n_active,) of dL_flat on the card, replaying wf_res_fwd's paths.
    Replaces the adjoint of drtvam_tpu/ops/march.py:913 in its residual
    modes (XLA). Bound as wf_res_fwd's single pass; every output is
    written once, so the result is bitwise reproducible."""
    _n_lanes(static, spp)
    _check("wf_res_bwd", dL_flat, torch.float32, (static.sensor.n_cells,))
    return res_adjoint(_card_libs(dL_flat), static, arr, dL_flat, seed, spp,
                       stats)


def _route(x):
    if x.device.type == "cpu":
        return False
    if x.device.type == "cuda":
        return True
    raise ValueError(f"unsupported device {x.device}")


def forward(static: MarchStatic, arr, data, seed, spp, chunk=DEFAULT_CHUNK):
    """Flat unnormalized dose (n_cells,): wf_fwd (a residual static:
    wf_res_fwd) on the card, the plain version on the CPU."""
    if _route(data):
        kern = wf_res_fwd if static.scattered_only else wf_fwd
        return kern(static, arr, data.contiguous(), seed, spp)
    return _forward(static, arr, data, seed, spp, chunk)


def adjoint(static: MarchStatic, arr, seed, spp, chunk, dL_flat, data=None,
            pattern_grad=True):
    """Pattern gradient (n_active,) of dL_flat: wf_bwd (a residual
    static: wf_res_bwd) on the card, the plain version on the CPU. data
    (a medium_grads static): the patterns; returns (pattern gradient,
    stg, ssg) with the medium cotangents, on the card wf_med's and the
    pattern gradient wf_bwd's; pattern_grad False: (None, stg, ssg)."""
    if data is not None:
        if _route(dL_flat):
            stg, ssg = wf_med(static, arr, dL_flat.contiguous(),
                              data.detach().contiguous(), seed, spp)
            pg = adjoint(static, arr, seed, spp, chunk, dL_flat) \
                if pattern_grad else None
            return pg, stg, ssg
        pg, stg, ssg = _adjoint(static, arr, seed, spp, chunk, dL_flat,
                                data=data.detach())
        return (pg if pattern_grad else None), stg, ssg
    if _route(dL_flat):
        kern = wf_res_bwd if static.scattered_only else wf_bwd
        return kern(static, arr, dL_flat.contiguous(), seed, spp)
    return _adjoint(static, arr, seed, spp, chunk, dL_flat)


class RenderRaw(torch.autograd.Function):
    """Flat dose accumulator, differentiable in the patterns and, for a
    static with medium_grads, in the medium's sigma_t and albedo (inputs
    that hold the scene tensors' values): the backward replays the
    paths with the same seed and spp_grad lanes per pixel, and where
    sigma_t or albedo needs a gradient takes the medium cotangents (stg,
    ssg: d / d sigma_t and d / d sigma_s), chained to the (sigma_t,
    albedo) parameters as drtvam_tpu/ops/render.py:148-166:
    d / d sigma_t = stg + albedo ssg, d / d albedo = sigma_t ssg (on the
    card wf_med); with the patterns not differentiated (optimize_medium's
    case) it forms no pattern gradient."""

    @staticmethod
    def forward(ctx, data, st, al, static, arr, seed, spp, spp_grad, chunk):
        ctx.args = (static, arr, seed, spp_grad, chunk)
        ctx.save_for_backward(data, st, al)
        return forward(static, arr, data, seed, spp, chunk)

    @staticmethod
    def backward(ctx, ct):
        static, arr, seed, spp_grad, chunk = ctx.args
        data, st, al = ctx.saved_tensors
        d_st = d_al = None
        if ctx.needs_input_grad[1] or ctx.needs_input_grad[2]:
            pg, stg, ssg = adjoint(static, arr, seed, spp_grad, chunk,
                                   ct.contiguous(), data=data,
                                   pattern_grad=ctx.needs_input_grad[0])
            d_st = (stg + al.detach() * ssg).reshape(st.shape)
            d_al = (st.detach() * ssg).reshape(al.shape)
        else:
            pg = adjoint(static, arr, seed, spp_grad, chunk, ct.contiguous())
        return pg, d_st, d_al, None, None, None, None, None, None


def render(static: MarchStatic, arr, data, inv_vol, seed=0, spp=1,
           spp_grad=None, chunk=None, medium=None):
    """Dose volume (Z, Y, X, C): the raw accumulator x 1 / voxel
    volume, differentiable in `data` through RenderRaw, and with
    static.medium_grads in medium, a (sigma_t, albedo) pair of tensors
    that hold arr's values (the JAX package's jax.grad of the render in
    (sigma_t, albedo), drtvam_tpu/opt/optimize.py:453-468)."""
    st, al = medium if static.medium_grads and medium is not None \
        else (None, None)
    raw = RenderRaw.apply(data, st, al, static, arr, seed, spp,
                          spp if spp_grad is None else spp_grad,
                          DEFAULT_CHUNK if chunk is None else chunk)
    return raw.reshape(static.sensor.shape) * inv_vol


# --------------------------------------------------------------------------
# the DMD-pixel culling renders


def _dense_image(static: MarchStatic, arr, vals):
    """The dense (n_patterns * resy * resx,) image with the active pixels'
    values vals (n_active,) and 0 elsewhere."""
    p = static.projector
    img = torch.zeros((p.n_patterns * p.resy * p.resx,), dtype=torch.float32,
                      device=vals.device)
    if p.identity:
        return vals
    img[arr["active_pixels"].to(torch.int64)] = vals
    return img


def _radon(static: MarchStatic, arr, seed, spp, chunk, stats=None):
    """Plain version of render_radon: trace_wavefront in its radon mode,
    chunk by chunk; each pixel's lanes summed in lane order, times the
    ray weight. stats: adds the bounce iterations."""
    p = static.projector
    n_lanes = _n_lanes(static, spp)
    chunk, n_chunks = _chunking(n_lanes, chunk, spp)
    dev = arr["active_pixels"].device
    vals = torch.zeros((p.n_active,), dtype=torch.float32, device=dev)
    for i in range(n_chunks):
        lo, hi = i * chunk, min((i + 1) * chunk, n_lanes)
        lane = torch.arange(lo, hi, dtype=torch.int64, device=dev)
        L, _ = trace_wavefront(static, arr, lane, seed, spp, stats=stats)
        L = L.reshape(-1, spp)
        s = L[:, 0]
        for k in range(1, spp):
            s = s + L[:, k]
        vals[lo // spp:hi // spp] = s
    w = ray_weight(p, arr, spp, arr["print_time"])
    return _dense_image(static, arr, vals * w)


def _corner(static: MarchStatic, arr, dist, radius, seed, chunk):
    """Plain version of render_corner: each active pixel's ray from its
    centre (spp 1, no time sampling) and one intersect_scene; the pixel
    keeps the ray weight unless the hit is missing or lies within radius
    of the corner (|x|, |y|) = (dist, dist)."""
    p = static.projector
    dev = arr["active_pixels"].device
    chunk, n_chunks = _chunking(p.n_active, chunk)
    w = ray_weight(p, arr, 1, arr["print_time"])
    vals = torch.zeros((p.n_active,), dtype=torch.float32, device=dev)
    sampler = Sampler(seed)
    for i in range(n_chunks):
        lo, hi = i * chunk, min((i + 1) * chunk, p.n_active)
        lane = torch.arange(lo, hi, dtype=torch.int64, device=dev)
        ctr = sampler.init(hi - lo, dev)
        o, d, _, _ = sample_rays(p, arr, arr["active_pixels"], lane, 1,
                                 sampler, ctr, True, False, static.clockwise)
        t, _, _, hit = intersect_scene(
            static, arr, o, d, torch.ones((hi - lo,), dtype=torch.bool,
                                          device=dev))
        pos = o + t[:, None] * d
        ax = torch.abs(pos[:, 0]) - dist
        ay = torch.abs(pos[:, 1]) - dist
        keep = hit & (torch.sqrt(ax * ax + ay * ay) >= radius)
        vals[lo:hi] = torch.where(keep, w, torch.zeros_like(ax))
    return _dense_image(static, arr, vals)


def _cull_args(name, static, arr, dist=0.0, radius=0.0, staged=True,
               stats=None):
    """The culling launch's CullArgs, with the tensors they point into
    (which must outlive the launch): the zeroed dense image, the frame
    table's scratch, the task counter and the counters (stats)."""
    dev = arr["active_pixels"].device
    p = static.projector
    rows = cull_rows(arr)
    A = CullArgs()
    keep = {"pix": _pixels(name, static, arr, dev), "rows": rows,
            "img": torch.zeros((p.n_patterns * p.resy * p.resx,),
                               dtype=torch.float32, device=dev),
            "frames": torch.empty((p.n_patterns, 3, 4), dtype=torch.float32,
                                  device=dev),
            "next": torch.zeros((1,), dtype=torch.int32, device=dev),
            "counter": None if stats is None else torch.zeros(
                (len(CULL_COUNTERS),), dtype=torch.int64, device=dev)}
    A.active_pixels, A.rows, A.img = (
        keep[k].data_ptr() for k in ("pix", "rows", "img"))
    A.frames, A.next = keep["frames"].data_ptr(), keep["next"].data_ptr()
    A.counters = _ptr(keep["counter"])
    A.dist, A.radius = float(dist), float(radius)
    A.n_rows = rows.shape[0]
    A.n_cell_start = arr["grid_cell_start"].shape[0]
    A.n_tri_ids = arr["grid_tri_ids"].shape[0]
    A.smem_limit = CULL_SMEM_LIMIT if staged else 0
    return A, keep


def _cull_launch(name, static, arr, P, stats, **kw):
    """One launch of the culling kernel `name` into a zeroed dense
    image (kw: _cull_args's dist, radius, staged)."""
    dev = arr["active_pixels"].device
    M = make_mesh(name, static, arr)
    A, keep = _cull_args(name, static, arr, stats=stats, **kw)
    with torch.cuda.device(dev):
        fn = getattr(build_kernels()[name], name)
        err = fn(ctypes.byref(P), ctypes.byref(M), ctypes.byref(A),
                 _stream(dev))
    launches[name] += 1
    _err(name, err)
    if keep["counter"] is not None:
        for key, v in zip(CULL_COUNTERS, keep["counter"].tolist()):
            stats[key] = stats.get(key, 0) + v
    return keep["img"]


def _cull_params(name, static, arr, seed, spp):
    if name == "wf_radon":
        if static.mode != "radon":
            raise ValueError("wf_radon runs a radon static (Scene.build "
                             "mode='radon')")
        _n_lanes(static, spp)
        P = make_params(static, arr, seed, spp)
        P.residual = RADON
        return P
    P = make_params(static, arr, seed, 1)
    P.regular_sampling, P.sample_time, P.residual = 1, 0, CORNER
    return P


def cull_info(name, static: MarchStatic, arr, spp=1, count=False,
              staged=True):
    """The launch shape of the culling kernel instantiation `name` runs
    on this scene (count: the counting one; staged: as the wrapper
    launches it, else with the global banks), read from the card:
    threads a CTA, the persistent CTAs, dynamic and static shared
    memory, registers, local (stack and spill) bytes, CTAs an SM holds,
    and whether the banks are staged in shared memory."""
    P = _cull_params(name, static, arr, 0, spp)
    A, _ = _cull_args(name, static, arr, staged=staged)
    out = (ctypes.c_int * 8)()
    with torch.cuda.device(arr["active_pixels"].device):
        err = getattr(build_kernels()[name], name + "_info")(
            ctypes.byref(P), ctypes.byref(A), int(count), out)
    if err != 0:
        raise RuntimeError(f"{name}: occupancy query failed, cudaError_t "
                           f"{err}")
    keys = ("threads", "ctas", "dynamic_smem_bytes", "static_smem_bytes",
            "registers", "local_bytes", "ctas_per_sm", "staged")
    return dict(zip(keys, list(out)))


def wf_radon(static: MarchStatic, arr, seed, spp, stats=None, staged=True):
    """CUDA kernel csrc/wf_radon.cu: the radon render's dense image of a
    radon static (the scene tensors on the card, the target mesh kept).
    Replaces drtvam_tpu/ops/render.py:193 render_radon (XLA). One thread
    an active pixel, its spp lanes in the template's RADON mode, the
    pixel written once: bitwise reproducible. What bounds it on the
    H100: the operations of the surface intersections, the mesh's
    triangle tests above all; persistent CTAs hold the mesh banks in
    shared memory where they fit (staged False: the global copies, as
    for a bank too large). stats: adds the CULL_COUNTERS."""
    P = _cull_params("wf_radon", static, arr, seed, spp)
    return _cull_launch("wf_radon", static, arr, P, stats, staged=staged)


def wf_corner(static: MarchStatic, arr, dist, radius, seed=0, stats=None,
              staged=True):
    """CUDA kernel csrc/wf_corner.cu: the corner filter's dense keep image
    (the ray weight where a pixel is kept, else 0) of a static with the
    target kept, on the card. Replaces drtvam_tpu/ops/render.py:226
    render_corner (XLA). One thread an active pixel, its centre ray's
    set-up (its angle's frame from a table) and one intersection
    (regular sampling, spp 1), the pixel written once. Bound as
    wf_radon's one iteration; staged and stats as for wf_radon."""
    P = _cull_params("wf_corner", static, arr, seed, 1)
    return _cull_launch("wf_corner", static, arr, P, stats, dist=dist,
                        radius=radius, staged=staged)


def render_radon(static: MarchStatic, arr, seed=0, spp=4, chunk=None):
    """The radon render (filter_radon's fallback for scenes that are not
    transport-eligible): each active pixel's in-target absorption summed
    over its spp lanes, times the ray weight, in the dense (n_patterns *
    resy * resx,) image. arr: the scene tensors (`scene_tensors`) of a
    radon static; wf_radon on the card, the plain version on the CPU."""
    if _route(arr["active_pixels"]):
        return wf_radon(static, arr, seed, spp)
    return _radon(static, arr, seed, spp,
                  DEFAULT_CHUNK if chunk is None else chunk)


def render_corner(static: MarchStatic, arr, dist, radius=0.1, seed=0,
                  chunk=None):
    """The corner filter's keep image (>0: keep) in the dense (n_patterns
    * resy * resx,) layout: regular sampling, spp 1, one intersection a
    pixel, as drtvam_tpu/ops/render.py:226-268. arr: the scene tensors of
    a static built with the target kept; wf_corner on the card, the plain
    version on the CPU."""
    if _route(arr["active_pixels"]):
        return wf_corner(static, arr, dist, radius, seed)
    check_supported(static)
    return _corner(static, arr, dist, radius, seed,
                   DEFAULT_CHUNK if chunk is None else chunk)
