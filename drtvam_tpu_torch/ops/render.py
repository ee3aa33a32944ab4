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

Two kernel wrappers, each with its plain version beside it:

    wf_fwd  <- forward   (plain: _forward, trace_wavefront chunk by chunk)
    wf_bwd  <- adjoint   (plain: _adjoint)

The CUDA kernels are csrc/wf_fwd.cu and csrc/wf_bwd.cu, two entry points
of the one per-lane path template csrc/wf_trace.cuh; they replace the
XLA code of drtvam_tpu/ops/march.py:913 `trace_wavefront` (there is no
Pallas kernel on this path). Given CPU tensors `forward` / `adjoint`
run the plain version; given CUDA tensors they launch the kernel or
raise. `launches` counts kernel launches per kernel.

The kernels trace one active pixel per thread, its spp lanes in lane
order, with all lane state in registers (no chunking). The forward adds
deposits with float atomics, so its sums are not bitwise reproducible;
the adjoint writes each pixel's sum once, in a fixed order, and is.
"""
from __future__ import annotations

import ctypes

import torch

from ..models.projector import PROJECTOR_KINDS, ray_weight
from .march import (ESTIMATORS, MarchStatic, check_supported,
                    dda_max_steps, trace_wavefront)
from .medium import PHASE_IDS

DEFAULT_CHUNK = 1 << 16   # plain version: lanes per pass
MAX_SURF = 8              # surfaces a kernel launch takes (WF_MAX_SURF)

KERNELS = ("wf_fwd", "wf_bwd")
launches = {k: 0 for k in KERNELS}


def reset_launches():
    for k in KERNELS:
        launches[k] = 0


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


# --------------------------------------------------------------------------
# plain versions


def _forward(static: MarchStatic, arr, data, seed, spp, chunk, stats=None):
    """The dose accumulator, chunk by chunk through trace_wavefront."""
    n_lanes = _n_lanes(static, spp)
    chunk, n_chunks = _chunking(n_lanes, chunk, spp)
    arr = dict(arr, active_data=data)
    acc = torch.zeros((static.sensor.n_cells,), dtype=torch.float32,
                      device=data.device)
    for i in range(n_chunks):
        lane = torch.arange(i * chunk, min((i + 1) * chunk, n_lanes),
                            dtype=torch.int64, device=data.device)
        acc, _ = trace_wavefront(static, arr, lane, seed, spp, acc=acc,
                                 em=data[lane // spp], stats=stats)
    return acc


def _adjoint(static: MarchStatic, arr, seed, spp, chunk, dL_flat,
             stats=None):
    """The pattern gradient (n_active,): per-lane emitter gradients
    summed per pixel in lane order, times the ray weight."""
    n_active = static.projector.n_active
    n_lanes = _n_lanes(static, spp)
    chunk, n_chunks = _chunking(n_lanes, chunk, spp)
    dev = dL_flat.device
    pg = torch.zeros((n_active,), dtype=torch.float32, device=dev)
    for i in range(n_chunks):
        lo, hi = i * chunk, min((i + 1) * chunk, n_lanes)
        lane = torch.arange(lo, hi, dtype=torch.int64, device=dev)
        _, g = trace_wavefront(static, arr, lane, seed, spp,
                               dL_flat=dL_flat, stats=stats)
        g = g.reshape(-1, spp)
        g_pix = g[:, 0]
        for k in range(1, spp):
            g_pix = g_pix + g[:, k]
        pg[lo // spp:hi // spp] = g_pix
    return pg * ray_weight(static.projector, arr, spp, arr["print_time"])


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
    ]


def _host(x):
    return x.detach().cpu().reshape(-1).tolist()


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
    P.identity = int(p.identity)
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
    return P


def _setup(lib, name):
    fn = getattr(lib, name)
    fn.argtypes = [ctypes.POINTER(WfParams)] + [ctypes.c_void_p] * 5
    fn.restype = ctypes.c_int


_SETUP = {k: (lambda lib, k=k: _setup(lib, k)) for k in KERNELS}
# the kernels round every float operation as the plain version's separate
# torch ops do (no FMA contraction): see csrc/wf_trace.cuh
_FLAGS = {k: ["--fmad=false"] for k in KERNELS}


def build_kernels():
    """Build (nvcc, one process per source, in parallel) and load both
    kernels. Returns {name: ctypes lib}; raises on any failure."""
    from ..native import load_cuda
    return load_cuda(KERNELS, _SETUP, _FLAGS)


def _check(name, t, dtype, shape):
    if t.dtype != dtype:
        raise ValueError(f"{name}: expected {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: tensors must be contiguous")


def _launch(name, static, arr, x, out, seed, spp, stats):
    dev = x.device
    pix = arr["active_pixels"]
    if pix.device != dev:
        raise ValueError(f"{name}: scene tensors on {pix.device}, input on "
                         f"{dev}")
    _check(name, pix, torch.int32, (static.projector.n_active,))
    P = make_params(static, arr, seed, spp)
    counter = None
    if stats is not None:
        counter = torch.zeros((2,), dtype=torch.int64, device=dev)
    with torch.cuda.device(dev):
        fn = getattr(build_kernels()[name], name)
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(ctypes.byref(P), x.data_ptr(), pix.data_ptr(),
                 out.data_ptr(),
                 None if counter is None else counter.data_ptr(), stream)
    launches[name] += 1
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed, cudaError_t {err}")
    if counter is not None:
        c = counter.tolist()
        stats["iterations"] = stats.get("iterations", 0) + c[0]
        stats["steps"] = stats.get("steps", 0) + c[1]


def wf_fwd(static: MarchStatic, arr, data, seed, spp, stats=None):
    """CUDA kernel csrc/wf_fwd.cu: the dose accumulator (n_cells,) of
    `data` (n_active,) float32 on the card. Replaces the primal of
    drtvam_tpu/ops/march.py:913 trace_wavefront (XLA). What bounds it
    on the H100: the float32 work of the voxel steps (~20 operations a
    step, two of them expf) and, past the 50 MB L2, the atomic adds of
    the deposits into the 67 MB dose grid of a 256^3 film."""
    _n_lanes(static, spp)
    _check("wf_fwd", data, torch.float32, (static.projector.n_active,))
    acc = torch.zeros((static.sensor.n_cells,), dtype=torch.float32,
                      device=data.device)
    _launch("wf_fwd", static, arr, data, acc, seed, spp, stats)
    return acc


def wf_bwd(static: MarchStatic, arr, dL_flat, seed, spp, stats=None):
    """CUDA kernel csrc/wf_bwd.cu: the pattern gradient (n_active,) of
    dL_flat (n_cells,) float32 on the card, replaying the forward's
    paths. Replaces the adjoint of drtvam_tpu/ops/march.py:913 (XLA).
    Bound as wf_fwd, with gathers of dL in place of the atomics; every
    output is written once, so the result is bitwise reproducible."""
    _n_lanes(static, spp)
    _check("wf_bwd", dL_flat, torch.float32, (static.sensor.n_cells,))
    out = torch.empty((static.projector.n_active,), dtype=torch.float32,
                      device=dL_flat.device)
    _launch("wf_bwd", static, arr, dL_flat, out, seed, spp, stats)
    return out


def _route(x):
    if x.device.type == "cpu":
        return False
    if x.device.type == "cuda":
        return True
    raise ValueError(f"unsupported device {x.device}")


def forward(static: MarchStatic, arr, data, seed, spp, chunk=DEFAULT_CHUNK):
    """Flat unnormalized dose (n_cells,): wf_fwd on the card, the plain
    version on the CPU."""
    if _route(data):
        return wf_fwd(static, arr, data.contiguous(), seed, spp)
    return _forward(static, arr, data, seed, spp, chunk)


def adjoint(static: MarchStatic, arr, seed, spp, chunk, dL_flat):
    """Pattern gradient (n_active,) of dL_flat: wf_bwd on the card, the
    plain version on the CPU."""
    if _route(dL_flat):
        return wf_bwd(static, arr, dL_flat.contiguous(), seed, spp)
    return _adjoint(static, arr, seed, spp, chunk, dL_flat)


class RenderRaw(torch.autograd.Function):
    """Flat dose accumulator, differentiable in the patterns: the
    backward replays the paths with the same seed and spp_grad lanes
    per pixel."""

    @staticmethod
    def forward(ctx, data, static, arr, seed, spp, spp_grad, chunk):
        ctx.args = (static, arr, seed, spp_grad, chunk)
        return forward(static, arr, data, seed, spp, chunk)

    @staticmethod
    def backward(ctx, ct):
        static, arr, seed, spp_grad, chunk = ctx.args
        pg = adjoint(static, arr, seed, spp_grad, chunk, ct.contiguous())
        return pg, None, None, None, None, None, None


def render(static: MarchStatic, arr, data, inv_vol, seed=0, spp=1,
           spp_grad=None, chunk=None):
    """Dose volume (Z, Y, X, C): the raw accumulator x 1 / voxel
    volume, differentiable in `data` through RenderRaw."""
    raw = RenderRaw.apply(data, static, arr, seed, spp,
                          spp if spp_grad is None else spp_grad,
                          DEFAULT_CHUNK if chunk is None else chunk)
    return raw.reshape(static.sensor.shape) * inv_vol
