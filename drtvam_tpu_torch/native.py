"""Native code: host C++ (g++) and CUDA (nvcc), built at first use and
loaded with ctypes.

Host components: `csrc/host/transport2d.cpp` (the 2D refracted ray fan
rasterizer) and `csrc/host/mesh_accel.cpp` (the XY-grid mesh
voxelizer), the port's own copies of the JAX package's host sources.
They are host preprocessing, not TPU kernels; the port keeps its copy so
that it reads no file of the JAX package.

CUDA components: the port's own kernels under `csrc/`, one shared
library with a plain C interface per source (nvcc for sm_90a), loaded
with ctypes; callers pass `data_ptr()`s and the current stream.

Everything is compiled into `drtvam_tpu_torch/_build/` (gitignored).
A failed build or load raises: there is no fallback.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
import tempfile
import threading

import numpy as np

_PKG = os.path.dirname(os.path.abspath(__file__))
CUDA_SRC_DIR = os.path.join(_PKG, "csrc")
HOST_SRC_DIR = os.path.join(CUDA_SRC_DIR, "host")
BUILD_DIR = os.path.join(_PKG, "_build")

_lock = threading.Lock()
_libs = {}

_F32P = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
_I32P = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")


def _stale(lib_path, deps):
    return not os.path.exists(lib_path) or any(
        os.path.getmtime(lib_path) < os.path.getmtime(d) for d in deps)


def _start(cmd, lib_path):
    """Start one compiler run writing to a temp file beside lib_path;
    `_finish` renames it into place, so a concurrent process never loads
    a half-written library."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    proc = subprocess.Popen(cmd + ["-o", tmp], stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, lib_path, cmd


def _finish(job, timeout=600):
    proc, tmp, lib_path, cmd = job
    try:
        out, _ = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.communicate()
        os.unlink(tmp)
        raise RuntimeError(f"build timed out after {timeout}s: "
                           f"{' '.join(cmd)}")
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"build failed ({proc.returncode}): "
                           f"{' '.join(cmd)}\n{out}")
    os.replace(tmp, lib_path)
    with open(lib_path + ".log", "w") as f:
        f.write(" ".join(cmd) + "\n" + out)


# --------------------------------------------------------------------------
# host C++


def _setup_transport2d(lib):
    lib.rasterize_fan.argtypes = [
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int,
        _I32P, _I32P, _I32P, _F32P, _F32P, ctypes.c_int,
        ctypes.c_float, ctypes.c_float, ctypes.c_int,
        ctypes.c_float, ctypes.c_float,
        ctypes.c_float, ctypes.c_float, ctypes.c_float, ctypes.c_float,
        _F32P, _F32P,
    ]
    lib.rasterize_fan.restype = None


def _setup_mesh_accel(lib):
    lib.voxelize_mesh.argtypes = [
        _F32P, _F32P, _F32P, ctypes.c_int, _F32P, _F32P,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, _F32P,
    ]
    lib.voxelize_mesh.restype = None


_HOST_SETUP = {"transport2d": _setup_transport2d,
               "mesh_accel": _setup_mesh_accel}


def load_host(name):
    """Build (g++ -O3 -fopenmp) if stale and load one host library."""
    with _lock:
        if name in _libs:
            return _libs[name]
        src = os.path.join(HOST_SRC_DIR, name + ".cpp")
        lib_path = os.path.join(BUILD_DIR, "lib" + name + ".so")
        if _stale(lib_path, [src]):
            _finish(_start(["g++", "-O3", "-fopenmp", "-shared", "-fPIC",
                            src], lib_path), timeout=300)
        lib = ctypes.CDLL(lib_path)
        _HOST_SETUP[name](lib)
        _libs[name] = lib
        return lib


def _as_f32(a):
    return np.ascontiguousarray(np.asarray(a, np.float32))


def voxelize_mesh_native(tri_bank, bbox_min, bbox_max, res, mode,
                         oversample=4):
    """XY-grid column voxelization: mode 0 binary occupancy by voxel-
    center parity, mode 1 inside fraction. Returns (Z, Y, X) float32."""
    lib = load_host("mesh_accel")
    v0, e1, e2 = (_as_f32(tri_bank[0]), _as_f32(tri_bank[1]),
                  _as_f32(tri_bank[2]))
    X, Y, Z = res
    out = np.zeros((Z, Y, X), np.float32)
    lib.voxelize_mesh(v0, e1, e2, v0.shape[0], _as_f32(bbox_min),
                      _as_f32(bbox_max), X, Y, Z, int(mode),
                      int(oversample), out)
    return out


def rasterize_fan(static, arr, supersample=1):
    """The A x (U * S) 2D ray fan rasterized into per-angle fields.
    Returns numpy (W, UW), each (A, Y, X) float32."""
    from .models.geometry import CYLINDER, BOX
    bad = [s.kind for s in static.surfaces if s.kind not in (CYLINDER, BOX)]
    if bad:
        # never reached from the engines: unscattered_eligible sends a
        # scene with a mesh vial or occlusions to the wavefront engine
        raise ValueError(
            "the native rasterizer takes analytic cylinder/box surfaces "
            f"only, got kinds {bad}: a scene with mesh surfaces is not "
            "z-invariant (ops/transport2d.py unscattered_eligible)")
    lib = load_host("transport2d")
    p = static.projector
    A, U, S = p.n_patterns, p.resx, int(supersample)
    X, Y, _ = static.sensor.res
    kind = np.asarray([s.kind for s in static.surfaces], np.int32)
    bsdf = np.asarray([s.bsdf for s in static.surfaces], np.int32)
    ms = np.asarray([s.medium_side for s in static.surfaces], np.int32)
    eta = _as_f32(arr["surf_eta"])
    params = _as_f32(arr["surf_params"])
    bmin = np.asarray(arr["bbox_min"], np.float32)
    bmax = np.asarray(arr["bbox_max"], np.float32)
    W = np.zeros((A, Y, X), np.float32)
    UW = np.zeros((A, Y, X), np.float32)
    lib.rasterize_fan(
        A, U, S, X, Y,
        kind, bsdf, ms, eta, params, len(static.surfaces),
        float(np.asarray(arr["pixel_size"])[0]),
        float(np.asarray(arr["motion_distance"])),
        1 if static.clockwise else 0,
        float(np.asarray(arr["sigma_t"])),
        float(np.asarray(arr["albedo"])),
        float(bmin[0]), float(bmin[1]), float(bmax[0]), float(bmax[1]),
        W, UW)
    return W, UW


# --------------------------------------------------------------------------
# CUDA


def nvcc_path():
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = os.path.join(home, "bin", "nvcc")
    return cand if os.path.exists(cand) else "nvcc"


def load_cuda(names, setup, flags=None):
    """Build the named `csrc/<name>.cu` sources (one nvcc per stale
    source, all started together) and load them.

    setup: {name: fn(lib)} declaring argtypes/restype; flags: optional
    {name: [extra nvcc flags]}. Returns {name: ctypes lib}. Raises on
    any failed build or load."""
    with _lock:
        todo = [n for n in names if ("cuda", n) not in _libs]
        jobs = []
        for n in todo:
            src = os.path.join(CUDA_SRC_DIR, n + ".cu")
            deps = [src] + [os.path.join(CUDA_SRC_DIR, h) for h in
                            os.listdir(CUDA_SRC_DIR) if h.endswith(".cuh")]
            lib_path = os.path.join(BUILD_DIR, "lib" + n + ".so")
            if _stale(lib_path, deps):
                cmd = [nvcc_path(), "-gencode",
                       "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
                       "-Xptxas", "-v", "-shared", "-Xcompiler", "-fPIC",
                       "-I", CUDA_SRC_DIR] + (flags or {}).get(n, []) + [src]
                jobs.append(_start(cmd, lib_path))
        errors = []
        for job in jobs:
            try:
                _finish(job)
            except RuntimeError as e:
                errors.append(str(e))
        if errors:
            raise RuntimeError("\n".join(errors))
        for n in todo:
            lib = ctypes.CDLL(os.path.join(BUILD_DIR, "lib" + n + ".so"))
            setup[n](lib)
            _libs[("cuda", n)] = lib
        return {n: _libs[("cuda", n)] for n in names}
