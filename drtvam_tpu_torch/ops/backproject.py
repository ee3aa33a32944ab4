"""Ballistic dose backprojection (counterpart of
drtvam_tpu/ops/backproject.py).

Consumes the per-angle 2D transport fields (ops/transport2d.py) and the
z-resampled pattern stack Pz (A, Zf, U):

    forward:  dose(Zf, YX)    = sum_a Pz_a @ B_a
    adjoint:  Pzbar(A, Zf, U) = dL @ B_a^T        (exact transpose)

with B_a(U, YX) the 2-sparse interpolation matrix
B[i, j] = W_j * max(0, 1 - |u_j - i|): two taps per cell, at
i0 = floor(u_j) and i0 + 1.

Four kernel wrappers, one per TPU kernel of the JAX package, each with
its plain PyTorch version beside it:

    fwd_dense / bwd_dense   <- _fwd_pallas / _bwd_pallas
    fwd_band  / bwd_band    <- _fwd_banded / _bwd_banded

The CUDA kernels live in ../csrc (one source each) and are built with
nvcc at first use. A wrapper given CPU tensors runs the plain version;
given CUDA tensors it launches its kernel or raises. `launches` counts
kernel launches per kernel.

The fields are packed once per engine (`PackedFields`): W and u of each
cell side by side, u = -2 in empty cells (W = 0) so both taps fall
outside every column range. The banded layout re-tiles the film into
BY x BX blocks and gives each (angle, block) a BANDW-column band start
u0, a multiple of 128 clipped to [0, Upad - BANDW].
"""
from __future__ import annotations

import ctypes

import torch

BY, BX = 32, 64          # dose block of the banded layout
TILE_B = BY * BX
BANDW = 256              # band columns; u0 quantized to 128
MAX_DENSE_U = 6400       # the dense kernels stage >= 8 rows of U columns
                         # in 200 KB of shared memory

KERNELS = ("bp_fwd", "bp_bwd", "bp_fwd_band", "bp_bwd_band")
launches = {k: 0 for k in KERNELS}


def reset_launches():
    for k in KERNELS:
        launches[k] = 0


def _round_up(x, m):
    return -(-x // m) * m


# --------------------------------------------------------------------------
# packing


def block_permute(x, Y, X):
    """(..., Y, X) raster -> (..., n_tiles, BY*BX) block-major."""
    lead = tuple(x.shape[:-2])
    x = x.reshape(lead + (Y // BY, BY, X // BX, BX))
    x = torch.movedim(x, -2, -3)
    return x.reshape(lead + ((Y // BY) * (X // BX), BY * BX))


def block_unpermute(x, Y, X):
    """(..., n_tiles * BY*BX) block-major -> (..., Y, X) raster."""
    lead = tuple(x.shape[:-1])
    x = x.reshape(lead + (Y // BY, X // BX, BY, BX))
    x = torch.movedim(x, -2, -3)
    return x.reshape(lead + (Y, X))


def banded_eligible(W_shape, U):
    _, Y, X = W_shape
    return Y % BY == 0 and X % BX == 0 and _round_up(U, 128) >= BANDW


def _pack_fields(W, Umap):
    """(A, Y, X) pair -> (A, 2, Y*X) with empty cells at u = -2."""
    A, Y, X = W.shape
    Wf = W.reshape(A, Y * X)
    Uf = torch.where(Wf > 0, Umap.reshape(A, Y * X),
                     torch.tensor(-2.0, dtype=Umap.dtype, device=W.device))
    return torch.stack([Wf, Uf], dim=1).contiguous()


def _band_starts(Wb, Ub, U):
    """Per-(angle, tile) band start (float, before the int cast) and the
    valid-cell mask, from block-major fields."""
    Upad = _round_up(U, 128)
    valid = Wb > 0
    inf = torch.tensor(float("inf"), dtype=Ub.dtype, device=Ub.device)
    min_u = torch.where(valid, Ub, inf).amin(-1)
    u0 = torch.floor((min_u - 1.0) / 128.0) * 128.0
    u0 = torch.where(torch.isfinite(u0), u0, torch.zeros_like(u0))
    return u0.clamp(0, Upad - BANDW), valid


def _pack_fields_banded(W, Umap, U):
    """Block-major (A, 2, n_tiles*TILE_B) fields + (A, n_tiles) int32
    band starts (multiples of 128)."""
    A, Y, X = W.shape
    Wb = block_permute(W, Y, X)                      # (A, T, TILE_B)
    Ub = block_permute(Umap, Y, X)
    u0, valid = _band_starts(Wb, Ub, U)
    Ub = torch.where(valid, Ub,
                     torch.tensor(-2.0, dtype=Ub.dtype, device=Ub.device))
    T = Wb.shape[1]
    F = torch.stack([Wb.reshape(A, T * TILE_B), Ub.reshape(A, T * TILE_B)],
                    dim=1).contiguous()
    return F, u0.to(torch.int32).contiguous()


def band_span_ok(W, Umap, U):
    """True iff every (angle, tile) band covers its cells' u-range. The
    data-dependent half of the banded eligibility: if it fails the
    banded kernels would drop taps, so the dense pair must run."""
    A, Y, X = W.shape
    Wb = block_permute(W, Y, X)
    Ub = block_permute(Umap, Y, X)
    u0, valid = _band_starts(Wb, Ub, U)
    ninf = torch.tensor(-float("inf"), dtype=Ub.dtype, device=Ub.device)
    max_u = torch.where(valid, Ub, ninf).amax(-1)
    ok = ~valid.any(-1) | (max_u + 1.0 <= u0 + BANDW - 1)
    return bool(ok.all())


# --------------------------------------------------------------------------
# plain versions (torch; CPU path and reference on the card)


def _taps(F, U, lo=None):
    """Tap columns (clipped) and weights (masked) of packed fields.
    lo: optional per-cell band start (A, L); taps are kept in
    [lo, min(lo + BANDW, U)) instead of [0, U)."""
    W, u = F[:, 0], F[:, 1]
    fl = torch.floor(u)
    f = u - fl
    i0 = fl.to(torch.int64)
    i1 = i0 + 1
    if lo is None:
        in0 = (i0 >= 0) & (i0 < U)
        in1 = (i1 >= 0) & (i1 < U)
    else:
        hi = torch.clamp(lo + BANDW, max=U)
        in0 = (i0 >= lo) & (i0 < hi)
        in1 = (i1 >= lo) & (i1 < hi)
    w0 = W * (1.0 - f) * in0
    w1 = W * f * in1
    return i0.clamp(0, U - 1), i1.clamp(0, U - 1), w0, w1


def _fwd_plain(Pz, taps):
    A, Zf, _ = Pz.shape
    i0, i1, w0, w1 = taps
    dose = torch.zeros((Zf, i0.shape[1]), dtype=torch.float32,
                       device=Pz.device)
    for a in range(A):
        Pa = Pz[a]
        dose += Pa.index_select(1, i0[a]) * w0[a] + \
            Pa.index_select(1, i1[a]) * w1[a]
    return dose


def _bwd_plain(dL, taps, U):
    i0, i1, w0, w1 = taps
    A = i0.shape[0]
    out = torch.zeros((A, dL.shape[0], U), dtype=torch.float32,
                      device=dL.device)
    for a in range(A):
        out[a].index_add_(1, i0[a], dL * w0[a])
        out[a].index_add_(1, i1[a], dL * w1[a])
    return out


def _band_lo(u0):
    return u0.to(torch.int64).repeat_interleave(TILE_B, dim=1)


def fwd_dense_plain(Pz, F):
    """Plain version of the dense forward: take-based, angle by angle
    (the JAX package's _fwd_xla)."""
    return _fwd_plain(Pz, _taps(F, Pz.shape[2]))


def bwd_dense_plain(dL, F, U):
    """Plain version of the dense adjoint (_bwd_xla)."""
    return _bwd_plain(dL, _taps(F, U), U)


def fwd_band_plain(Pz, F, u0, Y, X):
    """Plain version of the banded forward: taps outside each block's
    band are dropped exactly as the kernel drops them."""
    out = _fwd_plain(Pz, _taps(F, Pz.shape[2], _band_lo(u0)))
    return block_unpermute(out, Y, X).reshape(Pz.shape[1], Y * X)


def bwd_band_plain(dL, F, u0, U, Y, X):
    """Plain version of the banded adjoint; dL is (Zf, Y*X) raster."""
    dLb = block_permute(dL.reshape(-1, Y, X), Y, X).reshape(dL.shape[0], -1)
    return _bwd_plain(dLb, _taps(F, U, _band_lo(u0)), U)


# --------------------------------------------------------------------------
# CUDA kernels


def _setup(lib, name, n_ptr, n_int):
    fn = getattr(lib, name)
    fn.argtypes = [ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int + \
        [ctypes.c_void_p]
    fn.restype = ctypes.c_int


_SETUP = {
    "bp_fwd": lambda lib: _setup(lib, "bp_fwd", 3, 4),
    "bp_bwd": lambda lib: _setup(lib, "bp_bwd", 3, 4),
    "bp_fwd_band": lambda lib: _setup(lib, "bp_fwd_band", 4, 5),
    "bp_bwd_band": lambda lib: _setup(lib, "bp_bwd_band", 4, 5),
}


def build_kernels():
    """Build (nvcc, one process per source, in parallel) and load all
    four kernels. Returns {name: ctypes lib}; raises on any failure."""
    from ..native import load_cuda
    return load_cuda(KERNELS, _SETUP)


def _check(name, tensors, dtypes, shapes):
    dev = tensors[0].device
    for t, dt, shp in zip(tensors, dtypes, shapes):
        if t.device != dev:
            raise ValueError(f"{name}: tensors on {t.device} and {dev}")
        if t.dtype != dt:
            raise ValueError(f"{name}: expected {dt}, got {t.dtype}")
        if tuple(t.shape) != tuple(shp):
            raise ValueError(f"{name}: expected shape {tuple(shp)}, got "
                             f"{tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: tensors must be contiguous")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {dev}")
    return dev


def _launch(name, dev, args):
    with torch.cuda.device(dev):
        fn = getattr(build_kernels()[name], name)
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(*args, stream)
    launches[name] += 1
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed, cudaError_t {err}")


def _check_dense_u(name, U):
    if U > MAX_DENSE_U:
        raise ValueError(f"{name}: U = {U} exceeds {MAX_DENSE_U}, the "
                         "widest DMD row the dense kernels stage")


def fwd_dense(Pz, F):
    """dose (Zf, YX) = sum_a Pz_a @ B_a. Pz (A, Zf, U), F (A, 2, YX).

    CUDA kernel csrc/bp_fwd.cu; replaces drtvam_tpu/ops/backproject.py
    _fwd_pallas (:187). At the bench scene the operands are Pz (164 MB)
    and the fields (210 MB) against two FMAs per (angle, voxel, z); on
    the H100 the kernel is bound by its shared-memory tap reads and the
    per-angle staging of Pz (PERF.md). A block stages each angle's Pz
    slab (z-chunk x all U columns) in shared memory once for 512 voxels,
    reads each voxel's (W, u) once per angle and accumulates in
    registers: HBM sees Pz once per voxel tile, no atomics, one output
    write."""
    A, Zf, U = Pz.shape
    YX = F.shape[2]
    dev = _check("bp_fwd", (Pz, F), (torch.float32,) * 2,
                 ((A, Zf, U), (A, 2, YX)))
    if dev.type == "cpu":
        return fwd_dense_plain(Pz, F)
    _check_dense_u("bp_fwd", U)
    out = torch.empty((Zf, YX), dtype=torch.float32, device=dev)
    _launch("bp_fwd", dev, (Pz.data_ptr(), F.data_ptr(), out.data_ptr(),
                            A, Zf, U, YX))
    return out


def bwd_dense(dL, F, U):
    """Pzbar (A, Zf, U) = dL @ B_a^T. dL (Zf, YX), F (A, 2, YX).

    CUDA kernel csrc/bp_bwd.cu; replaces _bwd_pallas (:221). At the
    bench scene dL (67 MB) is read once per angle against the fields
    (210 MB); on the H100 the kernel is bound by its shared-memory
    atomics (two per angle, voxel and z). A block owns (angle, z-chunk),
    adds its taps into a z-chunk x U accumulator in shared memory and
    writes it once: no global atomics. Atomics sum in a run-dependent
    order."""
    Zf, YX = dL.shape
    A = F.shape[0]
    dev = _check("bp_bwd", (dL, F), (torch.float32,) * 2,
                 ((Zf, YX), (A, 2, YX)))
    if dev.type == "cpu":
        return bwd_dense_plain(dL, F, U)
    _check_dense_u("bp_bwd", U)
    out = torch.empty((A, Zf, U), dtype=torch.float32, device=dev)
    _launch("bp_bwd", dev, (dL.data_ptr(), F.data_ptr(), out.data_ptr(),
                            A, Zf, U, YX))
    return out


def _check_band(name, U, Y, X):
    if Y % BY or X % BX:
        raise ValueError(f"{name}: film {Y}x{X} does not tile into "
                         f"{BY}x{BX} blocks")
    if _round_up(U, 128) < BANDW:
        raise ValueError(f"{name}: U = {U} is narrower than the band")


def fwd_band(Pz, F, u0, Y, X):
    """Banded forward: dose (Zf, Y*X) raster. F (A, 2, T*TILE_B)
    block-major, u0 (A, T) int32 band starts.

    CUDA kernel csrc/bp_fwd_band.cu; replaces _fwd_banded (:362). Same
    operands and bound as fwd_dense (Pz 164 MB, fields 210 MB at the
    bench scene; shared-memory tap reads and Pz staging). A block owns a
    quarter of one 32x64 film block x 32 z-rows and stages only the
    256-column band of Pz per angle (32 KB, not all U columns), and
    accumulates in registers; it writes the raster dose directly (no
    unpermute pass)."""
    A, Zf, U = Pz.shape
    _check_band("bp_fwd_band", U, Y, X)
    T = (Y // BY) * (X // BX)
    dev = _check("bp_fwd_band", (Pz, F, u0),
                 (torch.float32, torch.float32, torch.int32),
                 ((A, Zf, U), (A, 2, T * TILE_B), (A, T)))
    if dev.type == "cpu":
        return fwd_band_plain(Pz, F, u0, Y, X)
    out = torch.empty((Zf, Y * X), dtype=torch.float32, device=dev)
    _launch("bp_fwd_band", dev, (Pz.data_ptr(), F.data_ptr(),
                                 u0.data_ptr(), out.data_ptr(),
                                 A, Zf, U, Y, X))
    return out


def bwd_band(dL, F, u0, U, Y, X):
    """Banded adjoint: Pzbar (A, Zf, U) from raster dL (Zf, Y*X).

    CUDA kernel csrc/bp_bwd_band.cu; replaces _bwd_banded (:426). dL
    (67 MB at the bench scene) is read once per angle; on the H100 the
    kernel is bound by atomics. A block owns (angle, film block, 32
    z-rows), accumulates its 32 x 256 band in shared memory, then adds
    the band into the output with global atomicAdd, since the bands of
    one angle overlap. Atomics sum in a run-dependent order."""
    Zf = dL.shape[0]
    A = F.shape[0]
    _check_band("bp_bwd_band", U, Y, X)
    T = (Y // BY) * (X // BX)
    dev = _check("bp_bwd_band", (dL, F, u0),
                 (torch.float32, torch.float32, torch.int32),
                 ((Zf, Y * X), (A, 2, T * TILE_B), (A, T)))
    if dev.type == "cpu":
        return bwd_band_plain(dL, F, u0, U, Y, X)
    # bands of one angle overlap: the kernel adds into a zeroed output
    out = torch.zeros((A, Zf, U), dtype=torch.float32, device=dev)
    _launch("bp_bwd_band", dev, (dL.data_ptr(), F.data_ptr(),
                                 u0.data_ptr(), out.data_ptr(),
                                 A, Zf, U, Y, X))
    return out


# --------------------------------------------------------------------------
# packed fields + differentiable entry


class PackedFields:
    """The (W, u) transport fields of one scene, packed once for the
    kernels in the dense or the banded layout; one copy on the device.

    W, Umap: (A, Y, X) float32 tensors on the target device; U: DMD
    columns. banded=True needs banded_eligible and band_span_ok."""

    def __init__(self, W, Umap, U, banded):
        A, Y, X = W.shape
        self.A, self.Y, self.X, self.U = A, Y, X, U
        self.banded = bool(banded)
        if self.banded:
            self.F, self.u0 = _pack_fields_banded(W, Umap, U)
        else:
            self.F, self.u0 = _pack_fields(W, Umap), None

    def forward(self, Pz):
        """(A, Zf, U) -> dose (Zf, Y*X)."""
        Pz = Pz.contiguous()
        if self.banded:
            return fwd_band(Pz, self.F, self.u0, self.Y, self.X)
        return fwd_dense(Pz, self.F)

    def adjoint(self, dL):
        """(Zf, Y*X) -> Pzbar (A, Zf, U)."""
        dL = dL.contiguous()
        if self.banded:
            return bwd_band(dL, self.F, self.u0, self.U, self.Y, self.X)
        return bwd_dense(dL, self.F, self.U)


class Backproject(torch.autograd.Function):
    """dose = backproject(Pz); the backward is the adjoint kernel (the
    JAX package's custom_vjp)."""

    @staticmethod
    def forward(ctx, Pz, fields):
        ctx.fields = fields
        return fields.forward(Pz)

    @staticmethod
    def backward(ctx, dose_bar):
        return ctx.fields.adjoint(dose_bar), None


def backproject(Pz, fields):
    return Backproject.apply(Pz, fields)
