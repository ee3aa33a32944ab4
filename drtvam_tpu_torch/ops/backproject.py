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

Each takes `bf16=`: False launches the float32 kernel (bp_fwd, ...),
True its bf16 operand form (bp_fwd_bf16, ...), the JAX kernels'
bf16=True branch: the streamed operand (Pz or dL) and every tap weight
W * (1 - f), W * f are rounded to bfloat16 (nearest even), and the sums
are float32. The plain versions take the same flag.

The CUDA kernels live in ../csrc (one source each) and are built with
nvcc at first use. A wrapper given CPU tensors runs the plain version;
given CUDA tensors it launches its kernel or raises. `launches` counts
kernel launches per kernel.

The fields are packed once per engine (`PackedFields`): W and u of each
cell side by side, u = -2 in empty cells (W = 0) so both taps fall
outside every column range. The banded layout re-tiles the film into
BY x BX blocks and gives each (angle, block) a BANDW-column band start
u0, a multiple of 128 clipped to [0, Upad - BANDW]. On the card both
layouts also carry a `DenseLayout`: the exact column window of each
(angle, FT x FT film tile), which the forward kernels stage, and per
angle the voxels grouped by floor(u), which the adjoint kernels walk.
For banded fields both are built from the band-masked taps, so the
banded pair runs the dense pair's kernel templates unchanged: on Hopper
the band is a mask on the layout, not a staging width.
"""
from __future__ import annotations

import ctypes
from functools import cached_property

import torch
import torch.nn.functional as tnf

BY, BX = 32, 64          # dose block of the banded layout
TILE_B = BY * BX
BANDW = 256              # band columns; u0 quantized to 128
MAX_DENSE_U = 6400       # bp_fwd stages >= 4 float32 (8 bf16) z-rows of
                         # a window of up to U columns, twice, in 227 KB
                         # of shared memory
FT = 32                  # film tile edge of bp_fwd's column windows

KERNELS = ("bp_fwd", "bp_bwd", "bp_fwd_band", "bp_bwd_band",
           "bp_fwd_bf16", "bp_bwd_bf16", "bp_fwd_band_bf16",
           "bp_bwd_band_bf16")
launches = {k: 0 for k in KERNELS}


def reset_launches():
    for k in KERNELS:
        launches[k] = 0


def _round_up(x, m):
    return -(-x // m) * m


def round_bf16(x):
    """float32 -> bfloat16 (nearest even) -> float32."""
    return x.to(torch.bfloat16).to(torch.float32)


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


def _tap_ranges(u, U, lo=None):
    """floor(u) and whether each of the two taps is kept: in [0, U), or
    with per-cell band starts lo in [lo, min(lo + BANDW, U)), as _taps
    keeps them."""
    fl = torch.floor(u)
    if lo is None:
        lo, hi = 0, U
    else:
        hi = torch.clamp(lo + BANDW, max=U)
    return fl, (fl >= lo) & (fl < hi), (fl + 1 >= lo) & (fl + 1 < hi)


def band_to_raster(F, u0, Y, X):
    """Banded fields as the dense kernels' layout reads them: raster
    packed fields (A, 2, Y*X) and each cell's band start (A, Y*X)."""
    A = F.shape[0]
    return (block_unpermute(F, Y, X).reshape(A, 2, Y * X),
            block_unpermute(_band_lo(u0), Y, X).reshape(A, Y * X))


def tile_windows(F, U, Y, X, lo=None):
    """Per (angle, FT x FT film tile) the exact column window [lo, hi]
    of the tile's kept taps (see _tap_ranges), as the forward kernels
    stage it: (A, T, 2) int32 with tiles row-major over
    ceil(Y/FT) x ceil(X/FT), lo > hi for a tile without taps; and the
    widest window (0 if none). F is raster. With band starts, every tile
    must lie in one band block (Y % BY == X % BX == 0 makes it so): the
    window then lies inside the band, and a tap outside it is outside
    the band."""
    A = F.shape[0]
    fl, ok0, ok1 = (t.reshape(A, Y, X) for t in _tap_ranges(F[:, 1], U, lo))
    lo = torch.where(ok0, fl, torch.where(ok1, fl + 1, float(U)))
    hi = torch.where(ok1, fl + 1, torch.where(ok0, fl, -1.0))
    ty, tx = -(-Y // FT), -(-X // FT)
    pad = (0, tx * FT - X, 0, ty * FT - Y)
    lo = tnf.pad(lo, pad, value=float(U)).reshape(A, ty, FT, tx, FT)
    hi = tnf.pad(hi, pad, value=-1.0).reshape(A, ty, FT, tx, FT)
    lo, hi = lo.amin((2, 4)), hi.amax((2, 4))
    lo = torch.where(lo > hi, torch.zeros_like(lo), lo)
    win = torch.stack([lo, hi], -1).reshape(A, ty * tx, 2)
    maxw = int((hi - lo + 1).clamp(min=0).max()) if A else 0
    return win.to(torch.int32).contiguous(), maxw


def voxel_lists(F, U, lo=None):
    """Per angle, the voxels with a kept tap (see _tap_ranges), grouped
    by i0 = floor(u) and ordered by voxel inside a group, as the adjoint
    kernels walk them. F is raster. Returns ptr (A * (U + 1) + 1) int32,
    group g = i0 + 1 of angle a starting at ptr[a * (U + 1) + g], and
    ent (nnz, 4) int32 rows (j, i0, w0, w1) with j the raster voxel
    index and the weights' float32 bits; a dropped tap has weight 0, as
    in the plain version."""
    A, _, YX = F.shape
    W, u = F[:, 0], F[:, 1]
    fl, ok0, ok1 = _tap_ranges(u, U, lo)
    f = u - fl
    a, j = torch.nonzero(ok0 | ok1, as_tuple=True)
    if a.numel() >= 2 ** 31:
        raise ValueError(f"{a.numel()} list entries exceed int32 offsets")
    i0 = fl[a, j].to(torch.int64)
    g = a * (U + 1) + i0 + 1
    order = torch.argsort(g * YX + j)  # unique keys: (angle, group, voxel)
    a, j, i0, g = a[order], j[order], i0[order], g[order]
    zero = torch.zeros((), dtype=W.dtype, device=W.device)
    w0 = torch.where(ok0, W * (1.0 - f), zero)[a, j]
    w1 = torch.where(ok1, W * f, zero)[a, j]
    ent = torch.stack([j.to(torch.int32), i0.to(torch.int32),
                       w0.view(torch.int32), w1.view(torch.int32)], 1)
    ptr = torch.searchsorted(
        g, torch.arange(A * (U + 1) + 1, device=F.device))
    return ptr.to(torch.int32).contiguous(), ent.contiguous()


def transpose_dl(dL):
    """Plain version of bp_bwd's first step: dL (Zf, YX) -> (YX, Zp),
    z innermost, rows zero-padded to Zp = Zf rounded up to 4."""
    Zf = dL.shape[0]
    return tnf.pad(dL.t(), (0, _round_up(Zf, 4) - Zf)).contiguous()


class DenseLayout:
    """What the kernels read beside the packed fields F of a Y x X film:
    the forward's per-tile column windows and the adjoint's voxel lists.
    F is raster (A, 2, Y*X), or block-major with band starts u0 (A, T)
    for the banded pair, whose windows and lists are built from the
    band-masked taps (equal to the dense ones where band_span_ok holds).
    Each is built with torch on F's device at first use; the fields are
    fixed for a whole optimization, so an engine builds them once. The
    lists hold at most one 16-byte entry per (angle, voxel): <= 0.42 GB
    at the bench scene (400 angles, 256 x 256 film)."""

    def __init__(self, F, U, Y, X, u0=None):
        if F.shape[2] != Y * X:
            raise ValueError(f"fields of {F.shape[2]} cells for a {Y}x{X} "
                             "film")
        if u0 is not None:
            _check_band("DenseLayout", U, Y, X)
        self.F, self.U, self.Y, self.X, self.u0 = F, U, Y, X, u0

    def _raster(self):
        if self.u0 is None:
            return self.F, None
        return band_to_raster(self.F, self.u0, self.Y, self.X)

    @cached_property
    def windows(self):
        F, lo = self._raster()
        return tile_windows(F, self.U, self.Y, self.X, lo)

    @cached_property
    def lists(self):
        F, lo = self._raster()
        return voxel_lists(F, self.U, lo)

    def build(self):
        """Build both now, outside any timed loop."""
        _ = self.windows, self.lists
        return self

    def check(self, name, F, U, u0=None, film=None):
        if self.F is not F or self.U != U or self.u0 is not u0 or (
                film is not None and film != (self.Y, self.X)):
            raise ValueError(f"{name}: the layout was built for other "
                             "fields")


# --------------------------------------------------------------------------
# plain versions (torch; CPU path and reference on the card)


def _taps(F, U, lo=None, bf16=False):
    """Tap columns (clipped) and weights (masked) of packed fields.
    lo: optional per-cell band start (A, L); taps are kept in
    [lo, min(lo + BANDW, U)) instead of [0, U). bf16: the weights
    rounded to bfloat16, as the bf16 kernels round them."""
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
    if bf16:
        w0, w1 = round_bf16(w0), round_bf16(w1)
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


def _operand(x, bf16):
    return round_bf16(x) if bf16 else x


def fwd_dense_plain(Pz, F, bf16=False):
    """Plain version of the dense forward: take-based, angle by angle
    (the JAX package's _fwd_xla; with bf16, Pz and the weights rounded
    as _fwd_pallas(bf16=True) rounds them)."""
    return _fwd_plain(_operand(Pz, bf16), _taps(F, Pz.shape[2], bf16=bf16))


def bwd_dense_plain(dL, F, U, bf16=False):
    """Plain version of the dense adjoint (_bwd_xla)."""
    return _bwd_plain(_operand(dL, bf16), _taps(F, U, bf16=bf16), U)


def fwd_band_plain(Pz, F, u0, Y, X, bf16=False):
    """Plain version of the banded forward: taps outside each block's
    band are dropped exactly as the kernel drops them."""
    out = _fwd_plain(_operand(Pz, bf16),
                     _taps(F, Pz.shape[2], _band_lo(u0), bf16))
    return block_unpermute(out, Y, X).reshape(Pz.shape[1], Y * X)


def bwd_band_plain(dL, F, u0, U, Y, X, bf16=False):
    """Plain version of the banded adjoint; dL is (Zf, Y*X) raster."""
    dLb = block_permute(dL.reshape(-1, Y, X), Y, X).reshape(dL.shape[0], -1)
    return _bwd_plain(_operand(dLb, bf16), _taps(F, U, _band_lo(u0), bf16),
                      U)


# --------------------------------------------------------------------------
# CUDA kernels


def _setup(lib, name, n_ptr, n_int):
    fn = getattr(lib, name)
    fn.argtypes = [ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int + \
        [ctypes.c_void_p]
    fn.restype = ctypes.c_int


# (pointer, int) argument counts: the bf16 forwards take a scratch
# pointer more than the float32 ones
_ARGS = {"bp_fwd": (4, 6), "bp_bwd": (5, 4), "bp_fwd_band": (4, 6),
         "bp_bwd_band": (5, 4), "bp_fwd_bf16": (5, 6), "bp_bwd_bf16": (5, 4),
         "bp_fwd_band_bf16": (5, 6), "bp_bwd_band_bf16": (5, 4)}
_SETUP = {k: (lambda lib, k=k: _setup(lib, k, *_ARGS[k])) for k in KERNELS}


def build_kernels():
    """Build (nvcc, one process per source, in parallel) and load all
    eight kernels. Returns {name: ctypes lib}; raises on any failure."""
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


def _launch_fwd(name, dev, Pz, F, layout, bf16):
    """The windowed forward (csrc/bp_fwd_kernel.cuh) on its layout; the
    bf16 form first rounds Pz into a scratch copy (A, U, Zp), z
    innermost, Zp = Zf rounded up to 8."""
    A, Zf, U = Pz.shape
    win, maxw = layout.windows
    out = torch.empty((Zf, F.shape[2]), dtype=torch.float32, device=dev)
    ptrs = (Pz.data_ptr(), F.data_ptr(), win.data_ptr())
    if bf16:
        Pt = torch.empty((A, U, _round_up(Zf, 8)), dtype=torch.bfloat16,
                         device=dev)
        ptrs += (Pt.data_ptr(),)
    _launch(name, dev, ptrs + (out.data_ptr(), A, Zf, U, layout.Y,
                               layout.X, maxw))
    return out


def _launch_bwd(name, dev, dL, A, U, layout, bf16):
    """The gather adjoint (csrc/bp_bwd_kernel.cuh) on its layout. Every
    output element is written, so the output is not zeroed. dL is
    re-laid out into scratch (YX, Zp), Zp = Zf rounded up to 4, in the
    operand's type."""
    Zf, YX = dL.shape
    ptr, ent = layout.lists
    dLt = torch.empty((YX, _round_up(Zf, 4)),
                      dtype=torch.bfloat16 if bf16 else torch.float32,
                      device=dev)
    out = torch.empty((A, Zf, U), dtype=torch.float32, device=dev)
    _launch(name, dev, (dL.data_ptr(), ptr.data_ptr(), ent.data_ptr(),
                        dLt.data_ptr(), out.data_ptr(), A, Zf, U, YX))
    return out


def _kernel(name, bf16):
    return name + "_bf16" if bf16 else name


def fwd_dense(Pz, F, layout=None, bf16=False):
    """dose (Zf, YX) = sum_a Pz_a @ B_a. Pz (A, Zf, U), F (A, 2, YX);
    layout: the fields' DenseLayout (built here, for a one-row film, if
    not given); bf16: the bf16 operand form (bp_fwd_bf16).

    CUDA kernel csrc/bp_fwd.cu; replaces drtvam_tpu/ops/backproject.py
    _fwd_pallas (:187). The work is 2 FMAs per (angle, tap-carrying
    voxel, z): at the bench shapes 18.8 GFLOP against 0.44 GB of
    compulsory traffic, so the float32 FMA rate bounds it; what holds
    it back on the H100 is feeding each FMA its Pz value. A block owns a
    32x32 film tile x a z-chunk and loops over the angles, staging only
    the tile's exact column window of Pz, z innermost (one 16-byte
    shared load per tap and four z-rows), double-buffered with cp.async;
    the grid runs one z-chunk's tiles first so Pz's z-slab stays in L2.
    Registers accumulate, each output is written once, no atomics.

    bp_fwd_bf16 (csrc/bp_fwd_bf16.cu) replaces _fwd_pallas(bf16=True):
    the same template on a bf16 copy of Pz laid out (A, U, Zp), z
    innermost, so a 16-byte shared load gives a tap eight z-rows."""
    A, Zf, U = Pz.shape
    YX = F.shape[2]
    name = _kernel("bp_fwd", bf16)
    dev = _check(name, (Pz, F), (torch.float32,) * 2,
                 ((A, Zf, U), (A, 2, YX)))
    if dev.type == "cpu":
        return fwd_dense_plain(Pz, F, bf16)
    if U > MAX_DENSE_U:
        raise ValueError(f"{name}: U = {U} exceeds {MAX_DENSE_U}, the "
                         "widest column window the kernel stages")
    if layout is None:
        layout = DenseLayout(F, U, 1, YX)
    layout.check(name, F, U)
    return _launch_fwd(name, dev, Pz, F, layout, bf16)


def bwd_dense(dL, F, U, layout=None, bf16=False):
    """Pzbar (A, Zf, U) = dL @ B_a^T. dL (Zf, YX), F (A, 2, YX);
    layout: the fields' DenseLayout (built here if not given); bf16: the
    bf16 operand form (bp_bwd_bf16).

    CUDA kernel csrc/bp_bwd.cu; replaces _bwd_pallas (:221). The same
    18.8 GFLOP as the forward at the bench shapes, bound by the FMA rate;
    a scatter form is held back by contended atomics, so this one is in
    gather form and is held back by reading each voxel's dL line once
    per angle through L2. dL is re-laid out z innermost (YX, Zp); a warp
    owns (angle, 16 columns, 128 z-rows) and walks the layout's voxel
    lists (voxels grouped by floor(u)), reading each voxel's dL line
    once into two register accumulators for its two adjacent columns;
    the grid runs one z-chunk first so the dL slab stays in L2. No
    atomics: every output is written once, in a fixed order, so the
    result is bitwise reproducible.

    bp_bwd_bf16 (csrc/bp_bwd_bf16.cu) replaces _bwd_pallas(bf16=True):
    the same gather, dL rounded to bf16 as it is re-laid out (a 128-row
    line is 256 bytes) and each entry's weights rounded as they load."""
    Zf, YX = dL.shape
    A = F.shape[0]
    name = _kernel("bp_bwd", bf16)
    dev = _check(name, (dL, F), (torch.float32,) * 2,
                 ((Zf, YX), (A, 2, YX)))
    if dev.type == "cpu":
        return bwd_dense_plain(dL, F, U, bf16)
    if layout is None:
        layout = DenseLayout(F, U, 1, YX)
    layout.check(name, F, U)
    return _launch_bwd(name, dev, dL, A, U, layout, bf16)


def _check_band(name, U, Y, X):
    if Y % BY or X % BX:
        raise ValueError(f"{name}: film {Y}x{X} does not tile into "
                         f"{BY}x{BX} blocks")
    if _round_up(U, 128) < BANDW:
        raise ValueError(f"{name}: U = {U} is narrower than the band")


def fwd_band(Pz, F, u0, Y, X, layout=None, bf16=False):
    """Banded forward: dose (Zf, Y*X) raster. F (A, 2, T*TILE_B)
    block-major, u0 (A, T) int32 band starts; layout: the fields'
    DenseLayout (built here if not given); bf16: the bf16 operand form
    (bp_fwd_band_bf16, replacing _fwd_banded(bf16=True)).

    CUDA kernel csrc/bp_fwd_band.cu; replaces _fwd_banded (:362). Same
    work and bound as fwd_dense: 2 FMAs per (angle, in-band tap, z), the
    float32 FMA rate. On the TPU the band is a staging width (B_a built
    densely in VMEM over 256 rows); on Hopper it is a mask on the layout:
    the column window of each (angle, 32x32 tile) is built from the
    band-masked taps, and each tile lies in one 32x64 block, so bp_fwd's
    windowed kernel, reading the block-major fields in place, keeps
    exactly the in-band taps. A window is at most BANDW columns."""
    A, Zf, U = Pz.shape
    name = _kernel("bp_fwd_band", bf16)
    _check_band(name, U, Y, X)
    T = (Y // BY) * (X // BX)
    dev = _check(name, (Pz, F, u0),
                 (torch.float32, torch.float32, torch.int32),
                 ((A, Zf, U), (A, 2, T * TILE_B), (A, T)))
    if dev.type == "cpu":
        return fwd_band_plain(Pz, F, u0, Y, X, bf16)
    if layout is None:
        layout = DenseLayout(F, U, Y, X, u0)
    layout.check(name, F, U, u0, (Y, X))
    return _launch_fwd(name, dev, Pz, F, layout, bf16)


def bwd_band(dL, F, u0, U, Y, X, layout=None, bf16=False):
    """Banded adjoint: Pzbar (A, Zf, U) from raster dL (Zf, Y*X); layout
    as for fwd_band; bf16: the bf16 operand form (bp_bwd_band_bf16,
    replacing _bwd_banded(bf16=True)).

    CUDA kernel csrc/bp_bwd_band.cu; replaces _bwd_banded (:426). Same
    work and bound as bwd_dense, held back by reading each voxel's dL
    line once per angle through L2. On Hopper the band is a mask on the
    layout: the voxel lists hold the band-masked taps with raster voxel
    indices, and bp_bwd's gather walks them. No atomics: every output is
    written once, in a fixed order, so the result is bitwise
    reproducible and the output is not zeroed first."""
    Zf = dL.shape[0]
    A = F.shape[0]
    name = _kernel("bp_bwd_band", bf16)
    _check_band(name, U, Y, X)
    T = (Y // BY) * (X // BX)
    dev = _check(name, (dL, F, u0),
                 (torch.float32, torch.float32, torch.int32),
                 ((Zf, Y * X), (A, 2, T * TILE_B), (A, T)))
    if dev.type == "cpu":
        return bwd_band_plain(dL, F, u0, U, Y, X, bf16)
    if layout is None:
        layout = DenseLayout(F, U, Y, X, u0)
    layout.check(name, F, U, u0, (Y, X))
    return _launch_bwd(name, dev, dL, A, U, layout, bf16)


# --------------------------------------------------------------------------
# packed fields + differentiable entry


class PackedFields:
    """The (W, u) transport fields of one scene, packed once for the
    kernels in the dense or the banded layout; one copy on the device.

    W, Umap: (A, Y, X) float32 tensors on the target device; U: DMD
    columns. banded=True needs banded_eligible and band_span_ok. bf16:
    forward and adjoint both run the bf16 operand form, so the adjoint
    stays the one the JAX package's custom_vjp pairs with the forward.
    The fields stay float32 either way. Fields on the card also build
    their DenseLayout here, once; both precisions read it."""

    def __init__(self, W, Umap, U, banded, bf16=False):
        A, Y, X = W.shape
        self.A, self.Y, self.X, self.U = A, Y, X, U
        self.banded = bool(banded)
        self.bf16 = bool(bf16)
        self.layout = None
        if self.banded:
            self.F, self.u0 = _pack_fields_banded(W, Umap, U)
        else:
            self.F, self.u0 = _pack_fields(W, Umap), None
        if self.F.is_cuda:
            self.layout = DenseLayout(self.F, U, Y, X, self.u0).build()

    def forward(self, Pz):
        """(A, Zf, U) -> dose (Zf, Y*X)."""
        Pz = Pz.contiguous()
        if self.banded:
            return fwd_band(Pz, self.F, self.u0, self.Y, self.X,
                            self.layout, self.bf16)
        return fwd_dense(Pz, self.F, self.layout, self.bf16)

    def adjoint(self, dL):
        """(Zf, Y*X) -> Pzbar (A, Zf, U)."""
        dL = dL.contiguous()
        if self.banded:
            return bwd_band(dL, self.F, self.u0, self.U, self.Y, self.X,
                            self.layout, self.bf16)
        return bwd_dense(dL, self.F, self.U, self.layout, self.bf16)


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
