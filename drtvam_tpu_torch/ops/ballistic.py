"""Ballistic engine: transport-field precompute + backprojection, with
the exact adjoint for pattern gradients (counterpart of
drtvam_tpu/ops/ballistic.py).

For a collimated projector orbiting a z-invariant vial the dose factors
into per-angle 2D transport fields (ops/transport2d.py) and a
z-resample of each pattern's rows onto the film's z-rows. The engine
builds the fields once (host C++), packs them once on its device and
then renders with the backprojection kernels (ops/backproject.py).

Kernel choice (`impl`), made once per engine, as the JAX package's
`impl` ('xla' | 'pallas' | 'pallas_bf16' | 'pallas_band' |
'pallas_band_bf16') makes it. The port's names are '<route>[_band]
[_bf16]': route 'cuda' (the kernels, on a CUDA device) or 'plain' (the
plain versions, on the CPU); '_band' the banded pair, else the dense
one; '_bf16' the bf16 operand form, else float32. The default is
'plain' on the CPU (the JAX package takes 'xla' there) and on a CUDA
device 'cuda', or 'cuda_bf16' when the environment has
DRTVAM_MATMUL=bf16 (any other value means float32, as in the JAX
package's _default_impl). A dense choice other than 'plain' becomes the
banded one when the film tiles into 32x64 blocks and every block's
u-span fits the band, as 'pallas' and 'pallas_bf16' do there. Fields
stay float32.

A surface-aware film (2 channels) splits the dose by the target's
voxelized inside-mask M, elementwise outside the kernels: the forward
is [dose * M, dose * (1 - M)] and the adjoint's dose cotangent
dL0 * M + dL1 * (1 - M), so both channels cost one backprojection (the
JAX package's split, drtvam_tpu/ops/ballistic.py:320-362). inv_vol is
then the (Z, Y, X, 2) tensor of inverse fractional volumes.

An engine that parallel/shard.py `shard_ballistic_engine` has sharded
holds its rank's block of the angles (`shard`, the JAX package's hooks
at drtvam_tpu/ops/ballistic.py:233-235, :338-341, :366-368): it
backprojects those angles' patterns and sums the dose over the ranks,
and writes its angles' adjoint into the full pattern vector, summed over
the ranks too.
"""
from __future__ import annotations

import dataclasses
import os
import re

import numpy as np
import torch

from .backproject import PackedFields, backproject, banded_eligible, \
    band_span_ok
from .march import MarchStatic
from .transport2d import build_transport, build_z_resample, \
    ballistic_eligible, strip_target, unscattered_eligible
from ..utils.spans import span

__all__ = ["BallisticEngine", "ballistic_eligible", "default_impl",
           "radon_active_ballistic"]


def default_impl(device):
    """The kernel choice for `device` when the caller names none."""
    if torch.device(device).type != "cuda":
        return "plain"
    if os.environ.get("DRTVAM_MATMUL", "f32") == "bf16":
        return "cuda_bf16"
    return "cuda"


class BallisticEngine:
    """Per-(scene, sensor) engine on one device. Construction rasterizes
    the 2D ray fan (host, once); `render_vol` and `pattern_grad` are
    functions of the sparse pattern vector on that device."""

    _MAX_TAPS = 4

    def __init__(self, static: MarchStatic, arr, device, impl=None,
                 unscattered=False, inside_mask=None):
        """unscattered: the engine is the unscattered transport of a
        scattering scene (the hybrid engine's analytic part,
        ops/hybrid.py): only the geometry must be precomputable; the
        rasterizer folds the medium's sigma_t and 1 - albedo into W.
        inside_mask: the target's (Z, Y, X[, 1]) binary occupancy in the
        sensor's grid, which a surface-aware film needs (ignored
        otherwise, as in the JAX package)."""
        if unscattered:
            if not unscattered_eligible(static):
                raise ValueError("scene geometry not precomputable as 2D "
                                 "transport fields")
        elif not ballistic_eligible(static):
            raise ValueError("scene not ballistic-eligible")
        self.static = static
        self.device = torch.device(device)
        self.mask = None
        if static.sensor.surface_aware:
            if inside_mask is None:
                raise ValueError("surface-aware ballistic engine needs the "
                                 "inside mask")
            X, Y, Z = static.sensor.res
            with span("upload"):
                self.mask = torch.as_tensor(np.asarray(
                    inside_mask, np.float32).reshape(Z, Y, X)).to(self.device)
        p = static.projector
        self.shape_dense = (p.n_patterns, p.resy, p.resx)
        U = p.resx

        static2, arr2 = strip_target(static, arr)
        Wn, UWn = build_transport(static2, arr2)
        with span("layout"):
            with np.errstate(divide="ignore", invalid="ignore"):
                Un = np.where(Wn > 0, UWn / np.maximum(Wn, 1e-30),
                              np.float32(-2.0)).astype(np.float32)
            # host copies for the tests and the band check; the device
            # holds one packed copy
            self.W_host, self.U_host = Wn, Un
            self.impl = self._choose(impl or default_impl(self.device), Wn,
                                     Un, U)
        with span("upload"):
            W_d = torch.from_numpy(Wn).to(self.device)
            U_d = torch.from_numpy(Un).to(self.device)
        with span("pack", timed=False):
            self.fields = PackedFields(W_d, U_d, U, "_band" in self.impl,
                                       self.impl.endswith("_bf16"))
        del W_d, U_d

        with span("z_taps"):
            self._build_z_taps(build_z_resample(static, arr))
        ps = np.asarray(arr["pixel_size"])
        # ray weight pixel_area * print_time (spp = 1); 1/voxel_volume is
        # applied by the caller through inv_vol
        self.scalar = float(np.float32(float(ps[0]) * float(ps[1]) *
                                       float(np.asarray(arr["print_time"]))))
        with span("pixels"):
            ap = np.asarray(arr["active_pixels"])
            n_dense = int(np.prod(self.shape_dense))
            self.identity_pixels = bool(ap.shape[0] == n_dense and
                                        ap[0] == 0 and
                                        np.all(np.diff(ap) == 1))
            self.n_active = int(ap.shape[0])
            self.active_pixels = None if self.identity_pixels else \
                torch.from_numpy(ap.astype(np.int64)).to(self.device)
        # the rank's block of the angles (parallel/shard.py AngleShard);
        # None: every angle, one process
        self.shard = None

    def _choose(self, impl, Wn, Un, U):
        m = re.fullmatch(r"(plain|cuda)(_band)?(_bf16)?", impl)
        if m is None:
            raise ValueError(f"unknown ballistic impl '{impl}': expected "
                             "'plain' or 'cuda', with '_band' and/or "
                             "'_bf16'")
        route, band, bf16 = m.group(1), m.group(2), m.group(3) or ""
        if (route == "cuda") != (self.device.type == "cuda"):
            raise ValueError(f"impl '{impl}' does not run on "
                             f"{self.device}: 'cuda...' needs a CUDA "
                             "device, 'plain...' the CPU")
        if impl == "plain":  # the reference: never banded
            return impl
        fits = banded_eligible(Wn.shape, U) and band_span_ok(
            torch.from_numpy(Wn), torch.from_numpy(Un), U)
        if band and not fits:
            raise ValueError(f"impl '{impl}': the fields do not fit the "
                             "band (banded_eligible, band_span_ok)")
        return route + ("_band" if fits else "") + bf16

    # -- z-resample as K-tap gathers ---------------------------------------

    def _build_z_taps(self, Szn):
        """Fixed-K tap tables of the (Zf, resy) binning matrix, both
        directions. It has <= ~3 nonzeros per row and per column, so K
        weighted gathers replace a dense contraction; a matrix with more
        taps (DMD rows much finer than the film) is contracted densely."""
        Z, R = Szn.shape
        K = self._MAX_TAPS
        dev = self.device
        if (np.count_nonzero(Szn, axis=1).max() > K or
                np.count_nonzero(Szn, axis=0).max() > K):
            self.z_taps = None
            self.Sz = torch.from_numpy(Szn).to(dev)
            return
        zt_i = np.zeros((Z, K), np.int64)
        zt_w = np.zeros((Z, K), np.float32)
        for z in range(Z):
            nz = np.nonzero(Szn[z])[0]
            zt_i[z, :nz.size] = nz
            zt_w[z, :nz.size] = Szn[z, nz]
        rt_i = np.zeros((R, K), np.int64)
        rt_w = np.zeros((R, K), np.float32)
        for r in range(R):
            nz = np.nonzero(Szn[:, r])[0]
            rt_i[r, :nz.size] = nz
            rt_w[r, :nz.size] = Szn[nz, r]
        self.z_taps = tuple(torch.from_numpy(t).to(dev)
                            for t in (zt_i, zt_w, rt_i, rt_w))

    @span("resample", timed=False)
    def _resample_fwd(self, P):
        """(A, resy, U) patterns -> (A, Zf, U)."""
        if self.z_taps is None:
            return torch.einsum("zr,aru->azu", self.Sz, P)
        return self._tap_contract(P, self.z_taps[0], self.z_taps[1])

    @span("resample", timed=False)
    def _resample_bwd(self, Pz_bar):
        """(A, Zf, U) -> (A, resy, U), the transpose of _resample_fwd."""
        if self.z_taps is None:
            return torch.einsum("zr,azu->aru", self.Sz, Pz_bar)
        return self._tap_contract(Pz_bar, self.z_taps[2], self.z_taps[3])

    @staticmethod
    def _tap_contract(x, idx, w):
        """sum_k w[:, k] * x[:, idx[:, k], :] along the middle axis."""
        out = None
        for k in range(idx.shape[1]):
            term = x.index_select(1, idx[:, k]) * w[None, :, k, None]
            out = term if out is None else out + term
        return out

    # -- differentiable forward -------------------------------------------

    def dense_patterns(self, active_data):
        """Sparse pattern vector -> dense (n, resy, resx) stack."""
        n, ry, rx = self.shape_dense
        if self.identity_pixels:
            return active_data.reshape(n, ry, rx)
        flat = torch.zeros((n * ry * rx,), dtype=torch.float32,
                           device=active_data.device)
        flat = flat.index_put((self.active_pixels,), active_data)
        return flat.reshape(n, ry, rx)

    def render_vol(self, active_data, inv_vol):
        """(Z, Y, X, C) dose volume; differentiable w.r.t. active_data
        (the backward runs the adjoint kernel)."""
        sh = self.shard
        if sh is not None:
            active_data = sh.replicated(active_data)
        P = self.dense_patterns(active_data)
        if sh is not None:
            P = P[sh.lo:sh.hi]
        dose = backproject(self._resample_fwd(P), self.fields)
        if sh is not None:
            dose = sh.summed(dose)
        X, Y, Z = self.static.sensor.res
        dose = dose.reshape(Z, Y, X) * self.scalar
        if self.mask is None:
            return dose[..., None] * inv_vol
        return torch.stack([dose * self.mask, dose * (1.0 - self.mask)],
                           -1) * inv_vol

    # -- explicit adjoint ----------------------------------------------------

    def pattern_grad(self, dvol, inv_vol):
        """d loss / d active_data given d loss / d vol (Z, Y, X, C)."""
        X, Y, Z = self.static.sensor.res
        dvol = dvol * inv_vol
        if self.mask is None:
            dL = dvol[..., 0]
        else:
            dL = dvol[..., 0] * self.mask + dvol[..., 1] * (1.0 - self.mask)
        dL = (dL * self.scalar).reshape(Z, Y * X)
        Pbar = self._resample_bwd(self.fields.adjoint(dL))
        sh = self.shard
        if sh is not None:
            Pbar = sh.full(Pbar, self.shape_dense[0])
        Pbar = Pbar.reshape(-1)
        g = Pbar if self.identity_pixels else Pbar[self.active_pixels]
        return g if sh is None else sh.sum(g)


def radon_active_ballistic(static: MarchStatic, arr, target_mask,
                           device="cuda"):
    """Radon culling of a transport-eligible scene (counterpart of
    drtvam_tpu/ops/ballistic.py:377-409): the DMD pixels whose
    unscattered, refracted path crosses the target occupancy, found by
    one adjoint of the unscattered engine (`pattern_grad`, one
    backprojection adjoint launch on the card) on the binary mask. The
    reference's radon render keeps the same pixels: its in-target
    absorption is nonzero exactly on the support of the transport field
    W.

    target_mask: (Z, Y, X) or (Z, Y, X, 1) binary occupancy on the
    sensor grid. Returns int32 numpy DENSE flat (pattern, row, column)
    indices of the pixels to keep, mapped back through the sparse store
    when the projector already has an active subset. A surface-aware
    sensor is culled as a one-channel one of the same grid."""
    static = dataclasses.replace(static, sensor=dataclasses.replace(
        static.sensor, surface_aware=False))
    eng = BallisticEngine(static, arr, device, unscattered=True)
    X, Y, Z = static.sensor.res
    with span("upload"):
        mask = torch.as_tensor(np.asarray(target_mask, np.float32).reshape(
            Z, Y, X, 1)).to(eng.device)
    with span("cull_adjoint"), torch.no_grad():
        g = eng.pattern_grad(mask, 1.0).cpu().numpy()
        idx = np.nonzero(g > 0.0)[0]
        if not eng.identity_pixels:
            idx = eng.active_pixels.cpu().numpy()[idx]
        return idx.astype(np.int32)
