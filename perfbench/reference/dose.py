"""The plain reference's dose volume and thresholded loss.

`Reference` holds one cell's fan fields (reference/transport.py),
traced in float64, and its z-resampling, built once per run from the
configuration; `dose(P)` renders a dense
(n_patterns, resy, resx) pattern stack into the film's (Z, Y, X) dose:

    dose = s / v  sum_a  W_a * Pz_a(u_a)

with Pz_a the pattern's rows resampled onto the film's z rows, read at
column u_a by linear interpolation (columns outside the DMD read 0),
s = pixel area * exposure time and v the voxel volume. float64, in
blocks of angles. `precision="bf16"` computes the same with the
resampled patterns and the interpolation weights W (1 - f), W f rounded
to bfloat16 and float32 sums: the lower-precision control.

`loss` is the thresholded dose objective (Wechsler et al. 2024) with
the traffic file's parameters, summed over the voxels.
"""
from __future__ import annotations

import numpy as np
import torch

from .transport import fan_fields, z_resample


class Reference:
    def __init__(self, cfg, film, device):
        self.device = torch.device(device)
        proj = cfg["projector"]
        ps = proj["pixel_size"]
        psx, psy = (float(ps), float(ps)) if np.isscalar(ps) else \
            (float(ps[0]), float(ps[1]))
        X, Y, Z = film["res"]
        size = np.asarray(film["bbox_max"], np.float64) - \
            np.asarray(film["bbox_min"], np.float64)
        self.scale = psx * psy * float(cfg.get("time", 1.0)) / \
            float(np.prod(size / np.array([X, Y, Z], np.float64)))
        self.res = (X, Y, Z)
        self.U = int(proj["resx"])
        self.W, self.I0, self.F, self.span = self._fields(cfg, film)
        self.Sz = torch.from_numpy(z_resample(cfg, film)).to(self.device)

    def _fields(self, cfg, film):
        X, Y, _ = self.res
        W, UW, span = fan_fields(cfg, film, self.device)
        A = W.shape[0]
        W = W.reshape(A, Y * X)
        UW = UW.reshape(A, Y * X)
        u = torch.where(W > 0, UW / torch.clamp(W, min=1e-300),
                        torch.full_like(W, -2.0))
        i0 = torch.floor(u)
        return W, i0.long(), u - i0, span.reshape(A, Y * X).float()

    def taps(self):
        """Cells lit per angle, two interpolation taps each: the
        backprojection's work, counted from the geometry."""
        return 2 * int(torch.count_nonzero(self.W))

    def dose(self, patterns, precision="float64", block=4):
        """The (Z, Y, X) float64 dose of a dense pattern stack, computed
        in `precision`."""
        X, Y, Z = self.res
        W, I0, F = self.W, self.I0, self.F
        U = self.U
        P = torch.as_tensor(np.asarray(patterns), device=self.device)
        lo_p = precision == "bf16"
        dt = torch.float32 if lo_p else torch.float64
        Pz = torch.einsum("zr,aru->azu", self.Sz.to(dt), P.to(dt))
        if lo_p:
            Pz = Pz.to(torch.bfloat16).to(torch.float32)
        out = torch.zeros((Z, Y * X), dtype=dt, device=self.device)
        A = Pz.shape[0]
        for a0 in range(0, A, block):
            a1 = min(a0 + block, A)
            Wb, fb, ib = W[a0:a1], F[a0:a1], I0[a0:a1]
            acc = None
            for idx, w in ((ib, Wb * (1.0 - fb)), (ib + 1, Wb * fb)):
                ok = (idx >= 0) & (idx < U)
                w = torch.where(ok, w, torch.zeros_like(w)).to(dt)
                if lo_p:
                    w = w.to(torch.bfloat16).to(torch.float32)
                g = torch.gather(Pz[a0:a1], 2, torch.clamp(idx, 0, U - 1)
                                 [:, None, :].expand(-1, Z, -1))
                term = (g * w[:, None, :]).sum(0)
                acc = term if acc is None else acc + term
            out += acc
        return (out * self.scale).reshape(Z, Y, X).to(torch.float64)


def loss(dose, occupied, params):
    """Thresholded objective of a (Z, Y, X) dose against a bool
    occupancy: w_obj max(tu - d, 0)^K + w_lim max(d - 1, 0)^K on the
    object, w_void max(d - tl, 0)^K on the void, summed (float64)."""
    if params.get("weight_sparsity", 0):
        raise ValueError("the reference has no pattern sparsity term")
    d = torch.as_tensor(dose, dtype=torch.float64)
    occ = occupied if torch.is_tensor(occupied) else \
        torch.as_tensor(np.ascontiguousarray(occupied))
    occ = occ.to(d.device)
    K = float(params["K"])
    obj = params["weight_object"] * torch.clamp(params["tu"] - d, min=0) ** K \
        + params["weight_limit"] * torch.clamp(d - 1.0, min=0) ** K
    void = params["weight_void"] * torch.clamp(d - params["tl"], min=0) ** K
    return float(torch.where(occ, obj, void).sum())
