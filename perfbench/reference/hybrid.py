"""The comparison of a scattering job on the hybrid engine with a
surface-aware film and the radon cull, for each optimization compared:

- `target_mismatch`: the voxels of the surface-aware film's inside /
  outside volumes (`target.npy`) whose inside share differs from the
  phantom's, counted in the schema's 4 x 4 subcolumns and the prism's
  z overlap, outside the rounding band of the mesh's edges and caps
  (limit 0: exact);
- `cull_mismatch`: how far the number of DMD pixels the loop optimized
  (`active_pixels`) lies outside the reference's cull, the pixels whose
  unscattered light reaches a target column of the film through the
  refracted fan's two interpolation taps (taken without and with the
  ties: `cull`), plus the final patterns' lit pixels outside it (limit
  0: exact);
- `residual_sum_gap`: the final dose less the float64 reference's
  unscattered dose of the final patterns (reference/dose.py), summed
  over the film, against the reference's Monte-Carlo scattered dose
  (reference/residual.py): |ratio - 1|;
- `block_gap`: the widest gap, over blocks of `block`^3 voxels, between
  that difference and the reference's scattered dose, over the largest
  block of unscattered dose;
- `residual_noise`: the root mean square of that difference's second
  difference along z, over the resin's voxels, over the largest
  unscattered dose: the final render's sampling noise (the scattered
  dose is smooth over three voxels, the unscattered one removed);
- `residual_peak`: the largest second difference in the whole film
  (outside the resin both doses are nought), over the largest
  unscattered dose: a voxel the render got wrong;
- `final_loss_ratio`: the thresholded loss of the reference's dose of
  the final patterns (unscattered, plus the scattered blocks spread
  trilinearly) against the phantom's binary occupancy on the final
  sensor, over its loss at zero: the patterns reached solve the problem.
"""
from __future__ import annotations

import zlib

import numpy as np
import torch
import torch.nn.functional as F

from . import occupancy
from .dose import Reference, loss
from .residual import Residual, resin_region
from ..harness.iou import best_iou

NAMES = ("target_mismatch", "cull_mismatch", "residual_sum_gap", "block_gap",
         "residual_noise", "residual_peak", "final_loss_ratio")
TIE = 1e-4      # mm: a column centre this near an edge is a tie
U_TIE = 0.02    # a cell's u is known to this share of its columns' spread
W_TIE = 1e-3    # a cell's light below this share of the largest is a tie


def _ratio(num, den):
    """num / den; infinite where the reference's dose is nought (no light
    reached the film: no sound run ends so)."""
    return num / den if den > 0.0 else float("inf")


class Check:
    NAMES = NAMES

    def __init__(self, cell, device, params):
        self.cfg = cell.program_config()
        self.device = torch.device(device)
        self.film = occupancy.film_of(self.cfg.get("final_sensor",
                                                   self.cfg["sensor"]))
        self.sa_film = occupancy.film_of(self.cfg["sensor"])
        if any(not np.array_equal(self.sa_film[k], self.film[k])
               for k in self.film):
            raise ValueError("the loop's film and the final one differ")
        self.size = float(self.cfg["target"].get("size", 1.0))
        self.loss_params = cell.traffic["optimize"]["loss"]
        self.p = dict(params)
        self.ref = Reference(self.cfg, self.film, device)
        self.res = Residual(self.cfg, self.film, device, self.p["block"])
        self._resin = None

    def occupied(self, pose):
        return np.ascontiguousarray(occupancy.occupancy(pose.rings(self.size),
                                                        self.film))

    def resin(self):
        """(Y, X) bool: film columns inside the resin."""
        if self._resin is None:
            kind, prm, _ = resin_region(self.cfg["vial"])
            xs = occupancy.centres(self.film["bbox_min"][0],
                                   self.film["bbox_max"][0],
                                   self.film["res"][0])
            ys = occupancy.centres(self.film["bbox_min"][1],
                                   self.film["bbox_max"][1],
                                   self.film["res"][1])
            py, px = np.meshgrid(ys, xs, indexing="ij")
            if kind == "box":
                m = (np.abs(px) < prm[0]) & (np.abs(py) < prm[1])
            else:
                m = px * px + py * py < prm[0] ** 2
            self._resin = m
        return self._resin

    def cull(self, pose):
        """(lo, hi) (A, U) bool: the (pattern, column) pairs whose light
        reaches a target column through a cell's two interpolation taps,
        without and with the ties. A cell's mean column u is known to
        U_TIE of the spread of the columns crossing it (the program's
        float32 fan weighs a cell's rays up to 0.8 % apart from the
        float64 one: square vial, 400 angles), so a tap is certain only
        where u keeps its side of the whole number within that, and
        possible for any u within it; a cell's light is certain above
        W_TIE of the largest, a column's place in the target beyond TIE
        of the outline's edges."""
        rings, edges = pose.rings(self.size), pose.edges(self.size)
        lo_c, hi_c = occupancy.subcolumn_counts(rings, edges, self.film,
                                                oversample=1, tie=TIE)
        W, I0, Fr = self.ref.W, self.ref.I0, self.ref.F
        A, U = W.shape[0], self.ref.U
        delta = U_TIE * torch.clamp(self.ref.span.double(), min=1.0)
        w_min = W_TIE * float(W.max())
        a = torch.arange(A, device=W.device)[:, None].expand_as(W)
        out = []
        for cols, strict in ((lo_c, True), (hi_c, False)):
            m = torch.as_tensor(cols.reshape(-1) > 0, device=W.device)
            lit = (W > (w_min if strict else 0.0)) & m[None, :]
            keep = torch.zeros(A * U, dtype=torch.bool, device=W.device)
            if strict:
                taps = ((I0, lit & (1.0 - Fr > delta)),
                        (I0 + 1, lit & (Fr > delta)))
            else:
                u = I0.to(torch.float64) + Fr
                lo = torch.floor(u - delta).long()
                hi = torch.floor(u + delta).long() + 1
                n = int((hi - lo)[lit].max()) + 1 if bool(lit.any()) else 0
                taps = tuple((lo + k, lit & (lo + k <= hi))
                             for k in range(n))
            for col, ok in taps:
                ok = ok & (col >= 0) & (col < U)
                keep[a[ok] * U + col[ok]] = True
            out.append(keep.view(A, U))
        return out

    def numbers(self, s):
        rings, edges = s.pose.rings(self.size), s.pose.edges(self.size)
        zs = s.pose.normalized(self.size)[:, 2].astype(np.float64)
        mism = occupancy.compare_fractions(s.target, rings, edges,
                                           (zs.min(), zs.max()),
                                           self.sa_film, tie=TIE)
        # the cull: every DMD row whose light reaches the film's rows
        rows = (self.ref.Sz.sum(0) > 0)
        lo, hi = self.cull(s.pose)
        n_rows = int(rows.sum())
        n_lo, n_hi = int(lo.sum()) * n_rows, int(hi.sum()) * n_rows
        n_prog = int(s.timings["active_pixels"])
        P = torch.as_tensor(s.patterns, device=self.device)
        allowed = hi[:, None, :] & rows[None, :, None]
        outside = int(((P > 0) & ~allowed).sum())
        cull = max(0, n_lo - n_prog) + max(0, n_prog - n_hi) + outside
        del P, allowed

        X, Y, Z = self.film["res"]
        b = self.p["block"]
        dB = self.ref.dose(s.patterns)
        seed = zlib.crc32(np.ascontiguousarray(s.patterns[:, ::7, ::7])
                          .tobytes())
        Rb = self.res.blocks(s.patterns, int(self.p["photons"]),
                             int(self.p["events"]), int(self.p["points"]),
                             seed)
        prog = torch.as_tensor(s.vol.reshape(Z, Y, X),
                               device=dB.device).to(torch.float64)
        r = prog - dB
        del prog

        def bsum(v):
            return v.reshape(Z // b, b, Y // b, b, X // b, b).sum((1, 3, 5))
        sum_gap = abs(_ratio(float(r.sum()), float(Rb.sum())) - 1.0)
        block_gap = _ratio(float((bsum(r) - Rb).abs().max()),
                           float(bsum(dB).max()))
        top = float(dB.max())
        resin = torch.as_tensor(self.resin(), device=r.device)
        d2 = r[2:] - 2.0 * r[1:-1] + r[:-2]
        peak = _ratio(float(d2.abs().max()), top)
        noise = _ratio(float(torch.sqrt((d2[:, resin] ** 2).mean())), top)
        del r, d2
        # the scattered blocks as voxel means, spread trilinearly
        Rv = F.interpolate((Rb / float(b ** 3))[None, None],
                           scale_factor=b, mode="trilinear",
                           align_corners=False)[0, 0, :Z, :Y, :X]
        occ_t = torch.as_tensor(self.occupied(s.pose), device=dB.device)
        l0 = loss(torch.zeros_like(dB), occ_t, self.loss_params)
        lf = loss(dB + Rv, occ_t, self.loss_params)
        nums = {"target_mismatch": mism, "cull_mismatch": cull,
                "residual_sum_gap": sum_gap, "block_gap": block_gap,
                "residual_noise": noise, "residual_peak": peak,
                "final_loss_ratio": lf / l0}
        return {k: (v if np.isfinite(v) else float("inf"))
                for k, v in nums.items()}

    def best_iou(self, s):
        """The best IoU of the final dose against the phantom's binary
        occupancy on the final sensor."""
        return best_iou(s.vol, self.occupied(s.pose))[0]

    def work(self):
        X, Y, Z = self.film["res"]
        return {"taps": self.ref.taps(),
                "A": int(self.cfg["projector"]["n_patterns"]),
                "U": int(self.cfg["projector"]["resx"]),
                "X": X, "Y": Y, "Zf": Z}
