"""The comparison of a ballistic job (no scattering: the whole dose is the
refracted fan's unscattered transport), for each optimization:

- `target_mismatch`: the voxels where the film target the program
  voxelized (`target.npy`) differs from the phantom's occupancy, outside
  the rounding band of the mesh's edges (limit 0: exact);
- `dose_gap`: the widest gap between the final dose optimize() returned
  and the float64 reference's dose of the final patterns
  (`patterns.npz`), over the reference's largest dose;
- `last_loss_gap`: how far the reference's loss at the final patterns
  lies above the loss the loop reported at its last step, over the loss
  at zero (on a converged loop the two are the same number, 0);
- `final_loss_ratio`: the reference's loss at the final patterns over
  its loss at zero: the patterns reached solve the problem.
"""
from __future__ import annotations

import numpy as np
import torch

from . import occupancy
from .dose import Reference, loss
from ..harness.iou import best_iou

NAMES = ("target_mismatch", "dose_gap", "last_loss_gap", "final_loss_ratio")


class Check:
    NAMES = NAMES

    def __init__(self, cell, device, params):
        self.cfg = cell.program_config()
        self.film = occupancy.film_of(self.cfg["sensor"])
        self.size = float(self.cfg["target"].get("size", 1.0))
        self.params = cell.traffic["optimize"]["loss"]
        self.ref = Reference(self.cfg, self.film, device)

    def occupied(self, pose):
        return np.ascontiguousarray(occupancy.occupancy(pose.rings(self.size),
                                                        self.film))

    def numbers(self, s):
        rings, edges = s.pose.rings(self.size), s.pose.edges(self.size)
        mism, _ = occupancy.compare(s.target, rings, edges, self.film)
        dref = self.ref.dose(s.patterns)
        prog = torch.as_tensor(s.vol.reshape(dref.shape),
                               device=dref.device).to(torch.float64)
        gap = float((prog - dref).abs().max()) / \
            max(float(dref.abs().max()), 1e-300)
        del prog
        occ_t = torch.as_tensor(self.occupied(s.pose), device=dref.device)
        l0 = loss(torch.zeros_like(dref), occ_t, self.params)
        lf = loss(dref, occ_t, self.params)
        last = float(s.loss[max(s.steps - 1, 0)])
        return {"target_mismatch": mism,
                "dose_gap": gap if np.isfinite(gap) else float("inf"),
                "last_loss_gap": max(0.0, lf - last) / l0,
                "final_loss_ratio": lf / l0}

    def best_iou(self, s):
        """The best IoU of the final dose against the phantom's own
        occupancy."""
        return best_iou(s.vol, self.occupied(s.pose))[0]

    def work(self):
        X, Y, Z = self.film["res"]
        return {"taps": self.ref.taps(),
                "A": int(self.cfg["projector"]["n_patterns"]),
                "U": int(self.cfg["projector"]["resx"]),
                "X": X, "Y": Y, "Zf": Z}
