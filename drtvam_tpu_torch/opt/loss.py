"""Dose-volume objectives (counterpart of drtvam_tpu/opt/loss.py).

Thresholded dose penalty (Wechsler et al. 2024), plain L2, a pattern
sparsity term and sum/mean reduction, as plain differentiable torch:
autograd gives the dose and pattern cotangents.

Two target layouts, as in the JAX package:
  * one channel (binary or grayscale occupancy): voxels with target > 0
    are scored by `object_term`, the rest by `void_term`;
  * two channels (surface-aware): the target holds the per-voxel
    (inside, outside) fractional volumes and the dose the dose on each
    side of the target surface; each side is scored by its own term,
    weighted by its share of the voxel's volume.
Config keys and defaults are those of the JAX package.
"""
from __future__ import annotations

import torch

losses = {}


def register_loss(name, cls):
    losses[name] = cls


def _pos(x):
    """max(x, 0), the relu(.)^K of the paper's notation. torch.maximum
    splits the gradient at a tie like jnp.maximum (clamp would not)."""
    return torch.maximum(x, torch.zeros_like(x))


def evaluate(objective, dose, target, patterns):
    """Reduce an objective over a dose volume.

    dose: (..., C) with C 1 or 2; target: the same shape, or without
    the channel axis when C is 1. Returns reduced(voxel terms) +
    reduced(pattern sparsity)."""
    if dose.shape != target.shape:
        if dose.dim() == target.dim() + 1 and dose.shape[-1] == 1:
            target = target[..., None]
        else:
            raise ValueError(
                f"dose volume {tuple(dose.shape)} and target "
                f"{tuple(target.shape)} are not broadcast-compatible")
    channels = target.shape[-1]
    if channels == 1:
        per_voxel = objective.voxel_term(dose, target)
    elif channels == 2:
        frac = target[..., 0] + target[..., 1]
        per_voxel = (target[..., 0] * objective.object_term(dose[..., 0])
                     + target[..., 1] * objective.void_term(dose[..., 1])
                     ) / frac
    else:
        raise ValueError(
            "expected a trailing channel axis of 1 (binary) or 2 "
            f"(surface-aware), got target shape {tuple(target.shape)}")
    sparsity = objective.sparsity_term(patterns)
    return objective.reduction(per_voxel) + objective.reduction(sparsity)


class Loss:
    """Base objective: reduction handling + the callable contract.

    Subclasses (and user extensions via `register_loss`) provide
    `object_term(dose)`, `void_term(dose)` and `sparsity_term(patterns)`.
    """

    def __init__(self, props):
        reduction = props.get("reduction", "sum")
        try:
            self.reduction = {"sum": torch.sum, "mean": torch.mean}[reduction]
        except KeyError:
            raise ValueError(
                f"reduction must be 'sum' or 'mean', got '{reduction}'")

    def object_term(self, dose):
        raise NotImplementedError

    def void_term(self, dose):
        raise NotImplementedError

    def sparsity_term(self, patterns):
        raise NotImplementedError

    def voxel_term(self, dose, target):
        """One-channel scoring: occupied voxels by object_term, empty
        ones by void_term."""
        return torch.where(target > 0, self.object_term(dose),
                           self.void_term(dose))

    def __call__(self, dose, target, patterns):
        return evaluate(self, dose, target, patterns)


class L2Loss(Loss):
    """Squared distance of the dose to the occupancy (plus the optional
    |p|^M pattern penalty)."""

    def __init__(self, props):
        super().__init__(props)
        self.M = props.get("M", 4)
        self.weight_sparsity = props.get("weight_sparsity", 0)

    def object_term(self, dose):
        return torch.square(dose - 1.0)

    def void_term(self, dose):
        return torch.square(dose)

    def voxel_term(self, dose, target):
        # grayscale targets are meaningful for L2: match them directly
        return torch.square(dose - target)

    def sparsity_term(self, patterns):
        return self.weight_sparsity * patterns ** self.M


class ThresholdedLoss(Loss):
    """Thresholded dose objective (Wechsler et al. 2024):

      w_obj  * max(tu - d, 0)^K    object voxels still below tu
    + w_void * max(d - tl, 0)^K    void voxels already above tl
    + w_lim  * max(d - 1, 0)^K     overpolymerized object voxels
    + w_sp   * |p|^M               pattern sparsity
    """

    def __init__(self, props):
        super().__init__(props)
        self.K = props.get("K", 2)
        self.M = props.get("M", 4)
        self.tl = props.get("tl", 0.9)
        self.tu = props.get("tu", 0.95)
        self.weight_object = props.get("weight_object", 1)
        self.weight_void = props.get("weight_void", 1)
        self.weight_limit = props.get("weight_limit", 1)
        self.weight_sparsity = props.get("weight_sparsity", 0)
        if self.tl >= self.tu:
            raise ValueError(
                f"threshold window is empty: tl={self.tl} must lie below "
                f"tu={self.tu}")

    def object_term(self, dose):
        return (self.weight_object * _pos(self.tu - dose) ** self.K
                + self.weight_limit * _pos(dose - 1.0) ** self.K)

    def void_term(self, dose):
        return self.weight_void * _pos(dose - self.tl) ** self.K

    def sparsity_term(self, patterns):
        return self.weight_sparsity * torch.abs(patterns) ** self.M


register_loss("l2", L2Loss)
register_loss("threshold", ThresholdedLoss)
