"""Projector motion models (counterpart of drtvam_tpu/models/motion.py).

CircularMotion orbits the static vial: position
distance * (cos a, sin a, 0) with a = 2*pi*t (negated when clockwise),
looking at the origin with +z up.
"""
from __future__ import annotations

import math

import torch

from ..core.transforms import look_at

motions = {}


def register_motion(name, cls):
    motions[name] = cls


class CircularMotion:
    def __init__(self, props):
        self.distance = float(props["distance"])
        # accepted and ignored, like the reference's CircularMotion
        self.tilt = float(props.get("tilt", 0.0))
        self.clockwise = bool(props.get("clockwise", False))

    def eval(self, time):
        """time (...,) tensor in [0, 1] -> (R (..., 3, 3), t (..., 3))
        world-from-camera."""
        alpha = 2.0 * math.pi * time
        if self.clockwise:
            alpha = -alpha
        origin = self.distance * torch.stack(
            [torch.cos(alpha), torch.sin(alpha), torch.zeros_like(alpha)],
            -1)
        up = torch.tensor([0.0, 0.0, 1.0], dtype=torch.float32,
                          device=origin.device)
        return look_at(origin, torch.zeros_like(origin), up)


register_motion("circular", CircularMotion)
