"""Hybrid scattering engine: the analytic unscattered transport plus a
Monte-Carlo scattered residual (counterpart of drtvam_tpu/ops/hybrid.py).

For a collimated projector orbiting a z-invariant vial, the expected
dose of every deposit made before a path's first scatter (n_scat == 0)
is the per-voxel Beer-Lambert absorption along the refracted 2D ray
fan: the ballistic engine's backprojection computes it exactly, for
every estimator (dda exactly, ratio and delta in expectation). So

    dose = E[unscattered deposits]    (BallisticEngine, unscattered)
         + MC[deposits with n_scat >= 1]  (the wavefront's residual)

is an unbiased estimate of the analog render with lower variance at
the same rays a pixel. The residual starts each lane at its forced
first scatter event, sampled on the pixel's in-medium chord from the
chord bank (ops/transport2d.py `build_chords`), and for delta tracking
in one convex medium region runs the unrolled event loop
(`fast_residual`). Both parts are linear in the patterns and
differentiable: the ballistic part through its Backproject function,
the residual through RenderRaw's path replay at the same seed.

A surface-aware film (two channels, drtvam_tpu/ops/hybrid.py:80-136):
the unscattered part splits its dose by the inside mask, as the
ballistic engine does, and the residual keeps the target mesh, seeding
each lane's channel from the mask at its first scatter event (and the
fast residual at each event voxel).

On a CUDA device the residual runs the wf_res_fwd / wf_res_bwd kernels
(ops/render.py), the unscattered part the backprojection kernels; on the
CPU both run their plain versions.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from . import render as wavefront
from .ballistic import BallisticEngine
from .march import MarchStatic, fast_residual_eligible, scene_tensors
from .transport2d import build_chords, chord_pack, strip_target, \
    unscattered_eligible

__all__ = ["ScatteringEngine", "hybrid_eligible"]


def hybrid_eligible(static: MarchStatic) -> bool:
    """A scattering scene whose unscattered transport is precomputable:
    the JAX package's `auto` runs the hybrid engine there."""
    return static.has_scattering and unscattered_eligible(static)


class ScatteringEngine:
    """Per-(scene, sensor) engine for scattering media on one device.

    `render_vol(data, inv_vol, seed)` returns the (Z, Y, X, C) dose
    volume, differentiable in data; the seed drives the residual (vary
    it per optimization step). `pattern_grad(dvol, inv_vol, seed)` is
    the explicit adjoint: the ballistic adjoint plus one residual
    adjoint replaying the same paths.

    spp / spp_grad: residual lanes a pixel for the forward / adjoint.
    estimator: the residual's estimator ('dda' | 'ratio' | 'delta'),
    None keeping the scene's. first_scatter: start every residual lane
    at its forced first scatter (else the analog paths with their
    unscattered deposits dropped). residual_max_depth: the residual's
    depth cap (None keeps the scene's max_depth). inside_mask: the
    target's (Z, Y, X[, 1]) binary occupancy in the sensor's grid, which
    a surface-aware film needs (its static keeps the target mesh). The
    unscattered part runs the ballistic engine's default kernels for the
    device (`ballistic.default_impl`).
    """

    def __init__(self, static: MarchStatic, arr, device, spp=4,
                 spp_grad=None, chunk=None, estimator=None,
                 first_scatter=True, residual_max_depth=None,
                 inside_mask=None):
        if not hybrid_eligible(static):
            raise ValueError("scene is not hybrid-eligible (needs "
                             "scattering and z-invariant collimated "
                             "geometry)")
        self.device = torch.device(device)
        self.ball = BallisticEngine(static, arr, self.device,
                                    unscattered=True,
                                    inside_mask=inside_mask)
        self.impl = self.ball.impl
        sensor = static.sensor
        if estimator is not None and estimator != sensor.estimator:
            sensor = dataclasses.replace(sensor, estimator=estimator)
        arr_t = scene_tensors(arr, "cpu")
        if first_scatter:
            # geometry only, A * U lanes: traced on the host, uploaded once
            st2, arr2 = strip_target(static, arr)
            arr_t["chord_pack"] = chord_pack(
                *build_chords(st2, scene_tensors(arr2, "cpu")))
            if static.sensor.channels == 2:
                # the first scatter's channel seed (the JAX package's
                # inside_mask_flat > 0.5), one byte a voxel
                arr_t["inside_mask"] = torch.from_numpy(
                    (np.asarray(inside_mask, np.float32) > 0.5)
                    .reshape(-1).astype(np.uint8))
        self.arr = {k: v.to(self.device) for k, v in arr_t.items()}
        self.static_s = dataclasses.replace(
            static, scattered_only=True, sensor=sensor,
            first_scatter=first_scatter,
            max_depth=(static.max_depth if residual_max_depth is None
                       else residual_max_depth),
            fast_residual=(first_scatter and sensor.estimator == "delta"
                           and fast_residual_eligible(static)))
        self.spp = spp
        self.spp_grad = spp if spp_grad is None else spp_grad
        self.chunk = wavefront.DEFAULT_CHUNK if chunk is None else chunk

    def set_max_depth(self, max_depth):
        """Change the residual's depth cap (the progressive schedule):
        only the residual's static changes; the unscattered fields and
        the chord bank do not depend on depth and are kept."""
        self.static_s = dataclasses.replace(self.static_s,
                                            max_depth=max_depth)

    def render_vol(self, active_data, inv_vol, seed=0):
        """The dose volume (Z, Y, X, C), differentiable in active_data."""
        vol_b = self.ball.render_vol(active_data, inv_vol)
        vol_s = wavefront.render(self.static_s, self.arr, active_data,
                                 inv_vol, seed, self.spp, self.spp_grad,
                                 self.chunk)
        return vol_b + vol_s

    def pattern_grad(self, dvol, inv_vol, seed=0):
        """d loss / d data given d loss / d vol (Z, Y, X, C)."""
        gb = self.ball.pattern_grad(dvol, inv_vol)
        gs = wavefront.adjoint(self.static_s, self.arr, seed, self.spp_grad,
                               self.chunk, (dvol * inv_vol).reshape(-1))
        return gb + gs
