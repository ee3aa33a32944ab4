"""Optimization driver + CLI (counterpart of drtvam_tpu/opt/optimize.py).

`optimize(config, device=...)` runs the pattern optimization end to
end on one device: scene assembly, target voxelization (binary, or the
fractional volumes of a surface-aware film), DMD-pixel culling, the
engine (the ballistic backprojection, the hybrid scattering engine or
the wavefront path tracer), the render / loss / adjoint / step loop
with pattern clamping and the convergence break, the final render, and
the artifact set (target.exr/npy, final.exr/npy, loss.npy, timing.npy,
per-pattern EXRs, patterns.npz + normalized uint8, histogram.png; on a
surface-aware film target_in/out.exr and target_binary.npy/exr).
`main()` is the CLI with dotted -D overrides and --forward_mode.

timing.npy: per iteration, column 0 is the primal render + loss wall
time, column 1 the adjoint + optimizer step (direction render and line
search included), each ending in a device synchronize.

timings (the `timings` argument, utils/spans.py's recorder for the
call): the phases' wall seconds, scene_s, cull_s, precompute_s, loop_s
(checkpoint_write_s inside it, checkpoint_read_s before it),
final_render_s and artifacts_s, each ending in a device synchronize or a
readback; active_pixels; optimize_s, the whole call; the host spans'
seconds, summed over the call: scene_build_s (Scene(config), the
target's triangles), voxelize_s (the target's occupancy and, on a
surface-aware film, its fractional volumes), target_io_s (the target's
EXR and NPY files), and wherever an engine is built (the cull, the loop,
the final render) build_s (scene.build), fan_s (the host ray fan),
layout_s (u from the fields, the kernel choice), upload_s (host to
device copies), z_taps_s, pixels_s (the pixel store's identity test and
index upload), chords_s (the hybrid chord bank), inv_volume_s,
cull_adjoint_s or cull_render_s (with the pixels they keep); the
artifacts' dose_files_s, pattern_files_s and histogram_s; and two
counters, fan_builds (host fans rasterized) and search_evals (the Armijo
search's candidate losses, each a host readback).

DMD-pixel culling before the loop, as in the JAX package:
`filter_radon` keeps the pixels whose ray crosses the target, by one
adjoint of the unscattered ballistic engine on the target occupancy
where the scene is transport-eligible (ops/ballistic.py
radon_active_ballistic), else by the radon render (ops/render.py
render_radon, `spp_filter_radon` lanes a pixel); `filter_corner`
({"dist", "radius"}) drops the pixels whose ray meets a square vial's
corner (render_corner). The optimization then runs on the kept pixels,
from zero.

Engines, selected as the JAX package selects them (`engine`: auto,
ballistic, hybrid, wavefront): under auto the ballistic engine for a
collimated projector, an analytic vial, pure absorption and the dda
estimator; the hybrid engine (ops/hybrid.py: the unscattered transport
plus a first-scatter residual, `spp` / `spp_grad` residual lanes a
pixel, its estimator `hybrid_estimator` or the scene's) for a
scattering scene with that geometry; otherwise the wavefront path
tracer (ops/render.py) with `spp` / `spp_grad` lanes per pixel, which
is what a mesh ('custom') vial or an occlusion always takes (neither is
z-invariant; `engine` "ballistic" or "hybrid" raises there). A
Monte-Carlo engine takes seed i at step i, and the line search renders
the direction with the step's seed, the full dose. The final render
runs the scene's own estimator at `spp_ref`, seed 0, `max_depth_ref`
and `rr_depth_ref`. A surface-aware film runs on every engine (the
inside-mask split, or the target kept in the march).

Optimizers (`optimizer.type`): lbfgs (the Linear L-BFGS,
opt/device_lbfgs.py), adam and sgd (optax's rules and defaults,
opt/first_order.py), the patterns clamped at 0 after each step.

Modes and keys:
  * `progressive`: max_depth 3 for steps 0-4, then `max_depth`; the
    engine changes its depth cap and keeps what does not depend on it,
    the L-BFGS its history (rebind);
  * `checkpoint_every`: N saves checkpoint.npz every N steps and at the
    last one; `resume` restores it (opt/checkpoint.py; the JAX
    package's file format, so either package resumes the other's);
  * `psf_analysis`: a list of {x, y, index_pattern, intensity} pixels
    rendered once by the final render, no loop: final.npy/exr,
    loss.npy and timing.npy (zeros), the patterns;
  * forward mode (`patterns_fwd`, the CLI's --forward_mode --patterns
    x.npz): the given patterns rendered by the final render, no cull,
    no loop, the full artifact set with zero loss and timing;
  * `optimize_medium` ({"lr", "sigma_t", "albedo"}; true means {}):
    medium calibration (drtvam_tpu/opt/optimize.py:240-251, :446-615),
    on the wavefront engine only (`engine` "ballistic" or "hybrid"
    raises). After each step's pattern update, d loss / d (sigma_t,
    albedo) of the render at the new patterns and the step's seed
    (autograd through ops/render.py RenderRaw, the adjoint wf_med on the
    card), an Adam (optax's rule, lr default 0.01) on both, the
    component not asked for zeroed (albedo is calibrated only when asked
    and when the medium scatters), then sigma_t >= 1e-5 and albedo in
    [0, 0.999], applied to the engine's scene tensors. The final render
    takes the calibrated medium; medium.json holds {"sigma_t",
    "albedo"}. A `target.dose_npy` dose volume calibrates; a mesh target
    calibrates while the patterns are optimized;
  * `profile` (drtvam_tpu/opt/optimize.py:507-515, :603-604): true or
    "true" traces into <output>/trace, another value names the
    directory. A torch.profiler trace (the CPU's operators, and on a
    CUDA device the card's kernels) of the loop, from after the
    optimizer is built (before a resumed state is restored) to after
    the last step's checkpoint, written at its end as a Chrome trace
    `*.pt.trace.json` (torch.profiler.tensorboard_trace_handler, which
    TensorBoard reads from that directory); without shapes or stacks.
    The spans are in it as user annotations, on the kernels' clock:
    `loop`, each `step`, and inside a step `render` (each engine render,
    the primal's and the L-BFGS direction's; `resample`, the ballistic
    z-resample, inside it and inside `pattern_grad`), `loss` (the loss,
    its autograd in the adjoint, each Armijo candidate), `pattern_grad`,
    `lbfgs` (the history and the update), `search`, `readback` and
    `checkpoint_write`. A profiler a caller wraps around optimize() sees
    every span of the call, from `optimize` down (the phases; the
    engines' `build`, `fan`, `layout`, `upload`, `pack`, `z_taps`,
    `pixels`, `chords`; the final render's `render` and `readback`).
    Only the coordinating rank (parallel/multihost.py) traces. It
    changes no number of the run.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import functools
import json
import os
import time

import numpy as np
import torch

from ..models.scene import Scene
from ..ops import render as wavefront
from ..ops.ballistic import BallisticEngine, radon_active_ballistic
from ..ops.hybrid import ScatteringEngine, hybrid_eligible
from ..ops.march import scene_tensors
from ..ops.transport2d import ballistic_eligible, unscattered_eligible
from ..parallel.multihost import is_coordinator
from ..utils.io import save_img, save_vol
from ..utils.metrics import save_histogram
from ..utils.spans import recording, span
from .checkpoint import check_optimizer, load_checkpoint, \
    restore_med_state, restore_opt_state, save_checkpoint
from .device_lbfgs import DeviceLinearLBFGS
from .first_order import FirstOrder
from .loss import losses

def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def select_engine(engine, static):
    """'ballistic', 'hybrid' or 'wavefront', as the JAX package's
    `_make_step_fns` selects (drtvam_tpu/opt/optimize.py:56-62)."""
    if engine not in ("auto", "ballistic", "wavefront", "hybrid"):
        raise ValueError(f"Unknown engine: '{engine}'")
    if engine == "ballistic" and not ballistic_eligible(static):
        raise ValueError("engine 'ballistic' needs a collimated projector, "
                         "an analytic vial, pure absorption and the dda "
                         "estimator")
    if engine == "hybrid" and not hybrid_eligible(static):
        raise ValueError("engine 'hybrid' needs a scattering medium, a "
                         "collimated projector and an analytic vial")
    if engine == "auto":
        if ballistic_eligible(static):
            return "ballistic"
        return "hybrid" if hybrid_eligible(static) else "wavefront"
    return engine


def _make_step_fns(render, pattern_grad, loss_obj, target):
    """Primal / adjoint / direction-render / line-search candidate
    closures around an engine's render(data, seed) -> dose volume and
    pattern_grad(dvol, seed) -> d loss / d data; each takes the step's
    seed last."""

    @torch.no_grad()
    def primal(data, seed):
        with span("render", timed=False):
            vol = render(data, seed)
        with span("loss", timed=False):
            return vol, loss_obj(vol, target, data)

    def adjoint(vol, data, seed):
        v = vol.detach().requires_grad_(True)
        p = data.detach().requires_grad_(True)
        with span("loss", timed=False), torch.enable_grad():
            dvol, dpat = torch.autograd.grad(loss_obj(v, target, p), (v, p))
        with span("pattern_grad", timed=False), torch.no_grad():
            return pattern_grad(dvol, seed) + dpat

    @torch.no_grad()
    @span("render", timed=False)
    def dir_fn(z, seed):
        # the direction renders with the step's seed: the linear line
        # search assumes one realization per step
        return render(z, seed)

    @torch.no_grad()
    @span("loss", timed=False)
    def cand_fn(vol, dvol, alpha, z, seed):
        # the sparsity term rides on the SEARCH DIRECTION during the line
        # search (reference quirk)
        return loss_obj(vol + alpha * dvol, target, z)

    return {"primal": primal, "adjoint": adjoint, "dir_fn": dir_fn,
            "cand_fn": cand_fn}


def profile_dir(value, output):
    """The trace directory of the `profile` key as the JAX driver resolves
    it (drtvam_tpu/opt/optimize.py:507-512): true or "true" is
    <output>/trace, another true value the directory it names; None for
    no trace."""
    if not value:
        return None
    if value is True or value == "true":
        return os.path.join(output, "trace")
    return str(value)


@contextlib.contextmanager
def _profiled(value, output, device):
    """A torch.profiler trace of the block where `profile` asks for one
    (profile_dir), on the coordinating rank: the CPU's operators and, on
    a CUDA device, the card's kernels, written as a Chrome trace into the
    directory when the block ends."""
    trace_dir = profile_dir(value, output)
    if trace_dir is None or not is_coordinator():
        yield
        return
    from torch.profiler import (ProfilerActivity, profile,
                                tensorboard_trace_handler)
    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts,
                 on_trace_ready=tensorboard_trace_handler(trace_dir)):
        print(f"Profiling to {trace_dir}")
        yield


def _cull(config, scene, target, device, rr_depth, transmission_only,
          regular_sampling, chunk):
    """DMD-pixel culling (drtvam_tpu/opt/optimize.py:283-330): the
    projector's active set becomes the pixels filter_radon and
    filter_corner keep, at zero. Returns whether a filter ran."""
    ran = False
    if config.get("filter_radon", False):
        static_v, arr_v = scene.build(
            mode="volume", include_target=False, max_depth=5,
            rr_depth=rr_depth, print_time=1.0,
            transmission_only=transmission_only,
            regular_sampling=regular_sampling)
        if unscattered_eligible(static_v):
            active = radon_active_ballistic(static_v, arr_v, target, device)
        else:
            static_r, arr_r = scene.build(
                mode="radon", include_target=True, max_depth=5,
                rr_depth=rr_depth, print_time=1.0,
                transmission_only=transmission_only,
                regular_sampling=regular_sampling)
            with span("upload"):
                arr_r = scene_tensors(arr_r, device)
            with span("cull_render"):
                img = wavefront.render_radon(
                    static_r, arr_r, seed=0,
                    spp=config.get("spp_filter_radon", 4), chunk=chunk)
                active = np.nonzero(img.cpu().numpy() > 0.0)[0].astype(
                    np.int32)
        if active.size == 0:
            raise ValueError(
                "Radon culling removed every DMD pixel — no ray ever "
                "crosses the target. Check the projector/target setup.")
        scene.projector.set_active(active, np.zeros(active.size, np.float32))
        ran = True
    if "filter_corner" in config:
        ccfg = config["filter_corner"]
        static_c, arr_c = scene.build(
            mode="volume", include_target=True, max_depth=1,
            rr_depth=rr_depth, print_time=1.0,
            transmission_only=transmission_only, regular_sampling=True)
        with span("upload"):
            arr_c = scene_tensors(arr_c, device)
        with span("cull_render"):
            img = wavefront.render_corner(
                static_c, arr_c, dist=ccfg["dist"],
                radius=ccfg.get("radius", 0.1), seed=0, chunk=chunk)
            active = np.nonzero(img.cpu().numpy() > 0.0)[0].astype(np.int32)
        if active.size == 0:
            raise ValueError(
                "Corner culling removed every DMD pixel — the corner "
                "radius/dist likely cover the whole aperture.")
        scene.projector.set_active(active, np.zeros(active.size, np.float32))
        ran = True
    return ran


class _Engine:
    """The loop's engine: render(data, seed) -> dose volume and
    pattern_grad(dvol, seed) -> d loss / d data, at a depth cap that
    `set_depth` changes (the progressive schedule) without rebuilding
    anything that does not depend on it: the ballistic engine has no
    depth; the hybrid engine changes its residual's static and keeps the
    unscattered fields and the chord bank; the wavefront changes its
    static and keeps the uploaded scene tensors (scene.build's arrays do
    not depend on max_depth)."""

    def __init__(self, kind, static, arr, device, inv_vol, spp, spp_grad,
                 chunk, hybrid_estimator=None, inside_mask=None):
        self.kind, self.inv_vol = kind, inv_vol
        self.spp, self.spp_grad, self.chunk = spp, spp_grad, chunk
        if kind == "ballistic":
            self.eng = BallisticEngine(static, arr, device,
                                       inside_mask=inside_mask)
            self.impl = self.eng.impl
        elif kind == "hybrid":
            self.eng = ScatteringEngine(static, arr, device, spp=spp,
                                        spp_grad=spp_grad, chunk=chunk,
                                        estimator=hybrid_estimator,
                                        inside_mask=inside_mask)
            self.impl = self.eng.impl
        else:
            self.static = static
            self.arr = scene_tensors(arr, device)
            self.impl = "cuda" if device.type == "cuda" else "plain"

    def set_depth(self, max_depth):
        if self.kind == "hybrid":
            self.eng.set_max_depth(max_depth)
        elif self.kind == "wavefront":
            self.static = dataclasses.replace(self.static,
                                              max_depth=max_depth)

    def render(self, d, seed, medium=None):
        if self.kind == "ballistic":   # deterministic: no seed
            return self.eng.render_vol(d, self.inv_vol)
        if self.kind == "hybrid":
            return self.eng.render_vol(d, self.inv_vol, seed)
        return wavefront.render(self.static, self.arr, d, self.inv_vol, seed,
                                self.spp, self.spp_grad, self.chunk, medium)

    def medium_grad(self, data, seed, loss_obj, target):
        """d loss / d (sigma_t, albedo) of the wavefront's render of data
        at seed (a medium_grads static), with leaves that hold the scene
        tensors' medium."""
        st = self.arr["sigma_t"].detach().clone().requires_grad_(True)
        al = self.arr["albedo"].detach().clone().requires_grad_(True)
        with torch.enable_grad():
            loss = loss_obj(self.render(data.detach(), seed, (st, al)),
                            target, data.detach())
            return torch.autograd.grad(loss, (st, al))

    def pattern_grad(self, dvol, seed):
        if self.kind == "ballistic":
            return self.eng.pattern_grad(dvol, self.inv_vol)
        if self.kind == "hybrid":
            return self.eng.pattern_grad(dvol, self.inv_vol, seed)
        return wavefront.adjoint(self.static, self.arr, seed, self.spp_grad,
                                 self.chunk,
                                 (dvol * self.inv_vol).reshape(-1))


def medium_config(config):
    """optimize_medium as the JAX driver reads it: true means {}; false,
    null and {} disable it (None)."""
    med = config.get("optimize_medium", None)
    if med is True:
        return {}
    return dict(med) if med else None


class _Medium:
    """The medium calibration's state: optax's Adam on {"al", "st"}
    (opt/first_order.py; the parameters as a float32 (albedo, sigma_t)
    pair on the host, optax's leaf order), the components asked for, the
    clips, and the values applied to a scene's tensors."""

    def __init__(self, cfg, medium):
        self.opt = FirstOrder("adam", float(cfg.get("lr", 0.01)))
        self.p = torch.tensor([medium.albedo, medium.sigma_t],
                              dtype=torch.float32)
        self.opt.init(self.p)
        self.use = torch.tensor([bool(cfg.get("albedo", False))
                                 and medium.albedo > 0.0,
                                 bool(cfg.get("sigma_t", True))])

    @property
    def sigma_t(self):
        return float(self.p[1])

    @property
    def albedo(self):
        return float(self.p[0])

    def step(self, g_st, g_al):
        """One Adam step at the gradients (the disabled component's
        zeroed), then sigma_t >= 1e-5 and albedo in [0, 0.999] (albedo
        stays 0 for a medium that does not scatter)."""
        g = torch.stack([g_al.detach(), g_st.detach()]).cpu().float()
        g = torch.where(self.use, g, torch.zeros_like(g))
        p = self.p + self.opt.update(self.p, g)
        self.p = torch.stack([torch.clamp(p[0], 0.0, 0.999),
                              torch.clamp(p[1], min=1e-5)])

    def apply(self, arr):
        dev = arr["sigma_t"].device
        arr["sigma_t"] = self.p[1].to(dev)
        arr["albedo"] = self.p[0].to(dev)

    def state(self):
        """(sigma_t, albedo, optax's leaves: count, mu.al, mu.st, nu.al,
        nu.st) for the checkpoint."""
        count, mu, nu = self.opt.leaves()
        return (np.float32(self.sigma_t), np.float32(self.albedo),
                [count, mu[0], mu[1], nu[0], nu[1]])

    def load(self, st, al, leaves):
        count, mu_al, mu_st, nu_al, nu_st = leaves
        self.p = torch.tensor([al, st], dtype=torch.float32)
        self.opt.load_leaves([count, np.stack([mu_al, mu_st]),
                              np.stack([nu_al, nu_st])], self.p)


def _psf_pixels(config, scene):
    """psf_analysis: the listed DMD pixels, checked, become the sparse
    store with their intensities (drtvam_tpu/opt/optimize.py:397-416)."""
    entries = config["psf_analysis"]
    print(f"\nPSF analysis mode: tracing {len(entries)} isolated DMD "
          "pixels.")
    xres = config["projector"]["resx"]
    yres = config["projector"]["resy"]
    pix = np.zeros(len(entries), np.int32)
    val = np.ones(len(entries), np.float32)
    for i, e in enumerate(entries):
        if not (0 <= e["x"] < xres and 0 <= e["y"] < yres):
            raise ValueError(
                f"psf_analysis pixel ({e['x']}, {e['y']}) lies outside the "
                f"{xres}x{yres} DMD")
        if not 0 <= e["index_pattern"] < config["projector"]["n_patterns"]:
            raise ValueError(
                f"psf_analysis index_pattern {e['index_pattern']} exceeds "
                "n_patterns")
        pix[i] = xres * yres * e["index_pattern"] + xres * e["y"] + e["x"]
        val[i] = e["intensity"]
    scene.projector.set_active(pix, val)


def _final_render(scene, data, device, engine_cfg, surface_aware, spp_ref,
                  chunk, build_kw):
    """The final dose volume (numpy (Z, Y, X, 1)) on the final sensor:
    the ballistic engine where the scene allows it, else the hybrid
    engine (the scene's own estimator, not hybrid_estimator), else the
    wavefront, at spp_ref with seed 0 (drtvam_tpu/opt/optimize.py:
    359-379). A surface-aware scene keeps its target mesh, as in the
    JAX package: the hybrid residual and the wavefront intersect it,
    their segments split at its crossings. The final sensor is never
    surface-aware, so no engine takes the inside mask here."""
    final_sensor = scene.final_sensor
    static_f, arr_f = scene.build(
        mode="volume", include_target=surface_aware, sensor=final_sensor,
        **build_kw)
    inv_vol_f = float(np.float32(1.0 / final_sensor.voxel_volume))
    if engine_cfg != "wavefront" and ballistic_eligible(static_f):
        render = functools.partial(
            BallisticEngine(static_f, arr_f, device).render_vol, data,
            inv_vol_f)
    elif engine_cfg != "wavefront" and hybrid_eligible(static_f):
        render = functools.partial(
            ScatteringEngine(static_f, arr_f, device, spp=spp_ref,
                             chunk=chunk).render_vol, data, inv_vol_f, 0)
    else:
        with span("upload"):
            arr_t = scene_tensors(arr_f, device)
        render = functools.partial(wavefront.render, static_f, arr_t, data,
                                   inv_vol_f, 0, spp_ref, spp_ref, chunk)
    with span("render", timed=False), torch.no_grad():
        vol = render()
    with span("readback", timed=False):
        return vol.cpu().numpy()


@span("dose_files")
def _write_dose(output, vol_final, loss_hist, timing_hist):
    np.save(os.path.join(output, "final.npy"), vol_final)
    save_vol(vol_final, os.path.join(output, "final.exr"))
    np.save(os.path.join(output, "loss.npy"), loss_hist)
    np.save(os.path.join(output, "timing.npy"), timing_hist)


def _dump_patterns(scene, data, output):
    """The per-pattern EXRs and patterns.npz; returns the dense stack."""
    imgs = scene.projector.patterns(data)
    print("Writing per-pattern EXR images...")
    for k in range(imgs.shape[0]):
        save_img(imgs[k], os.path.join(output, "patterns", f"{k:04d}.exr"))
    np.savez_compressed(os.path.join(output, "patterns.npz"),
                        patterns=imgs)
    return imgs


def optimize(config, patterns_fwd=None, resolve_path=None, device="cuda",
             timings=None):
    """Optimize projector patterns for the configured TVAM scene.

    Args:
        config: configuration dict (the JAX package's JSON schema).
        patterns_fwd: if given, skip the optimization and project these
            (n_patterns, resy, resx) patterns (the CLI's --forward_mode).
        resolve_path: optional relative-path resolver.
        device: torch device the engine and the optimizer run on.
        timings: optional dict, the recorder of the call's spans and
            counters (utils/spans.py): the wall seconds of the phases
            (scene_s, cull_s, precompute_s, loop_s, final_render_s,
            artifacts_s; checkpoint_write_s, inside loop_s, and
            checkpoint_read_s where they ran), the active pixels the
            loop optimizes (active_pixels), the host spans' seconds and
            the counters listed in the module's docstring.
    Returns the final dose volume as a numpy (Z, Y, X, 1) array.
    """
    timings = {} if timings is None else timings
    with recording(timings), span("optimize"):
        return _optimize(config, patterns_fwd, resolve_path,
                         torch.device(device), timings)


def _optimize(config, patterns_fwd, resolve_path, device, timings):
    # float32 products stay float32 on the card (stated, and the default)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    config = dict(config)
    if resolve_path is None:
        def resolve_path(p):
            return p

    with span("scene"):
        with span("scene_build"):
            scene = Scene(config, resolve_path)
        med_cfg = medium_config(config)
        if med_cfg is not None and \
                config.get("engine", "auto") in ("ballistic", "hybrid"):
            raise ValueError(
                "optimize_medium requires the wavefront engine; the "
                f"'{config['engine']}' engine precomputes the medium into "
                "its transport fields")
        if patterns_fwd is not None:
            # checked before any state changes
            patterns_fwd = np.asarray(patterns_fwd, np.float32)
            if patterns_fwd.shape != scene.projector.size():
                raise ValueError(
                    f"forward mode: the patterns have shape "
                    f"{patterns_fwd.shape}, the projector (n_patterns, "
                    f"resy, resx) = {scene.projector.size()}")
        output = config["output"]
        os.makedirs(os.path.join(output, "patterns"), exist_ok=True)

        spp = config.get("spp", 4)
        spp_ref = config.get("spp_ref", 16)
        spp_grad = config.get("spp_grad", spp)
        max_depth = config.get("max_depth", 6)
        rr_depth = config.get("rr_depth", 6)
        print_time = config.get("time", 1.0)
        progressive = config.get("progressive", False)
        transmission_only = config.get("transmission_only", True)
        regular_sampling = config.get("regular_sampling", False)
        chunk = config.get("chunk_size", wavefront.DEFAULT_CHUNK)
        engine_cfg = "wavefront" if med_cfg is not None else \
            config.get("engine", "auto")
        if regular_sampling:
            spp = 1  # rays from pixel centres (spp_grad keeps its value)
        sensor = scene.sensor
        surface_aware = sensor.surface_aware
        build_kw = dict(print_time=print_time,
                        transmission_only=transmission_only,
                        regular_sampling=regular_sampling)

        if sensor.static.estimator == "delta" and scene.medium.albedo == 0.0:
            raise ValueError(
                "the delta-tracking estimator needs a scattering medium "
                "(albedo > 0); use 'dda' or 'ratio' for pure absorption")

        # the target: binary occupancy, or on a surface-aware film the
        # inside / outside fractional volumes
        tb = inside_mask = None
        if scene.target_dose is not None:
            if surface_aware:
                raise ValueError("a dose-volume target cannot drive the "
                                 "surface-aware discretization")
            if config.get("filter_radon", False) or \
                    "filter_corner" in config:
                raise ValueError("DMD-pixel culling filters need a target "
                                 "mesh, not a dose volume")
            target = scene.target_dose
        else:
            with span("scene_build"):
                tb = scene.target_bank()
            if surface_aware:
                with span("voxelize"):
                    target = sensor.compute_volume(tb)
                    inside_mask = sensor.discretize(tb)
                with span("target_io"):
                    save_vol(target[..., 0, None],
                             os.path.join(output, "target_in.exr"))
                    save_vol(target[..., 1, None],
                             os.path.join(output, "target_out.exr"))
            else:
                with span("voxelize"):
                    target = np.asarray(sensor.discretize(tb))
                with span("target_io"):
                    save_vol(target, os.path.join(output, "target.exr"))
        with span("target_io"):
            np.save(os.path.join(output, "target.npy"), target)

    if "loss" not in config:
        print("Config has no 'loss' entry; defaulting to the thresholded "
              "dose loss.")
        config["loss"] = {"type": "threshold"}
    loss_cfg = dict(config["loss"])
    loss_type = loss_cfg.pop("type")
    if loss_type not in losses:
        raise ValueError(f"no loss named '{loss_type}' is registered "
                         f"(have: {sorted(losses)})")
    loss_obj = losses[loss_type](loss_cfg)

    if "optimizer" not in config:
        print("Config has no 'optimizer' entry; defaulting to linear "
              "L-BFGS.")
        config["optimizer"] = {"type": "lbfgs"}
    opt_cfg = dict(config["optimizer"])
    optim_type = opt_cfg.pop("type")

    n_steps = config.get("n_steps", 40)
    loss_hist = np.zeros(n_steps)
    timing_hist = np.zeros((n_steps, 2))
    final_kw = dict(max_depth=config.get("max_depth_ref", 16),
                    rr_depth=config.get("rr_depth_ref", 8), **build_kw)

    @span("final_render")
    def final_render(data):
        return _final_render(scene, data, device, engine_cfg, surface_aware,
                             spp_ref, chunk, final_kw)

    if patterns_fwd is not None:
        print("Forward mode: projecting the supplied patterns, no "
              "optimization.")
        # the projector's pixel store takes its pixels' values (the
        # dense identity store: all of them); no cull
        scene.projector.active_data = \
            patterns_fwd.reshape(-1)[scene.projector.active_pixels]
        data = torch.as_tensor(scene.projector.active_data, device=device)
    elif "psf_analysis" in config:
        # no cull: the listed pixels replace the store
        _psf_pixels(config, scene)
        data = torch.as_tensor(scene.projector.active_data, device=device)
        print("Rendering the final dose volume...")
        vol_final = final_render(data)
        with span("artifacts"):
            _write_dose(output, vol_final, loss_hist, timing_hist)
            with span("pattern_files"):
                _dump_patterns(scene, data, output)
        return vol_final
    else:
        data = _optimize_loop(
            config, scene, device, timings, engine_cfg, optim_type, opt_cfg,
            loss_obj, target, inside_mask, tb, loss_hist, timing_hist,
            dict(spp=spp, spp_grad=spp_grad, chunk=chunk,
                 max_depth=max_depth, rr_depth=rr_depth,
                 progressive=progressive, build_kw=build_kw, med=med_cfg))

    print("Rendering the final dose volume...")
    vol_final = final_render(data)

    with span("artifacts"):
        _write_dose(output, vol_final, loss_hist, timing_hist)
        with span("pattern_files"):
            imgs = _dump_patterns(scene, data, output)
            array_max = float(np.max(imgs)) if imgs.size else 1.0
            array_max = array_max if array_max > 0 else 1.0
            normalized = imgs / array_max
            np.savez_compressed(
                os.path.join(output, "patterns_normalized_uint8.npz"),
                patterns=(normalized * 255).astype(np.uint8))

        with span("histogram"):
            if surface_aware:
                # the target's occupancy on the final sensor's grid
                hist_target = scene.final_sensor.discretize(tb)
                np.save(os.path.join(output, "target_binary.npy"),
                        hist_target)
                save_vol(hist_target,
                         os.path.join(output, "target_binary.exr"))
            else:
                hist_target = target
            efficiency = float(np.sum(normalized / normalized.size))
            print(f"Pattern energy efficiency: {efficiency:.4f}")
            save_histogram(vol_final, hist_target,
                           os.path.join(output, "histogram.png"), efficiency,
                           array_max)
    return vol_final


def _optimize_loop(config, scene, device, timings, engine_cfg, optim_type,
                   opt_cfg, loss_obj, target, inside_mask, tb, loss_hist,
                   timing_hist, rp):
    """The culls, the engine and the render / loss / adjoint / step loop,
    with the progressive depth schedule, checkpoints and resume, and the
    medium calibration (drtvam_tpu/opt/optimize.py:283-330, :428-615).
    rp: the rendering parameters (rp["med"]: the optimize_medium config
    or None). Returns the optimized patterns (on `device`); the
    histories are filled in place; a calibrated medium is written to
    scene.medium and medium.json."""
    output = config["output"]
    n_steps = loss_hist.shape[0]
    sensor = scene.sensor
    build_kw = rp["build_kw"]
    progressive, max_depth = rp["progressive"], rp["max_depth"]
    if optim_type not in ("lbfgs", "adam", "sgd"):
        raise ValueError(f"Unknown optimizer type: '{optim_type}'")

    with span("cull"):
        cull_mask = inside_mask if inside_mask is not None else target
        if _cull(config, scene, cull_mask, device, rp["rr_depth"],
                 build_kw["transmission_only"], build_kw["regular_sampling"],
                 rp["chunk"]):
            n_dense = int(np.prod(scene.projector.size()))
            print(f"DMD-pixel culling kept {scene.projector.active_size()} "
                  f"of {n_dense} pixels")
        _sync(device)

    # resume: the checkpoint's store is set before the engine is built
    # from the scene (the JAX package sets it after building its step
    # functions), and must be the pixel set this run's cull kept
    start_step, ckpt = 0, None
    checkpoint_every = int(config.get("checkpoint_every", 0))
    if config.get("resume", False):
        with span("checkpoint_read"):
            ckpt = load_checkpoint(output)
        if ckpt is None:
            print("No checkpoint found; starting from scratch.")
        else:
            check_optimizer(ckpt, optim_type)
            if not np.array_equal(ckpt["active_pixels"],
                                  scene.projector.active_pixels):
                raise ValueError(
                    "the checkpoint's active pixel set differs from this "
                    "run's (after its DMD-pixel culling): it was written "
                    "for another scene or culling configuration")
            scene.projector.active_data = np.asarray(ckpt["active_data"],
                                                     np.float32)
            start_step = int(ckpt["step"]) + 1
            n_saved = min(len(ckpt["loss_hist"]), n_steps)
            loss_hist[:n_saved] = ckpt["loss_hist"][:n_saved]
            timing_hist[:n_saved] = ckpt["timing_hist"][:n_saved]

    t0 = time.perf_counter()
    depth = 3 if progressive and start_step < 5 else max_depth
    static, arr = scene.build(mode="volume", include_target=inside_mask
                              is not None, max_depth=depth,
                              rr_depth=rp["rr_depth"], **build_kw)
    med = None
    if rp["med"] is not None:
        static = dataclasses.replace(static, medium_grads=True)
        med = _Medium(rp["med"], scene.medium)
    engine_kind = select_engine(engine_cfg, static)
    timings["active_pixels"] = static.projector.n_active
    with span("inv_volume"):
        inv_vol = sensor.inv_volume(tb)
    with span("upload"):
        inv_vol = torch.from_numpy(inv_vol).to(device) if inv_vol.ndim \
            else float(inv_vol)
    engine = _Engine(engine_kind, static, arr, device, inv_vol, rp["spp"],
                     rp["spp_grad"], rp["chunk"],
                     config.get("hybrid_estimator"), inside_mask)
    with span("upload"):
        target_t = torch.from_numpy(np.ascontiguousarray(target)).to(device)
        data = torch.as_tensor(scene.projector.active_data,
                               dtype=torch.float32, device=device)
    fns = _make_step_fns(engine.render, engine.pattern_grad, loss_obj,
                         target_t)
    if optim_type == "lbfgs":
        opt = DeviceLinearLBFGS(dir_fn=fns["dir_fn"], cand_fn=fns["cand_fn"],
                                **opt_cfg)
    else:
        opt = FirstOrder(optim_type, **opt_cfg)
    # the profiler's window: the JAX driver's, from the built optimizer
    # (before a resumed state) to the loop's end
    with _profiled(config.get("profile"), output, device):
        if ckpt is not None:
            restore_opt_state(ckpt, optim_type, opt, data)
            if med is not None and restore_med_state(ckpt) is not None:
                med.load(*restore_med_state(ckpt))
                med.apply(engine.arr)
            print(f"Resuming from checkpoint at step {start_step}.")
        del ckpt
        _sync(device)
        timings["precompute_s"] = time.perf_counter() - t0
        print(f"{engine_kind.capitalize()} engine on {device}: kernels "
              f"'{engine.impl}'")

        print("Starting the pattern optimization loop...")
        timings["checkpoint_write_s"] = 0.0
        with span("loop"):
            for i in range(start_step, n_steps):
                if progressive and i == 5 and depth != max_depth:
                    # before the step's timer, as in the JAX package
                    depth = max_depth
                    engine.set_depth(depth)
                    fns = _make_step_fns(engine.render, engine.pattern_grad,
                                         loss_obj, target_t)
                    if optim_type == "lbfgs":
                        opt.rebind(fns["dir_fn"], fns["cand_fn"])
                with span("step", timed=False):
                    t0 = time.perf_counter()
                    vol, loss = fns["primal"](data, i)
                    with span("readback", timed=False):
                        loss_hist[i] = float(loss)
                    timing_hist[i, 0] = time.perf_counter() - t0

                    t1 = time.perf_counter()
                    grad = fns["adjoint"](vol, data, i)
                    if loss_hist[i] == 0.0:
                        print("Converged")
                        _sync(device)
                        timing_hist[i, 1] = time.perf_counter() - t1
                        break
                    if optim_type == "lbfgs":
                        data = opt.step(data, grad, vol, loss, step_args=(i,))
                    else:
                        data = opt.step(data, grad)
                    if med is not None:
                        # the medium's gradient at the new patterns, the
                        # step's seed
                        med.step(*engine.medium_grad(data, i, loss_obj,
                                                     target_t))
                        med.apply(engine.arr)
                    _sync(device)
                    timing_hist[i, 1] = time.perf_counter() - t1
                    print(f"step {i:4d}  loss {loss_hist[i]:.6e}  "
                          f"{timing_hist[i].sum():.3f}s")
                    if checkpoint_every and ((i + 1) % checkpoint_every == 0
                                             or i == n_steps - 1):
                        with span("checkpoint_write"):
                            save_checkpoint(
                                output, i, data,
                                scene.projector.active_pixels, loss_hist,
                                timing_hist, optim_type, opt,
                                None if med is None else med.state())
    scene.projector.active_data = data
    if med is not None:
        scene.medium.sigma_t, scene.medium.albedo = med.sigma_t, med.albedo
        with open(os.path.join(output, "medium.json"), "w") as f:
            json.dump({"sigma_t": med.sigma_t, "albedo": med.albedo}, f,
                      indent=2)
        print(f"Calibrated medium: sigma_t={med.sigma_t:.6f} "
              f"albedo={med.albedo:.4f}")
    return data


# --------------------------------------------------------------------------
# CLI


def parse_overrides(pairs):
    """`-D a.b.c=value` strings -> {dotted_key: coerced_value}. Values go
    through json.loads; anything that isn't valid JSON stays a string."""
    out = {}
    for item in pairs or []:
        key, sep, raw = item.partition("=")
        if not sep or not key:
            raise ValueError(f"override '{item}' is not of the form "
                             "key=value")
        try:
            out[key] = json.loads(raw)
        except json.JSONDecodeError:
            out[key] = raw
    return out


def make_resolver(base_dir):
    def resolve(p):
        if os.path.isabs(p) or os.path.exists(p):
            return p
        cand = os.path.join(base_dir, p)
        return cand if os.path.exists(cand) else p
    return resolve


def main(argv=None):
    parser = argparse.ArgumentParser("Optimize patterns for TVAM.")
    parser.add_argument("config", type=str,
                        help="Path to the configuration file")
    parser.add_argument("-D", dest="overrides", metavar="key=value",
                        action="append", default=[],
                        help="Override/Add a parameter in the configuration "
                        "dictionary. Nested keys are separated by dots.")
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device to run on (cuda, cuda:N, cpu)")
    parser.add_argument("--forward_mode", action="store_true",
                        help="Just project the patterns without "
                        "optimization. Patterns need to be specified by "
                        "--patterns (a .npz file).")
    parser.add_argument("--patterns", type=str,
                        help="Path to the patterns file (a .npz file). This "
                        "is only used in forward mode.")
    args = parser.parse_args(argv)
    if args.forward_mode and args.patterns is None:
        raise ValueError(
            "--forward_mode needs --patterns pointing at a .npz file")

    with open(args.config, "r") as f:
        config = json.load(f)
    for key, value in parse_overrides(args.overrides).items():
        key = key.split(".")
        tmp = config
        for k in key[:-1]:
            tmp = tmp[k]
        tmp[key[-1]] = value

    base_dir = os.path.dirname(os.path.abspath(args.config))
    if "output" not in config:
        config["output"] = base_dir
    os.makedirs(os.path.join(config["output"], "patterns"), exist_ok=True)
    with open(os.path.join(config["output"], "opt_config.json"), "w") as f:
        json.dump(config, f, indent=4)
    patterns = None
    if args.forward_mode:
        with np.load(args.patterns) as f:
            patterns = f["patterns"]
    optimize(config, patterns_fwd=patterns,
             resolve_path=make_resolver(base_dir), device=args.device)


if __name__ == "__main__":
    main()
