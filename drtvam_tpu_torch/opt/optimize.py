"""Optimization driver + CLI (counterpart of drtvam_tpu/opt/optimize.py).

`optimize(config, device=...)` runs the pattern optimization end to
end on one device: scene assembly, target voxelization, the engine
(the ballistic backprojection or the wavefront path tracer), the
render / loss / adjoint / Linear-L-BFGS loop with pattern clamping and
the convergence break, the final render, and the artifact set
(target.exr/npy, final.exr/npy, loss.npy, timing.npy, per-pattern EXRs,
patterns.npz + normalized uint8, histogram.png). `main()` is the CLI
with dotted -D overrides.

timing.npy: per iteration, column 0 is the primal render + loss wall
time, column 1 the adjoint + optimizer step (direction render and line
search included), each ending in a device synchronize.

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
tracer (ops/render.py) with `spp` / `spp_grad` lanes per pixel. A
Monte-Carlo engine takes seed i at step i, and the line search renders
the direction with the step's seed, the full dose. The final render
runs the scene's own estimator at `spp_ref`, seed 0, `max_depth_ref`
and `rr_depth_ref`. The optimizer is lbfgs. Everything not ported
raises NotImplementedError naming its ROADMAP item.
"""
from __future__ import annotations

import argparse
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
from ..utils.io import save_img, save_vol
from ..utils.metrics import save_histogram
from .device_lbfgs import DeviceLinearLBFGS
from .loss import losses

# options of the JAX driver that this port does not run yet, with the
# ROADMAP queue 1 item that ports them
_NOT_PORTED = {
    "progressive": ("the progressive depth schedule", 12),
    "checkpoint_every": ("checkpointing", 12),
    "resume": ("resuming from a checkpoint", 12),
    "optimize_medium": ("medium optimization", 17),
    "psf_analysis": ("PSF analysis mode", 17),
    "profile": ("device profiling", 17),
}


def _not_ported(what, item):
    return NotImplementedError(
        f"{what} is not ported yet — ROADMAP queue 1 item {item}")


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
        vol = render(data, seed)
        return vol, loss_obj(vol, target, data)

    def adjoint(vol, data, seed):
        v = vol.detach().requires_grad_(True)
        p = data.detach().requires_grad_(True)
        with torch.enable_grad():
            dvol, dpat = torch.autograd.grad(loss_obj(v, target, p), (v, p))
        with torch.no_grad():
            return pattern_grad(dvol, seed) + dpat

    @torch.no_grad()
    def dir_fn(z, seed):
        # the direction renders with the step's seed: the linear line
        # search assumes one realization per step
        return render(z, seed)

    @torch.no_grad()
    def cand_fn(vol, dvol, alpha, z, seed):
        # the sparsity term rides on the SEARCH DIRECTION during the line
        # search (reference quirk)
        return loss_obj(vol + alpha * dvol, target, z)

    return {"primal": primal, "adjoint": adjoint, "dir_fn": dir_fn,
            "cand_fn": cand_fn}


def _check_ported(config, scene):
    for key, (what, item) in _NOT_PORTED.items():
        if config.get(key):
            raise _not_ported(what, item)
    if scene.sensor.surface_aware:
        raise _not_ported("surface-aware films", 14)


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
            img = wavefront.render_radon(
                static_r, scene_tensors(arr_r, device), seed=0,
                spp=config.get("spp_filter_radon", 4), chunk=chunk)
            active = np.nonzero(img.cpu().numpy() > 0.0)[0].astype(np.int32)
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
        img = wavefront.render_corner(
            static_c, scene_tensors(arr_c, device), dist=ccfg["dist"],
            radius=ccfg.get("radius", 0.1), seed=0, chunk=chunk)
        active = np.nonzero(img.cpu().numpy() > 0.0)[0].astype(np.int32)
        if active.size == 0:
            raise ValueError(
                "Corner culling removed every DMD pixel — the corner "
                "radius/dist likely cover the whole aperture.")
        scene.projector.set_active(active, np.zeros(active.size, np.float32))
        ran = True
    return ran


def optimize(config, resolve_path=None, device="cuda", timings=None):
    """Optimize projector patterns for the configured TVAM scene.

    Args:
        config: configuration dict (the JAX package's JSON schema).
        resolve_path: optional relative-path resolver.
        device: torch device the engine and the optimizer run on.
        timings: optional dict, filled with the wall seconds of the
            phases (scene_s, cull_s, precompute_s, loop_s,
            final_render_s, artifacts_s) and the active pixels the
            loop optimizes (active_pixels).
    Returns the final dose volume as a numpy (Z, Y, X, 1) array.
    """
    device = torch.device(device)
    # float32 products stay float32 on the card (stated, and the default)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    timings = {} if timings is None else timings
    config = dict(config)
    if resolve_path is None:
        def resolve_path(p):
            return p

    t0 = time.perf_counter()
    scene = Scene(config, resolve_path)
    if config.get("optimize_medium") and \
            config.get("engine", "auto") in ("ballistic", "hybrid"):
        raise ValueError(
            "optimize_medium requires the wavefront engine; the "
            f"'{config['engine']}' engine precomputes the medium into its "
            "transport fields")
    _check_ported(config, scene)
    output = config["output"]
    os.makedirs(os.path.join(output, "patterns"), exist_ok=True)

    spp = config.get("spp", 4)
    spp_ref = config.get("spp_ref", 16)
    spp_grad = config.get("spp_grad", spp)
    max_depth = config.get("max_depth", 6)
    rr_depth = config.get("rr_depth", 6)
    print_time = config.get("time", 1.0)
    transmission_only = config.get("transmission_only", True)
    regular_sampling = config.get("regular_sampling", False)
    chunk = config.get("chunk_size", wavefront.DEFAULT_CHUNK)
    engine_cfg = config.get("engine", "auto")
    if regular_sampling:
        spp = 1  # rays from pixel centres (spp_grad keeps its value)
    sensor = scene.sensor
    final_sensor = scene.final_sensor

    if sensor.static.estimator == "delta" and scene.medium.albedo == 0.0:
        raise ValueError(
            "the delta-tracking estimator needs a scattering medium "
            "(albedo > 0); use 'dda' or 'ratio' for pure absorption")

    static, arr = scene.build(
        mode="volume", include_target=False, max_depth=max_depth,
        rr_depth=rr_depth, print_time=print_time,
        transmission_only=transmission_only,
        regular_sampling=regular_sampling)
    engine_kind = select_engine(engine_cfg, static)

    if scene.target_dose is not None:
        if config.get("filter_radon", False) or "filter_corner" in config:
            raise ValueError("DMD-pixel culling filters need a target "
                             "mesh, not a dose volume")
        target = scene.target_dose
    else:
        target = np.asarray(sensor.discretize(scene.target_bank()))
        save_vol(target, os.path.join(output, "target.exr"))
    np.save(os.path.join(output, "target.npy"), target)
    target_t = torch.from_numpy(np.ascontiguousarray(target)).to(device)
    timings["scene_s"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    if _cull(config, scene, target, device, rr_depth, transmission_only,
             regular_sampling, chunk):
        static, arr = scene.build(
            mode="volume", include_target=False, max_depth=max_depth,
            rr_depth=rr_depth, print_time=print_time,
            transmission_only=transmission_only,
            regular_sampling=regular_sampling)
        n_dense = int(np.prod(scene.projector.size()))
        print(f"DMD-pixel culling kept {static.projector.n_active} of "
              f"{n_dense} pixels")
    _sync(device)
    timings["cull_s"] = time.perf_counter() - t0
    timings["active_pixels"] = static.projector.n_active

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
    if optim_type in ("adam", "sgd"):
        raise _not_ported(f"the '{optim_type}' optimizer", 11)
    if optim_type != "lbfgs":
        raise ValueError(f"Unknown optimizer type: '{optim_type}'")

    n_steps = config.get("n_steps", 40)
    loss_hist = np.zeros(n_steps)
    timing_hist = np.zeros((n_steps, 2))

    t0 = time.perf_counter()
    inv_vol = float(sensor.inv_volume())
    if engine_kind == "ballistic":
        engine = BallisticEngine(static, arr, device)
        impl = engine.impl

        def render(d, seed):   # deterministic: no seed
            return engine.render_vol(d, inv_vol)

        def pattern_grad(dvol, seed):
            return engine.pattern_grad(dvol, inv_vol)
    elif engine_kind == "hybrid":
        engine = ScatteringEngine(static, arr, device, spp=spp,
                                  spp_grad=spp_grad, chunk=chunk,
                                  estimator=config.get("hybrid_estimator"))
        impl = engine.impl

        def render(d, seed):
            return engine.render_vol(d, inv_vol, seed)

        def pattern_grad(dvol, seed):
            return engine.pattern_grad(dvol, inv_vol, seed)
    else:
        arr_t = scene_tensors(arr, device)
        impl = "cuda" if device.type == "cuda" else "plain"

        def render(d, seed):
            return wavefront.render(static, arr_t, d, inv_vol, seed, spp,
                                    spp_grad, chunk)

        def pattern_grad(dvol, seed):
            return wavefront.adjoint(static, arr_t, seed, spp_grad, chunk,
                                     (dvol * inv_vol).reshape(-1))
    fns = _make_step_fns(render, pattern_grad, loss_obj, target_t)
    opt = DeviceLinearLBFGS(dir_fn=fns["dir_fn"], cand_fn=fns["cand_fn"],
                            **opt_cfg)
    data = torch.as_tensor(scene.projector.active_data, dtype=torch.float32,
                           device=device)
    _sync(device)
    timings["precompute_s"] = time.perf_counter() - t0
    print(f"{engine_kind.capitalize()} engine on {device}: kernels "
          f"'{impl}'")

    print("Starting the pattern optimization loop...")
    t_loop = time.perf_counter()
    vol = grad = None
    for i in range(n_steps):
        t0 = time.perf_counter()
        vol, loss = fns["primal"](data, i)
        loss_hist[i] = float(loss)
        timing_hist[i, 0] = time.perf_counter() - t0

        t1 = time.perf_counter()
        grad = fns["adjoint"](vol, data, i)
        if loss_hist[i] == 0.0:
            print("Converged")
            _sync(device)
            timing_hist[i, 1] = time.perf_counter() - t1
            break
        data = opt.step(data, grad, vol, loss, step_args=(i,))
        _sync(device)
        timing_hist[i, 1] = time.perf_counter() - t1
        print(f"step {i:4d}  loss {loss_hist[i]:.6e}  "
              f"{timing_hist[i].sum():.3f}s")
    timings["loop_s"] = time.perf_counter() - t_loop
    scene.projector.active_data = data
    # free the history and the fields before the final engine is built
    del opt, fns, render, pattern_grad, vol, grad
    engine = arr_t = None

    print("Rendering the final dose volume...")
    t0 = time.perf_counter()
    static_f, arr_f = scene.build(
        mode="volume", include_target=False,
        max_depth=config.get("max_depth_ref", 16),
        rr_depth=config.get("rr_depth_ref", 8), print_time=print_time,
        transmission_only=transmission_only,
        regular_sampling=regular_sampling, sensor=final_sensor)
    inv_vol_f = float(np.float32(1.0 / final_sensor.voxel_volume))
    with torch.no_grad():
        if engine_cfg != "wavefront" and ballistic_eligible(static_f):
            vol_final = BallisticEngine(static_f, arr_f, device).render_vol(
                data, inv_vol_f)
        elif engine_cfg != "wavefront" and hybrid_eligible(static_f):
            # the scene's own estimator, not hybrid_estimator
            vol_final = ScatteringEngine(
                static_f, arr_f, device, spp=spp_ref, chunk=chunk
            ).render_vol(data, inv_vol_f, 0)
        else:
            vol_final = wavefront.render(
                static_f, scene_tensors(arr_f, device), data, inv_vol_f,
                0, spp_ref, spp_ref, chunk)
    vol_final = vol_final.cpu().numpy()
    timings["final_render_s"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    np.save(os.path.join(output, "final.npy"), vol_final)
    save_vol(vol_final, os.path.join(output, "final.exr"))
    np.save(os.path.join(output, "loss.npy"), loss_hist)
    np.save(os.path.join(output, "timing.npy"), timing_hist)

    imgs = scene.projector.patterns(data)
    print("Writing per-pattern EXR images...")
    for k in range(imgs.shape[0]):
        save_img(imgs[k], os.path.join(output, "patterns", f"{k:04d}.exr"))
    np.savez_compressed(os.path.join(output, "patterns.npz"),
                        patterns=imgs)
    array_max = float(np.max(imgs)) if imgs.size else 1.0
    array_max = array_max if array_max > 0 else 1.0
    normalized = imgs / array_max
    np.savez_compressed(
        os.path.join(output, "patterns_normalized_uint8.npz"),
        patterns=(normalized * 255).astype(np.uint8))

    efficiency = float(np.sum(normalized / normalized.size))
    print(f"Pattern energy efficiency: {efficiency:.4f}")
    save_histogram(vol_final, target, os.path.join(output, "histogram.png"),
                   efficiency, array_max)
    timings["artifacts_s"] = time.perf_counter() - t0
    return vol_final


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
                        "optimization (not ported yet).")
    parser.add_argument("--patterns", type=str,
                        help="Patterns file for --forward_mode.")
    args = parser.parse_args(argv)
    if args.forward_mode:
        raise _not_ported("--forward_mode", 15)

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
    optimize(config, resolve_path=make_resolver(base_dir),
             device=args.device)


if __name__ == "__main__":
    main()
