"""DMD projectors: the sparse pattern store and per-lane ray sampling
(counterpart of drtvam_tpu/models/projector.py).

Patterns live as a sparse pair: `active_data` float values and
`active_pixels` flat indices into the dense (n_patterns, resy, resx)
stack, with crop-window support. Host numpy storage; the engines move
what they need to the device once.

`sample_rays` and `ray_weight` generate the wavefront's rays: lane ->
(pattern, pixel row and column) -> a jittered position in [0, 1]^2 ->
a camera-space ray of the projection model (collimated, telecentric,
lens) -> world space through the circular-motion look-at frame at
time = pattern / n_patterns. The CUDA kernels (csrc/wf_trace.cuh)
repeat the same arithmetic in the same order.
"""
from __future__ import annotations

import glob
import os
from dataclasses import dataclass

import numpy as np
import torch

from ..core.warp import TWO_PI, square_to_uniform_disk_concentric
from .motion import motions


def load_patterns(filepath):
    """Load a (n, h, w) pattern stack from .npy / single-array .npz /
    a directory of EXR images."""
    if os.path.isfile(filepath):
        if filepath.endswith(".npy"):
            return np.load(filepath).astype(np.float32)
        if filepath.endswith(".npz"):
            z = np.load(filepath)
            if len(z.files) != 1:
                raise ValueError(
                    f"Expected a single array in the npz file, got "
                    f"{len(z.files)}.")
            return z[z.files[0]].astype(np.float32)
        raise ValueError(
            f"Unsupported file format for patterns: "
            f"{os.path.splitext(filepath)[1]}")
    filenames = sorted(glob.glob(os.path.join(filepath, "*.exr")))
    if not filenames:
        raise ValueError("No patterns found in the specified directory. "
                         "Please make sure the patterns are in EXR format.")
    from ..utils.io import read_exr
    imgs = [read_exr(fn) for fn in filenames]
    h, w = imgs[0].shape[:2]
    for fn, im in zip(filenames, imgs):
        if im.shape[:2] != (h, w):
            raise ValueError(f"File '{fn}' has a different resolution.")
    return np.stack([im[..., 0] if im.ndim == 3 else im for im in imgs])


@dataclass(frozen=True)
class ProjectorStatic:
    """Hashable projector configuration."""
    kind: str                 # 'collimated' | 'telecentric' | 'lens'
    n_patterns: int
    resx: int
    resy: int
    n_active: int
    # the sparse store is the dense identity map (no culling or crop)
    identity: bool = False
    # the active indices [lo, hi) a render traces (a rank's block,
    # parallel/shard.py); None: every active pixel. The store, the inputs
    # and the pattern gradient stay whole, so that every lane keeps its id
    # and its random stream
    block: tuple = None


class Projector:
    """Host-side projector state and its motion model."""

    def __init__(self, props, resolve_path=lambda p: p):
        kind = props["type"]
        if kind not in ("collimated", "telecentric", "lens"):
            raise ValueError(f"Unknown projector type: '{kind}'")
        self.kind = kind

        if "patterns" in props:
            pat = props["patterns"]
            if isinstance(pat, str):
                pat = load_patterns(resolve_path(pat))
            pat = np.asarray(pat, np.float32)
            if pat.ndim != 3:
                raise ValueError(
                    f"Patterns must be 3D, got shape {pat.shape}.")
            n, h, w = pat.shape
            self.n_patterns, self.resy, self.resx = n, h, w
            self.crop = (w, h)
            self.crop_offset = (0, 0)
            if props.get("filter_nonzero", False):
                flat = pat.reshape(-1)
                idx = np.nonzero(flat > 0)[0].astype(np.int32)
                self.active_pixels = idx
                self.active_data = flat[idx]
                self.dense_identity = False
            else:
                self.active_data = pat.reshape(-1)
                self.active_pixels = np.arange(n * h * w, dtype=np.int32)
                self.dense_identity = True
        else:
            self.n_patterns = int(props.get("n_patterns", 1000))
            self.resx = int(props.get("resx", 256))
            self.resy = int(props.get("resy", 256))
            cropx = int(props.get("cropx", self.resx))
            cropy = int(props.get("cropy", self.resy))
            if cropx > self.resx or cropy > self.resy:
                raise ValueError("Crop resolution must be smaller than the "
                                 "base resolution.")
            ox = int(props.get("crop_offset_x", 0))
            oy = int(props.get("crop_offset_y", 0))
            if ox + cropx > self.resx or oy + cropy > self.resy:
                raise ValueError("Cropped region extends beyond the base "
                                 "resolution.")
            self.crop = (cropx, cropy)
            self.crop_offset = (ox, oy)
            self.dense_identity = (cropx == self.resx and
                                   cropy == self.resy)
            if self.dense_identity:
                flat = np.arange(self.n_patterns * self.resx * self.resy,
                                 dtype=np.int32)
            else:
                # flat indices of the cropped window, tiled per pattern
                ci = np.arange(cropx * cropy, dtype=np.int32)
                crow, ccol = ci // cropx, ci % cropx
                pix = (oy + crow) * self.resx + ccol + ox
                stride = np.int32(self.resx * self.resy)
                flat = (pix[None, :] + stride * np.arange(
                    self.n_patterns, dtype=np.int32)[:, None]).reshape(-1)
            self.active_pixels = flat
            self.active_data = np.zeros((flat.size,), np.float32)

        # projection-model parameters
        ps = props.get("pixel_size")
        self.aperture_radius = float(props.get("aperture_radius", 0.0))
        self.focus_distance = float(props.get("focus_distance", 0.0))
        if kind == "lens":
            if ("fov" in props) == ("pixel_size" in props):
                raise ValueError("[lens] specify exactly one of 'fov' and "
                                 "'pixel_size'.")
            if "fov" in props:
                self.fov = float(props["fov"])
                ps = np.tan(np.deg2rad(self.fov) / 2) * 2 * \
                    self.focus_distance / self.resx
            else:
                ps = float(props["pixel_size"])
                self.fov = np.rad2deg(2 * np.arctan(
                    ps * self.resx / 2 / self.focus_distance))
        if ps is None:
            raise ValueError(f"[{kind}] missing 'pixel_size'")
        self.pixel_size = (float(ps), float(ps)) if np.isscalar(ps) \
            else (float(ps[0]), float(ps[1]))

        if "motion" not in props:
            raise ValueError("Missing field 'motion'.")
        m = props["motion"]
        if isinstance(m, str):
            if m not in motions:
                raise ValueError(f"Invalid motion type: {m}")
            self.motion = motions[m](props)
        elif isinstance(m, dict):
            self.motion = motions[m["type"]](m | props)
        else:
            self.motion = m

    # -- pattern store -----------------------------------------------------

    def active_size(self):
        return int(self.active_data.shape[0])

    def size(self):
        return (self.n_patterns, self.resy, self.resx)

    def patterns(self, active_data=None):
        """Re-scatter sparse storage to the dense (n, resy, resx) stack."""
        data = self.active_data if active_data is None else active_data
        if hasattr(data, "detach"):
            data = data.detach().cpu().numpy()
        data = np.asarray(data, np.float32)
        dense = np.zeros((self.n_patterns * self.resy * self.resx,),
                         np.float32)
        dense[np.asarray(self.active_pixels)] = data
        return dense.reshape(self.n_patterns, self.resy, self.resx)

    def set_active(self, active_pixels, active_data):
        """Replace the sparse store; checks the pair before changing any
        state."""
        pixels = np.asarray(active_pixels, np.int32)
        data = np.asarray(active_data, np.float32)
        if data.shape != pixels.shape:
            raise ValueError("active_data and active_pixels must have the "
                             "same length.")
        self.active_pixels = pixels
        self.active_data = data
        self.dense_identity = False

    def static(self):
        return ProjectorStatic(self.kind, self.n_patterns, self.resx,
                               self.resy, self.active_size(),
                               identity=bool(self.dense_identity))

    def arrays(self):
        return {
            "active_pixels": np.asarray(self.active_pixels, np.int32),
            "pixel_size": np.asarray(self.pixel_size, np.float32),
            "aperture_radius": np.float32(self.aperture_radius),
            "focus_distance": np.float32(self.focus_distance),
            "motion_distance": np.float32(self.motion.distance),
        }


PROJECTOR_KINDS = ("collimated", "telecentric", "lens")


def _cross(a, b):
    return torch.stack([a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
                        a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
                        a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]], -1)


def _norm(v):
    return torch.sqrt(v[..., 0] * v[..., 0] + v[..., 1] * v[..., 1] +
                      v[..., 2] * v[..., 2])[..., None]


def _rotate(cols, v):
    """sum_j cols[j] * v[..., j], in index order."""
    return cols[0] * v[..., 0:1] + cols[1] * v[..., 1:2] + \
        cols[2] * v[..., 2:3]


def sample_rays(pstat: ProjectorStatic, parr, active_pixels, lane, spp,
                sampler, ctr, regular_sampling, sample_time, clockwise):
    """Per-lane rays. lane: (n,) int64 global lane ids (uint32 values);
    the active index is lane // spp. parr: the scene's tensors
    (pixel_size, aperture_radius, focus_distance, motion_distance).
    Three draws per lane: position (2d), time (1d), aperture (2d).
    Returns (o, d, aidx, ctr)."""
    dev = lane.device
    aidx = lane // spp
    idx = aidx if pstat.identity else active_pixels[aidx].to(torch.int64)
    w, h = pstat.resx, pstat.resy
    emitter_idx = idx // (h * w)
    pixel_idx = idx % (h * w)
    py = pixel_idx // w
    px = pixel_idx - py * w
    pos = torch.stack([px, py], -1).to(torch.float32)

    u_pos, ctr = sampler.next_2d(lane, ctr)
    pos_f = pos + 0.5 if regular_sampling else pos + u_pos
    s = pos_f / torch.tensor([w, h], dtype=torch.float32, device=dev)

    u_t, ctr = sampler.next_1d(lane, ctr)
    time = emitter_idx.to(torch.float32)
    if sample_time:
        time = time + u_t
    time = time / torch.tensor(pstat.n_patterns, dtype=torch.float32,
                               device=dev)

    u_ap, ctr = sampler.next_2d(lane, ctr)

    psx, psy = parr["pixel_size"][0], parr["pixel_size"][1]
    ex, ey = w * psx, h * psy
    zero = torch.zeros_like(s[..., 0])
    focus = parr["focus_distance"]
    if pstat.kind == "collimated":
        o_cam = torch.stack([(0.5 - s[..., 0]) * ex,
                             (0.5 - s[..., 1]) * ey, zero], -1)
        d_cam = torch.stack([zero, zero, zero + 1.0], -1)
    elif pstat.kind == "telecentric":
        ap = parr["aperture_radius"] * square_to_uniform_disk_concentric(u_ap)
        o_cam = torch.stack([(0.5 - s[..., 0]) * ex + ap[..., 0],
                             (0.5 - s[..., 1]) * ey + ap[..., 1], zero], -1)
        d = torch.stack([-ap[..., 0], -ap[..., 1], zero + focus], -1)
        d_cam = d / _norm(d)
    elif pstat.kind == "lens":
        ap = parr["aperture_radius"] * square_to_uniform_disk_concentric(u_ap)
        o_cam = torch.stack([ap[..., 0], ap[..., 1], zero], -1)
        focus_p = torch.stack([(0.5 - s[..., 0]) * ex,
                               (0.5 - s[..., 1]) * ey, zero + focus], -1)
        d = focus_p - o_cam
        d_cam = d / _norm(d)
    else:
        raise ValueError(pstat.kind)

    # circular motion look-at (world-from-camera)
    alpha = TWO_PI * time
    if clockwise:
        alpha = -alpha
    origin = parr["motion_distance"] * torch.stack(
        [torch.cos(alpha), torch.sin(alpha), torch.zeros_like(alpha)], -1)
    dirw = -origin / _norm(origin)
    up = torch.zeros_like(dirw)
    up[..., 2] = 1.0
    left = _cross(up, dirw)
    left = left / _norm(left)
    up2 = _cross(dirw, left)
    cols = (left, up2, dirw)
    return _rotate(cols, o_cam) + origin, _rotate(cols, d_cam), aidx, ctr


def ray_weight(pstat: ProjectorStatic, parr, spp, print_time):
    """inv_pdf / n_samples * print_time, the same for every lane: the
    pixel area (pixel_size[0]^2 for a lens) x print_time / spp, as a
    float32 0-dim tensor."""
    ps = parr["pixel_size"]
    area = ps[0] * ps[0] if pstat.kind == "lens" else ps[0] * ps[1]
    return area * print_time / torch.tensor(spp, dtype=torch.float32,
                                            device=ps.device)
