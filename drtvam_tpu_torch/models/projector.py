"""DMD projectors: the sparse pattern store (counterpart of
drtvam_tpu/models/projector.py:32-222).

Patterns live as a sparse pair: `active_data` float values and
`active_pixels` flat indices into the dense (n_patterns, resy, resx)
stack, with crop-window support. Host numpy storage; the ballistic
engine moves what it needs to the device once.

Per-lane ray sampling (projector.py:224-315) belongs to the wavefront
path tracer, ROADMAP queue 1 item 10.
"""
from __future__ import annotations

import glob
import os
from dataclasses import dataclass

import numpy as np

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
