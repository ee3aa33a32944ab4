"""Print-quality metrics + dose histogram artifact (counterpart of
drtvam_tpu/utils/metrics.py, numpy only).

`save_histogram` reports the dose distributions of object and void
voxels, sweeps thresholds in [0, 1.3] for the best IoU, and writes
histogram.png. The image is drawn and encoded here with numpy and zlib
(no plotting package): log-count histograms of both voxel sets over
doses [0, 1.2], with the title line stored as a PNG text chunk.
"""
from __future__ import annotations

import struct
import zlib

import numpy as np


def iou(pred, target, threshold=0.9):
    """Intersection-over-union of thresholded dose vs binary target."""
    pred = np.asarray(pred).ravel()
    target = np.asarray(target).ravel()
    obj = target > 0.0
    thr = pred > threshold
    union = np.count_nonzero(thr | obj)
    if union == 0:
        return float("nan")
    return np.count_nonzero(thr & obj) / union


# the reference's name
iou_loss = iou


def iou_sweep(vol, target, thresholds):
    """IoU of (vol > t) against (target > 0) for every threshold t,
    exact: with the object and void doses sorted once,
    |pred & obj|(t) = #object doses > t and
    |pred | obj|(t) = |obj| + #void doses > t."""
    v = np.asarray(vol, np.float64).ravel()
    obj = np.asarray(target).ravel() > 0.0
    vo = np.sort(v[obj])
    vv = np.sort(v[~obj])
    t = np.asarray(thresholds, np.float64)
    inter = vo.size - np.searchsorted(vo, t, side="right")
    union = vo.size + vv.size - np.searchsorted(vv, t, side="right")
    return inter / np.maximum(union, 1)


def best_iou(vol, target, n_thresholds=300):
    """(best IoU, its threshold) over n thresholds in [0, 1.3]."""
    thresholds = np.linspace(0, 1.3, n_thresholds)
    ious = iou_sweep(vol, target, thresholds)
    best = int(np.argmax(ious))
    return float(ious[best]), float(thresholds[best])


def _png(path, rgb, text):
    """Write an (H, W, 3) uint8 image as PNG with tEXt chunks."""
    def chunk(tag, data):
        return struct.pack(">I", len(data)) + tag + data + \
            struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF)

    h, w, _ = rgb.shape
    raw = np.concatenate([np.zeros((h, 1), np.uint8),
                          rgb.reshape(h, w * 3)], axis=1).tobytes()
    out = b"\x89PNG\r\n\x1a\n"
    out += chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
    for key, val in text.items():
        out += chunk(b"tEXt", key.encode("latin1") + b"\0" +
                     val.encode("latin1"))
    out += chunk(b"IDAT", zlib.compress(raw, 6))
    out += chunk(b"IEND", b"")
    with open(path, "wb") as f:
        f.write(out)


def _draw_histograms(sets, colors, bins=500, dose_max=1.2, height=400):
    """Overlaid log-count histograms, one column of pixels per bin."""
    img = np.full((height, bins, 3), 255.0)
    edges = np.linspace(0.0, dose_max, bins + 1)
    counts = [np.histogram(s, bins=edges)[0] for s in sets]
    top = max(1.0, max(np.log10(c.max() + 1.0) for c in counts))
    rows = np.arange(height)[::-1, None]           # 0 at the bottom
    for c, color in zip(counts, colors):
        bar = rows < (np.log10(c + 1.0) / top * (height - 1))[None, :]
        img[bar] = 0.45 * img[bar] + 0.55 * np.asarray(color, float)
    img[[0, -1], :] = 0.0
    img[:, [0, -1]] = 0.0
    return img.astype(np.uint8)


def save_histogram(vol, target, filename, efficiency, max_pattern_intensity,
                   n_thresholds=300, verbose=True):
    """Dose histogram PNG + best-IoU threshold sweep over [0, 1.3].
    Returns (best_iou, best_threshold)."""
    vol = np.asarray(vol)
    target = np.asarray(target)
    obj_mask = target.ravel() > 0.0
    voxels = vol.ravel()

    if verbose:
        print("Finding threshold for best IoU ...")
    best, thr = best_iou(vol, target, n_thresholds)
    if verbose:
        print("Best IoU: {:.4f}".format(best))
        print("Best threshold: {:4f}".format(thr))

    title = ("pattern energy efficiency = {:.4f}, IoU = {:.4f} at "
             "threshold = {:.3f}, normalized threshold = {:.3f}".format(
                 efficiency, best, thr, thr / max_pattern_intensity))
    img = _draw_histograms([voxels[obj_mask], voxels[~obj_mask]],
                           [(31, 119, 180), (255, 127, 14)])
    _png(filename, img, {"Title": title,
                         "Comment": "# voxels (log) vs received dose "
                                    "[0, 1.2]; blue: object, orange: "
                                    "empty"})
    return best, thr
