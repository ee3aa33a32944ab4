"""Best IoU of a thresholded dose against a binary target: the upstream
reference's sweep, 301 thresholds in [0, 1.3] (the port's
utils/metrics.py iou_sweep arithmetic, copied): with the object and
void doses sorted once, |pred & obj|(t) = #object doses > t and
|pred | obj|(t) = |obj| + #void doses > t."""
from __future__ import annotations

import numpy as np

N_THRESHOLDS = 301


def best_iou(vol, target, n_thresholds=N_THRESHOLDS):
    """(best IoU, its threshold)."""
    v = np.asarray(vol, np.float64).ravel()
    obj = np.asarray(target).ravel() > 0.0
    vo = np.sort(v[obj])
    vv = np.sort(v[~obj])
    t = np.linspace(0.0, 1.3, n_thresholds)
    inter = vo.size - np.searchsorted(vo, t, side="right")
    union = vo.size + vv.size - np.searchsorted(vv, t, side="right")
    ious = inter / np.maximum(union, 1)
    k = int(np.argmax(ious))
    return float(ious[k]), float(t[k])
