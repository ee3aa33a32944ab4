"""The ballistic engine's z-resample tap tables for a projector and film
given by their sizes alone, for the resample's tests on the CPU
(test_torch_ballistic.py) and on the card (test_torch_cuda.py). Free of
jax."""
from types import SimpleNamespace as NS

import numpy as np
import torch


def z_taps(resy, Z, regular, pixel=0.025, height=10.0):
    """The tap tables of `resy` DMD rows of `pixel` mm over a Z-row film
    `height` mm tall (the cells: 400 rows of 25 um over 256 rows of
    10 mm): (zt_i, zt_w, rt_i, rt_w)."""
    from drtvam_tpu_torch.ops.ballistic import BallisticEngine, z_tap_tables
    from drtvam_tpu_torch.ops.transport2d import build_z_resample
    h = np.float32(height / 2)
    static = NS(projector=NS(resy=resy), sensor=NS(res=(1, 1, Z)),
                regular_sampling=regular)
    arr = {"pixel_size": np.float32([pixel, pixel]),
           "bbox_min": np.float32([-h, -h, -h]),
           "bbox_max": np.float32([h, h, h])}
    taps = z_tap_tables(build_z_resample(static, arr),
                        BallisticEngine._MAX_TAPS)
    assert taps is not None
    return [torch.from_numpy(t) for t in taps]
