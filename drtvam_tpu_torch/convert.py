"""State carried across from the JAX package, so both packages can be fed
identical inputs.

The functions read dataclass fields and numpy arrays only: they take
what the JAX package produced (converted to numpy by the caller, e.g.
with np.asarray) and never import jax or drtvam_tpu.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .models.projector import ProjectorStatic
from .models.sensor import SensorStatic
from .ops.march import MarchStatic, SurfaceStatic
from .ops.mesh_grid import TriGridStatic
from .ops.transport2d import chord_pack
from .opt.device_lbfgs import is_bf16_bits, rows_from_numpy


def _fields(obj, cls, **override):
    """cls from obj's fields of the same names; a field the JAX package
    has no counterpart of (ProjectorStatic.block) keeps its
    default."""
    kw = {f.name: getattr(obj, f.name) for f in dataclasses.fields(cls)
          if hasattr(obj, f.name)}
    kw.update(override)
    return cls(**kw)


def scene_from_jax(static, arr):
    """The JAX package's (MarchStatic, arr) -> the port's.

    static: a drtvam_tpu MarchStatic; arr: its dict of arrays (numpy or
    anything np.asarray accepts). A chord bank in arr (the four arrays
    of drtvam_tpu's build_chords as "chord_o", "chord_d", "chord_L",
    "chord_amp", as its tests stash them) becomes the port's one
    "chord_pack" record table, so the port's march reads the JAX
    package's bank. A mesh surface's grid becomes the port's
    TriGridStatic; its banks (tri_*, grid_*) are the same arrays in both
    packages, so they pass as they are."""
    surfaces = []
    for s in static.surfaces:
        grid = None if s.grid is None else _fields(
            s.grid, TriGridStatic, res=tuple(s.grid.res))
        surfaces.append(_fields(s, SurfaceStatic,
                                tri_slice=tuple(s.tri_slice), grid=grid))
    port = _fields(static, MarchStatic, surfaces=tuple(surfaces),
                   projector=_fields(static.projector, ProjectorStatic),
                   sensor=_fields(static.sensor, SensorStatic,
                                  res=tuple(static.sensor.res)))
    arr = {k: np.asarray(v) for k, v in arr.items()}
    bank = ("chord_o", "chord_d", "chord_L", "chord_amp")
    if all(k in arr for k in bank):
        arr["chord_pack"] = chord_pack(
            *(torch.tensor(arr.pop(k)) for k in bank)).numpy()
    return port, arr


def _rows(x, device):
    """A history buffer as numpy -> torch, keeping its type: float32, or
    bfloat16 (ml_dtypes' numpy type, the '|V2' void type numpy reads a
    saved one back as, or its uint16 / int16 bits; read through its
    bits, so that ml_dtypes need not be importable here)."""
    x = np.asarray(x)
    dtype = torch.bfloat16 if is_bf16_bits(x) else torch.float32
    return rows_from_numpy(x, dtype, x.shape, device)


def lbfgs_state_from_numpy(state, device="cpu"):
    """A fused_linear_lbfgs loop state (its dict, values as numpy) ->
    the state linear_lbfgs resumes from, on `device`. S and Yh keep the
    history's type (float32 or bfloat16)."""
    def vec(k):
        return torch.as_tensor(np.array(state[k], np.float32),
                               device=device).contiguous()

    return dict(
        i=int(state["i"]), done=bool(state["done"]),
        p=vec("p"), p_old=vec("p_old"), g_old=vec("g_old"),
        S=_rows(state["S"], device), Yh=_rows(state["Yh"], device),
        ys=vec("ys"), head=int(state["head"]), nvalid=int(state["nvalid"]),
        loss_hist=vec("loss_hist"))
