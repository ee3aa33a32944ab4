"""Uniform-grid triangle acceleration for the march's mesh intersection
(counterpart of drtvam_tpu/ops/mesh_grid.py).

  * `build_tri_grid` (host, numpy; the JAX package's own, copied): bins
    a mesh's triangles into a uniform 3D grid sized to ~2 cells a
    triangle, stored CSR (cell_start, tri_ids) over x-major cells.
  * `ray_triangles_grid` (plain torch): a 3D-DDA walk over the cells;
    each cell's triangle list is tested in 8-wide Moller-Trumbore
    chunks, and a lane stops at the first cell whose exit plane lies
    beyond its best hit (conservatively: t_best <= t_exit (1 + 1e-6) +
    1e-6), stepping one axis at a time (the first on a tie).

Same contract as ray_triangles: (t, tri), t = +inf and tri = -1 on a
miss, hits strictly beyond the per-lane tmin. The CUDA kernels run the
same walk in csrc/wf_mesh.cuh, float operation for float operation.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import numpy as np
import torch

from .intersect import INF, moller_trumbore

# below this many triangles the brute-force sweep is cheaper than the walk
GRID_MIN_TRIS = 96


@dataclass(frozen=True)
class TriGridStatic:
    """Static metadata of one mesh's grid inside the merged scene banks;
    the arrays are arr['grid_*']."""
    res: Tuple[int, int, int]
    cell_offset: int     # into arr['grid_cell_start'] (n_cells + 1 entries)
    ids_offset: int      # into arr['grid_tri_ids']
    n_ids: int
    bbox_row: int        # into arr['grid_bbox'] (n_grids, 2, 3)


def build_tri_grid(v0, e1, e2, cells_per_tri=2.0, max_res=128):
    """Host-side uniform grid over a triangle bank.

    Returns (res, cell_start, tri_ids, bmin, bmax): cell_start has
    prod(res) + 1 entries (CSR over flattened x-major cells), tri_ids
    lists the triangle indices of each cell."""
    v0 = np.asarray(v0, np.float32)
    e1 = np.asarray(e1, np.float32)
    e2 = np.asarray(e2, np.float32)
    T = v0.shape[0]
    p1 = v0 + e1
    p2 = v0 + e2
    tmin = np.minimum(np.minimum(v0, p1), p2)
    tmax = np.maximum(np.maximum(v0, p1), p2)
    bmin = tmin.min(0)
    bmax = tmax.max(0)
    ext = np.maximum(bmax - bmin, 1e-6)
    # pad so that border triangles never index out
    bmin = bmin - 1e-4 * ext
    bmax = bmax + 1e-4 * ext
    ext = bmax - bmin

    vol = float(np.prod(ext))
    lam = (cells_per_tri * T / max(vol, 1e-30)) ** (1.0 / 3.0)
    res = np.clip(np.round(ext * lam).astype(np.int64), 1, max_res)

    # AABB binning over-counts long diagonal slivers: halve the
    # resolution until the (triangle, cell) pair count is bounded
    while True:
        inv_cell = res / ext
        lo = np.clip(((tmin - bmin) * inv_cell).astype(np.int32),
                     0, res - 1)
        hi = np.clip(((tmax - bmin) * inv_cell).astype(np.int32),
                     0, res - 1)
        nx = hi - lo + 1                   # (T, 3) cells per axis
        cnt = nx.prod(1, dtype=np.int64)
        total = int(cnt.sum())
        if total <= 16 * T or int(res.max()) <= 4:
            break
        res = np.maximum(res // 2, 1)

    gx, gy, gz = int(res[0]), int(res[1]), int(res[2])
    n_cells = gx * gy * gz
    tri_rep = np.repeat(np.arange(T, dtype=np.int64), cnt)
    starts = np.zeros(T, np.int64)
    np.cumsum(cnt[:-1], out=starts[1:])
    loc = np.arange(total, dtype=np.int64) - np.repeat(starts, cnt)
    lx = nx[tri_rep]
    ix = loc % lx[:, 0]
    rem = loc // lx[:, 0]
    iy = rem % lx[:, 1]
    iz = rem // lx[:, 1]
    cell = (lo[tri_rep, 0] + ix) + gx * (
        (lo[tri_rep, 1] + iy) + gy * (lo[tri_rep, 2] + iz))

    order = np.argsort(cell, kind="stable")
    tri_ids = tri_rep[order].astype(np.int32)
    counts = np.bincount(cell, minlength=n_cells)
    cell_start = np.zeros(n_cells + 1, np.int32)
    np.cumsum(counts, out=cell_start[1:])
    return ((gx, gy, gz), cell_start, tri_ids,
            bmin.astype(np.float32), bmax.astype(np.float32))


def ray_triangles_grid(o, d, tmin, v0, e1, e2, cell_start, tri_ids,
                       bmin, bmax, res, chunk=8, stats=None, count=None):
    """Nearest triangle hit by a 3D-DDA walk over one mesh's grid.

    o, d (N, 3), tmin (N,): the rays; v0 / e1 / e2: the mesh's triangle
    bank the grid indexes into; cell_start / tri_ids / bmin / bmax: its
    grid (build_tri_grid), as tensors on o's device; res: (gx, gy, gz).
    Each walk step runs on the lanes still walking. stats: adds, over the
    rays where `count` (N,) bool is set, the walks that enter the grid's
    box ("walks"), the cells they visit ("cells") and the triangles they
    test ("triangles"), as the kernels count them (csrc/wf_mesh.cuh)."""
    gx, gy, gz = res
    dev = o.device
    n_ids = tri_ids.shape[0]
    res_v = torch.tensor([gx, gy, gz], dtype=torch.int32, device=dev)
    cell_w = (bmax - bmin) / torch.tensor([gx, gy, gz], dtype=torch.float32,
                                          device=dev)
    n = o.shape[0]
    big = torch.abs(d) > 1e-20
    safe_d = torch.where(big, d, torch.full_like(d, 1e-20))
    tb0 = (bmin - o) / safe_d
    tb1 = (bmax - o) / safe_d
    t_enter = torch.maximum(torch.minimum(tb0, tb1).amax(-1), tmin)
    t_exit = torch.maximum(tb0, tb1).amin(-1)
    alive = (t_enter <= t_exit) & torch.isfinite(t_enter)
    if stats is not None:
        stats["walks"] = stats.get("walks", 0) + int((alive & count).sum())

    eps_t = 1e-5 * torch.clamp(torch.abs(t_enter), min=1.0)
    p_in = o + (t_enter + eps_t)[:, None] * d
    ivec = torch.clamp(((p_in - bmin) / cell_w).to(torch.int32),
                       torch.zeros_like(res_v), res_v - 1)
    step = torch.where(d > 0, 1, -1).to(torch.int32)
    next_b = bmin + (ivec + (step > 0).to(torch.int32)).to(torch.float32) \
        * cell_w
    tmaxv = torch.where(big, (next_b - o) / safe_d, torch.full_like(d, INF))
    tdelta = torch.abs(cell_w / safe_d)

    t_best = torch.full((n,), INF, dtype=torch.float32, device=dev)
    i_best = torch.full((n,), -1, dtype=torch.int64, device=dev)
    lane_k = torch.arange(chunk, dtype=torch.int64, device=dev)
    n_cells = gx * gy * gz
    while True:
        L = torch.nonzero(alive).squeeze(1)
        if L.numel() == 0:
            break
        iv, tm = ivec[L], tmaxv[L]
        ol, dl, tl = o[L], d[L], tmin[L]
        tb, ib = t_best[L], i_best[L]
        flat = iv[:, 0].to(torch.int64) + gx * (
            iv[:, 1].to(torch.int64) + gy * iv[:, 2].to(torch.int64))
        flat = torch.clamp(flat, 0, n_cells - 1)
        s = cell_start[flat].to(torch.int64)
        cnt = cell_start[flat + 1].to(torch.int64) - s
        if stats is not None:
            cl = count[L]
            stats["cells"] = stats.get("cells", 0) + int(cl.sum())
            stats["triangles"] = stats.get("triangles", 0) + \
                int(cnt[cl].sum())
        for k in range(0, int(cnt.max()), chunk):
            idx = s[:, None] + k + lane_k
            valid = idx < (s + cnt)[:, None]
            ids = tri_ids[torch.clamp(idx, 0, n_ids - 1)].to(torch.int64)
            t = moller_trumbore(ol, dl, tl, v0[ids], e1[ids], e2[ids], valid)
            j = torch.argmin(t, -1)[:, None]
            t_c = torch.gather(t, -1, j)[:, 0]
            better = t_c < tb
            tb = torch.where(better, t_c, tb)
            ib = torch.where(better, torch.gather(ids, -1, j)[:, 0], ib)
        t_best[L], i_best[L] = tb, ib

        t_cell_exit = tm.amin(-1)
        # a hit before the cell's exit plane ends the walk
        done = tb <= t_cell_exit * (1.0 + 1e-6) + 1e-6
        # step along the nearest exit axis, the first one on a tie
        axis_min = t_cell_exit[:, None] == tm
        axis_min = axis_min & (torch.cumsum(axis_min.to(torch.int32), -1)
                               == 1)
        iv_n = iv + torch.where(axis_min, step[L], torch.zeros_like(iv))
        tm_n = tm + torch.where(axis_min, tdelta[L], torch.zeros_like(tm))
        in_grid = ((iv_n >= 0) & (iv_n < res_v)).all(-1)
        go = ~done & in_grid & ~(t_cell_exit > t_exit[L])
        ivec[L] = torch.where(go[:, None], iv_n, iv)
        tmaxv[L] = torch.where(go[:, None], tm_n, tm)
        alive[L] = go
    return t_best, i_best
