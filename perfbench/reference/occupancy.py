"""The target's binary occupancy on a film, worked out from the phantom's
outline: a voxel is occupied when its centre lies inside the outer ring
and outside the hole (the phantom is a prism through the whole film in
z). Plain NumPy, float64.

`compare` counts the voxels where a film's occupancy differs from this
one, leaving out the columns whose centre lies within `tie` of an edge
of the caps' triangulation: there the parity of a column's crossings
rests on rounding, which any voxelizer settles its own way.
"""
from __future__ import annotations

import numpy as np


def centres(bbox_min, bbox_max, n):
    lo, hi = float(bbox_min), float(bbox_max)
    return lo + (np.arange(n) + 0.5) * (hi - lo) / n


def inside_polygon(px, py, ring):
    """Even-odd test of points (px, py) against a closed ring (n, 2)."""
    x0, y0 = ring[:, 0], ring[:, 1]
    x1, y1 = np.roll(x0, -1), np.roll(y0, -1)
    px, py = px[..., None], py[..., None]
    crosses = (y0 > py) != (y1 > py)
    with np.errstate(divide="ignore", invalid="ignore"):
        xc = x0 + (py - y0) * (x1 - x0) / (y1 - y0)
    return (np.count_nonzero(crosses & (px < xc), axis=-1) % 2) == 1


def column_mask(rings, film):
    """(Y, X) bool: columns inside the outer ring and not in the hole."""
    outer, hole = rings
    xs = centres(film["bbox_min"][0], film["bbox_max"][0], film["res"][0])
    ys = centres(film["bbox_min"][1], film["bbox_max"][1], film["res"][1])
    py, px = np.meshgrid(ys, xs, indexing="ij")
    return inside_polygon(px, py, outer) & ~inside_polygon(px, py, hole)


def occupancy(rings, film):
    """(Z, Y, X) bool occupancy of a prism through the whole film."""
    m = column_mask(rings, film)
    return np.broadcast_to(m, (film["res"][2],) + m.shape)


def _seg_distance(px, py, segs):
    """Distance of each point to the nearest segment (E, 2, 2)."""
    a, b = segs[:, 0], segs[:, 1]
    ab = b - a
    p = np.stack([px, py], -1)[:, None, :]
    t = np.clip(np.sum((p - a) * ab, -1) / np.maximum(np.sum(ab * ab, -1),
                                                       1e-300), 0.0, 1.0)
    q = a + t[..., None] * ab
    return np.sqrt(np.sum((p - q) ** 2, -1)).min(-1)


def compare(film_occ, rings, edges, film, tie=1e-4):
    """Voxels of `film_occ` (Z, Y, X[, 1], > 0.5 occupied) that differ
    from the reference's, outside the `tie` band of the triangulation's
    edges. Returns (count, count within the band)."""
    occ = np.asarray(film_occ).reshape(film["res"][2], film["res"][1],
                                       film["res"][0]) > 0.5
    ref = column_mask(rings, film)
    diff = occ != ref[None]
    if not diff.any():
        return 0, 0
    per_col = diff.sum(0)
    yy, xx = np.nonzero(per_col)
    xs = centres(film["bbox_min"][0], film["bbox_max"][0], film["res"][0])
    ys = centres(film["bbox_min"][1], film["bbox_max"][1], film["res"][1])
    near = np.concatenate([
        _seg_distance(xs[xx[i:i + 2048]], ys[yy[i:i + 2048]], edges) < tie
        for i in range(0, len(yy), 2048)])
    n = per_col[yy, xx]
    return int(n[~near].sum()), int(n[near].sum())


def film_of(sensor):
    """A configuration's sensor as (bbox_min, bbox_max, res (X, Y, Z)):
    the film's `resx` counts voxels along y and `resy` along x (the
    schema's convention), the box is the sensor's scale about the
    origin."""
    f = sensor["film"]
    s = np.array([sensor.get("scalex", 1.0), sensor.get("scaley", 1.0),
                  sensor.get("scalez", 1.0)], np.float64)
    return {"bbox_min": -0.5 * s, "bbox_max": 0.5 * s,
            "res": (int(f.get("resy", 256)), int(f.get("resx", 256)),
                    int(f.get("resz", 256)))}


def inside_grid(xs, ys, ring):
    """(len(ys), len(xs)) bool: inside_polygon on the grid xs x ys, row
    by row (the same crossings, the same even-odd rule)."""
    x0, y0 = ring[:, 0], ring[:, 1]
    x1, y1 = np.roll(x0, -1), np.roll(y0, -1)
    out = np.zeros((len(ys), len(xs)), bool)
    for r, py in enumerate(ys):
        crosses = (y0 > py) != (y1 > py)
        xc = np.sort(x0[crosses] + (py - y0[crosses]) *
                     (x1[crosses] - x0[crosses]) /
                     (y1[crosses] - y0[crosses]))
        out[r] = ((xc.size - np.searchsorted(xc, xs, side="right")) % 2) == 1
    return out


def near_grid(xs, ys, edges, tie):
    """(len(ys), len(xs)) bool: the points of the regular grid xs x ys
    within `tie` (under half a grid step) of a segment (E, 2, 2). Each
    segment is walked along its longer axis, one grid line at a time;
    only the nearest three points across it can be that near."""
    near = np.zeros((len(ys), len(xs)), bool)
    axes = ((xs, ys), (ys, xs))
    for seg in np.asarray(edges, np.float64):
        a, b = seg[0], seg[1]
        k = 0 if abs(b[0] - a[0]) >= abs(b[1] - a[1]) else 1
        along, across = axes[k]
        h_al, h_ac = along[1] - along[0], across[1] - across[0]
        lo, hi = min(a[k], b[k]) - tie, max(a[k], b[k]) + tie
        i = np.arange(max(int(np.ceil((lo - along[0]) / h_al)), 0),
                      min(int(np.floor((hi - along[0]) / h_al)),
                          len(along) - 1) + 1)
        if i.size == 0:
            continue
        den = b[k] - a[k]
        t = np.clip((along[i] - a[k]) / den, 0.0, 1.0) if den != 0 else \
            np.zeros(i.size)
        c = a[1 - k] + t * (b[1 - k] - a[1 - k])
        jc = np.rint((c - across[0]) / h_ac).astype(int)
        for dj in (-1, 0, 1):
            j = np.clip(jc + dj, 0, len(across) - 1)
            pts = np.zeros((i.size, 2))
            pts[:, k], pts[:, 1 - k] = along[i], across[j]
            d = _seg_distance(pts[:, 0], pts[:, 1], seg[None])
            hit = d < tie
            if k == 0:
                near[j[hit], i[hit]] = True
            else:
                near[i[hit], j[hit]] = True
    return near


def subcolumn_counts(rings, edges, film, oversample=4, tie=1e-4):
    """The surface-aware film's inside share of each voxel column, as the
    configuration schema defines it (the target's volume in the voxel,
    its xy cross-section sampled by oversample^2 subcolumns, each
    through the whole film in z for this prism): (Y, X) int counts of
    the subcolumns inside, (lo, hi), where `lo` leaves out and `hi`
    takes in the subcolumns whose centre lies within `tie` of an edge of
    the caps' triangulation."""
    X, Y = film["res"][0], film["res"][1]
    outer, hole = rings
    bmin, bmax = film["bbox_min"], film["bbox_max"]
    s = oversample
    xs = float(bmin[0]) + (np.arange(X * s) + 0.5) * \
        ((float(bmax[0]) - float(bmin[0])) / (X * s))
    ys = float(bmin[1]) + (np.arange(Y * s) + 0.5) * \
        ((float(bmax[1]) - float(bmin[1])) / (Y * s))
    inside = inside_grid(xs, ys, outer) & ~inside_grid(xs, ys, hole)
    near = near_grid(xs, ys, edges, tie)
    shape = (Y, s, X, s)
    lo = (inside & ~near).reshape(shape).sum((1, 3))
    hi = (inside | near).reshape(shape).sum((1, 3))
    return lo, hi


def compare_fractions(volumes, rings, edges, zrange, film, oversample=4,
                      tie=1e-4, tol=1e-3):
    """Voxels of a surface-aware film's (Z, Y, X, 2) inside / outside
    volumes whose inside share, in subcolumns (oversample^2 share),
    lies outside the reference's: [lo, hi] subcolumns times the voxel's
    share of the prism's z range `zrange`, taken `tie` narrower and
    wider (the caps' heights round in float32), less and more `tol`."""
    v = np.asarray(volumes, np.float64)
    tot = v[..., 0] + v[..., 1]
    share = np.where(tot > 0, v[..., 0] / np.where(tot > 0, tot, 1.0), 0.0)
    n = share * oversample * oversample
    lo, hi = subcolumn_counts(rings, edges, film, oversample, tie)
    Z = film["res"][2]
    z0, z1 = float(film["bbox_min"][2]), float(film["bbox_max"][2])
    vz = (z1 - z0) / Z
    zl = z0 + vz * np.arange(Z)

    def overlap(a, b):
        return np.clip(np.minimum(b, zl + vz) - np.maximum(a, zl), 0.0,
                       None) / vz
    ov_lo = overlap(zrange[0] + tie, zrange[1] - tie)[:, None, None]
    ov_hi = overlap(zrange[0] - tie, zrange[1] + tie)[:, None, None]
    bad = (n < lo[None] * ov_lo - tol) | (n > hi[None] * ov_hi + tol) | \
        ~(tot > 0)
    return int(np.count_nonzero(bad))
