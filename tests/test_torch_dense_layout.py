"""The layouts the redesigned dense kernels read, held on the CPU.

bp_fwd stages, per (angle, 32x32 film tile), the exact column window of
the tile's taps (`tile_windows`); bp_bwd re-lays dL out z innermost
(`transpose_dl`) and walks, per angle, the voxels grouped by floor(u)
(`voxel_lists`) in runs of 16 columns. The kernels cannot run here, so
two torch emulations below consume exactly what they consume, run by
run and tile by tile, and are held against the port's plain versions
and the JAX package's _fwd_xla / _bwd_xla at rtol 1e-5, atol 1e-5*max
(f32 sums in another order). Cases: empty cells (u = -2), taps at
columns 0 and U-1 dropped at the edges, columns without entries, Zf not
a multiple of the z-chunk (20, 30), films that do not tile into 32x32,
and a refracted cylindrical scene whose tile windows exceed 256
columns."""
import numpy as np
import pytest
import torch

from drtvam_tpu.ops import backproject as jbp
from drtvam_tpu_torch.ops import backproject as tbp

from test_backproject_banded import _fields as banded_fields
from test_backproject_plain import _fields as wide_fields
from torch_threads import one_torch_thread  # noqa: F401

TOL = 1e-5
RUN = 16  # columns per warp in bp_bwd


def _edge_fields(seed=0, A=3, Y=32, X=64, U=50, Zf=20):
    """u over [-1.5, U + 0.5): taps at -1 and U are dropped; u exactly
    at U - 1 has its second tap dropped; no cell has floor(u) in
    [20, 30), so columns 21..29 have no entries."""
    rng = np.random.default_rng(seed)
    W = rng.uniform(0.0, 1.0, (A, Y, X)).astype(np.float32)
    W[W < 0.3] = 0.0
    Umap = rng.uniform(-1.5, U + 0.5, (A, Y, X)).astype(np.float32)
    Umap[(Umap >= 20) & (Umap < 30)] += 10.0
    Umap[:, 0, :8] = U - 1
    Umap[:, 1, :8] = rng.uniform(-1.0, 0.0, 8)
    Pz = rng.uniform(0.0, 1.0, (A, Zf, U)).astype(np.float32)
    dL = rng.uniform(0.0, 1.0, (Zf, Y * X)).astype(np.float32)
    return Pz, W, Umap, dL, U


def _refracted_fields(tmp_path, Zf=20):
    """A cylindrical vial whose DMD pixels (7.5 um) are much finer than
    the voxels (127 um): a 32-voxel tile spans ~540 columns, refraction
    at the wall included. The fields come from the port's engine (bitwise
    equal to the JAX engine's, test_torch_ballistic.py)."""
    from drtvam_tpu_torch.models.scene import Scene
    from drtvam_tpu_torch.ops.ballistic import BallisticEngine
    from drtvam_tpu_torch.ops.mesh import make_box, save_ply
    save_ply(make_box((0.5, 0.5, 0.5)), str(tmp_path / "t.ply"))
    cfg = {
        "vial": {"type": "cylindrical", "r_int": 2.3, "r_ext": 2.6,
                 "ior": 1.54, "medium": {"ior": 1.40, "extinction": 0.1,
                                         "albedo": 0.0}},
        "projector": {"type": "collimated", "n_patterns": 4, "resx": 700,
                      "resy": 4, "pixel_size": 0.0075, "motion": "circular",
                      "distance": 20},
        "sensor": {"type": "dda", "scalex": 5.07, "scaley": 5.07,
                   "scalez": 1.29,
                   "film": {"type": "vfilm", "resx": 40, "resy": 40,
                            "resz": Zf}},
        "target": {"filename": str(tmp_path / "t.ply"), "size": 4.0},
        "output": str(tmp_path),
    }
    static, arr = Scene(cfg).build(mode="volume", include_target=False,
                                   regular_sampling=True)
    eng = BallisticEngine(static, arr, "cpu")
    W, Umap = eng.W_host, eng.U_host
    A, U = W.shape[0], static.projector.resx
    rng = np.random.default_rng(5)
    Pz = rng.uniform(0.0, 1.0, (A, Zf, U)).astype(np.float32)
    dL = rng.uniform(0.0, 1.0, (Zf, W.shape[1] * W.shape[2])) \
        .astype(np.float32)
    return Pz, W, Umap, dL, U


CASES = {
    "banded": lambda tmp: banded_fields(seed=3),               # Zf 24
    "wide": lambda tmp: wide_fields(seed=3, Zf=30),            # 48x80 film
    "edges": lambda tmp: _edge_fields(seed=4),                 # Zf 20
    "ragged": lambda tmp: wide_fields(seed=5, Y=40, X=50, U=70, Zf=20),
    "refracted": _refracted_fields,
}


def _case(name, tmp_path):
    Pz, W, Umap, dL, U = CASES[name](tmp_path)
    Pz, W, Umap, dL = (np.array(x) for x in (Pz, W, Umap, dL))
    F = tbp._pack_fields(torch.from_numpy(W), torch.from_numpy(Umap))
    return Pz, W, Umap, dL, U, F


def _close(out, ref):
    out, ref = np.asarray(out), np.asarray(ref)
    np.testing.assert_allclose(out, ref, rtol=TOL,
                               atol=TOL * np.abs(ref).max())


def _make_taps(W, u, base, n):
    """backproject_common.cuh make_taps: columns relative to base, taps
    outside [base, base + n) at column 0 with weight 0."""
    fl = torch.floor(u)
    i0 = fl.to(torch.int64) - base
    f = u - fl
    ok0 = (i0 >= 0) & (i0 < n)
    ok1 = (i0 + 1 >= 0) & (i0 + 1 < n)
    zero = torch.zeros((), dtype=W.dtype)
    return (torch.where(ok0, i0, 0), torch.where(ok1, i0 + 1, 0),
            torch.where(ok0, W * (1.0 - f), zero),
            torch.where(ok1, W * f, zero))


def emulate_fwd(Pz, F, win, Y, X, fidx=None):
    """bp_fwd tile by tile: stage Pz[a, :, lo:hi+1] z innermost, apply
    each voxel's two taps relative to the window. fidx: each raster
    voxel's position in the fields (block-major for bp_fwd_band); raster
    if not given."""
    A, Zf, U = Pz.shape
    tiles_x = -(-X // tbp.FT)
    out = torch.zeros((Zf, Y * X), dtype=torch.float32)
    for a in range(A):
        for t in range(win.shape[1]):
            lo, hi = (int(v) for v in win[a, t])
            if lo > hi:
                continue
            stage = Pz[a, :, lo:hi + 1].t()  # (n, Zf)
            y0, x0 = (t // tiles_x) * tbp.FT, (t % tiles_x) * tbp.FT
            ys = torch.arange(y0, min(y0 + tbp.FT, Y))
            xs = torch.arange(x0, min(x0 + tbp.FT, X))
            j = (ys[:, None] * X + xs[None, :]).reshape(-1)
            fj = j if fidx is None else fidx[j]
            c0, c1, w0, w1 = _make_taps(F[a, 0, fj], F[a, 1, fj], lo,
                                        hi - lo + 1)
            out[:, j] += (w0[:, None] * stage[c0] +
                          w1[:, None] * stage[c1]).t()
    return out


def emulate_bwd(dLt, ptr, ent, A, Zf, U):
    """bp_bwd run by run: the voxels of groups c0 .. c1 (floor(u) in
    [c0 - 1, c1 - 1]) each read their dLt line once and add it into
    their two adjacent columns; only columns [c0, c1) are kept."""
    j, i0 = ent[:, 0].long(), ent[:, 1].long()
    w0, w1 = ent[:, 2].view(torch.float32), ent[:, 3].view(torch.float32)
    out = torch.zeros((A, Zf, U), dtype=torch.float32)
    for a in range(A):
        for c0 in range(0, U, RUN):
            c1 = min(c0 + RUN, U)
            e0 = int(ptr[a * (U + 1) + c0])
            e1 = int(ptr[a * (U + 1) + c1 + 1])
            d = dLt[j[e0:e1]]
            acc = torch.zeros((c1 - c0 + 2, dLt.shape[1]))
            rel = i0[e0:e1] - (c0 - 1)
            acc.index_add_(0, rel, w0[e0:e1, None] * d)
            acc.index_add_(0, rel + 1, w1[e0:e1, None] * d)
            out[a, :, c0:c1] = acc[1:1 + c1 - c0, :Zf].t()
    return out


@pytest.mark.parametrize("case", list(CASES))
def test_window_emulation_matches_plain_and_jax(case, tmp_path):
    Pz, W, Umap, dL, U, F = _case(case, tmp_path)
    A, Y, X = W.shape
    win, maxw = tbp.tile_windows(F, U, Y, X)
    out = emulate_fwd(torch.from_numpy(Pz), F, win, Y, X)
    _close(out, tbp.fwd_dense_plain(torch.from_numpy(Pz), F))
    _close(out, jbp._fwd_xla(Pz, W, Umap))
    if case == "refracted":
        assert maxw > 256


@pytest.mark.parametrize("case", list(CASES))
def test_gather_emulation_matches_plain_and_jax(case, tmp_path):
    Pz, W, Umap, dL, U, F = _case(case, tmp_path)
    A = W.shape[0]
    Zf = dL.shape[0]
    ptr, ent = tbp.voxel_lists(F, U)
    dLt = tbp.transpose_dl(torch.from_numpy(dL))
    out = emulate_bwd(dLt, ptr, ent, A, Zf, U)
    _close(out, tbp.bwd_dense_plain(torch.from_numpy(dL), F, U))
    _close(out, jbp._bwd_xla(dL, W, Umap, U))


@pytest.mark.parametrize("case", list(CASES))
def test_tile_windows_are_exact(case, tmp_path):
    """Every in-range tap of a tile lies in its window, both ends are
    taken by a tap, and a tile without taps has lo > hi."""
    _, W, _, _, U, F = _case(case, tmp_path)
    A, Y, X = W.shape
    win, maxw = tbp.tile_windows(F, U, Y, X)
    tiles_x = -(-X // tbp.FT)
    assert win.dtype == torch.int32
    assert win.shape == (A, -(-Y // tbp.FT) * tiles_x, 2)
    i0 = torch.floor(F[:, 1]).long()
    widths = []
    for a in range(A):
        for t in range(win.shape[1]):
            y0, x0 = (t // tiles_x) * tbp.FT, (t % tiles_x) * tbp.FT
            ys = torch.arange(y0, min(y0 + tbp.FT, Y))
            xs = torch.arange(x0, min(x0 + tbp.FT, X))
            j = (ys[:, None] * X + xs[None, :]).reshape(-1)
            cols = torch.cat([i0[a, j], i0[a, j] + 1])
            cols = cols[(cols >= 0) & (cols < U)]
            lo, hi = (int(v) for v in win[a, t])
            if cols.numel() == 0:
                assert lo > hi
                continue
            assert (lo, hi) == (int(cols.min()), int(cols.max()))
            widths.append(hi - lo + 1)
    assert maxw == max(widths)


@pytest.mark.parametrize("case", list(CASES))
def test_voxel_lists_are_grouped_and_complete(case, tmp_path):
    """One entry per (angle, voxel) with a tap in [0, U), grouped by
    floor(u) and ordered by voxel, with the plain version's weights."""
    _, W, _, _, U, F = _case(case, tmp_path)
    A, YX = F.shape[0], F.shape[2]
    ptr, ent = tbp.voxel_lists(F, U)
    assert ptr.dtype == ent.dtype == torch.int32
    assert ptr.shape == (A * (U + 1) + 1,) and ent.shape[1] == 4
    assert int(ptr[0]) == 0 and int(ptr[-1]) == ent.shape[0]
    assert bool((ptr[1:] >= ptr[:-1]).all())
    i0c, i1c, w0, w1 = tbp._taps(F, U)
    fl = torch.floor(F[:, 1]).long()
    has = ((fl >= 0) & (fl < U)) | ((fl + 1 >= 0) & (fl + 1 < U))
    assert ent.shape[0] == int(has.sum())
    j, i0 = ent[:, 0].long(), ent[:, 1].long()
    for a in range(A):
        sl = slice(int(ptr[a * (U + 1)]), int(ptr[(a + 1) * (U + 1)]))
        ja, ia = j[sl], i0[sl]
        key = (ia + 1) * YX + ja
        assert bool((key[1:] > key[:-1]).all())
        assert torch.equal(ja.sort().values,
                           torch.nonzero(has[a]).reshape(-1))
        assert torch.equal(ia, fl[a, ja])
        g = torch.searchsorted(ptr[a * (U + 1):(a + 1) * (U + 1) + 1]
                               .long(), torch.arange(sl.start, sl.stop),
                               right=True) - 1
        assert torch.equal(g, ia + 1)
        assert torch.equal(ent[sl, 2].view(torch.float32), w0[a, ja])
        assert torch.equal(ent[sl, 3].view(torch.float32), w1[a, ja])


@pytest.mark.parametrize("Zf", [20, 30, 24, 1])
def test_transpose_dl_pads_z(Zf):
    rng = np.random.default_rng(Zf)
    dL = torch.from_numpy(rng.random((Zf, 77)).astype(np.float32))
    dLt = tbp.transpose_dl(dL)
    Zp = -(-Zf // 4) * 4
    assert dLt.shape == (77, Zp) and dLt.is_contiguous()
    assert torch.equal(dLt[:, :Zf], dL.t())
    assert not dLt[:, Zf:].any()


def test_dense_layout_is_built_for_its_fields_only():
    Pz, W, Umap, dL, U = banded_fields(seed=1)
    Pz, W, Umap = (np.array(x) for x in (Pz, W, Umap))
    A, Y, X = W.shape
    Wt, Ut = torch.from_numpy(W), torch.from_numpy(Umap)
    fields = tbp.PackedFields(Wt, Ut, U, banded=False)
    assert fields.layout is None  # the CPU path never reads it
    layout = tbp.DenseLayout(fields.F, U, Y, X).build()
    layout.check("bp_fwd", fields.F, U)
    with pytest.raises(ValueError):
        layout.check("bp_fwd", fields.F.clone(), U)
    with pytest.raises(ValueError):
        layout.check("bp_bwd", fields.F, U + 1)
    with pytest.raises(ValueError):
        tbp.DenseLayout(fields.F, U, Y + 1, X)
    # on the CPU the wrappers run the plain versions whatever the layout
    _close(tbp.fwd_dense(torch.from_numpy(Pz), fields.F, layout),
           tbp.fwd_dense_plain(torch.from_numpy(Pz), fields.F))
