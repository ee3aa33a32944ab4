"""The layouts the banded kernels read, held on the CPU.

bp_fwd_band and bp_bwd_band run the dense pair's kernel templates on a
band-masked layout: the column window of each (angle, 32x32 film tile)
and the per-angle voxel lists are built from the taps inside each
(angle, 32x64 block)'s band only, the lists with raster voxel indices,
and the forward reads the block-major fields in place. The kernels
cannot run here, so the torch emulations of test_torch_dense_layout.py,
which consume exactly what the kernels consume, are run on these
layouts and held against the port's plain versions and the JAX
package's _fwd_banded / _bwd_banded (Pallas, interpret mode) at
rtol 1e-5, atol 1e-5*max (f32 sums in another order). Cases: the
banded u-geometry (Zf 24), a span-failing one where the band really
drops taps, and edge fields (empty cells, taps at columns 0 and U-1,
taps past the band's end and past U, columns without entries) at
Zf 20 and 30."""
import numpy as np
import pytest
import torch

from drtvam_tpu.ops import backproject as jbp
from drtvam_tpu_torch.ops import backproject as tbp

from test_backproject_banded import _fields as banded_fields
from test_backproject_plain import _fields as wide_fields
from test_torch_dense_layout import _close, emulate_bwd, emulate_fwd
from torch_threads import one_torch_thread  # noqa: F401


@pytest.fixture
def interpret(monkeypatch):
    orig = jbp.pl.pallas_call
    monkeypatch.setattr(jbp.pl, "pallas_call",
                        lambda *a, **k: orig(*a, interpret=True, **k))


def _band_edge_fields(seed, Zf, A=3, Y=32, X=128, U=300):
    """Two 32x64 blocks per angle. Block 0: u over [-1.5, 60), band
    start 0: taps at -1 are dropped, cells at u = 254.6 keep both taps
    (columns 254, 255) and cells at u = 255.5 lose the tap at 256, past
    the band's end though inside [0, U). Block 1: u over [200, U + 0.5),
    band start 128, band clipped to [128, U): u = U - 1 keeps its tap at
    U - 1, u = U - 0.5 loses its tap at U. No cell has floor(u) in
    [20, 30), so those columns have no entries; 30 % of cells are
    empty."""
    rng = np.random.default_rng(seed)
    W = rng.uniform(0.0, 1.0, (A, Y, X)).astype(np.float32)
    W[W < 0.3] = 0.0
    Umap = np.empty((A, Y, X), np.float32)
    Umap[:, :, :64] = rng.uniform(-1.5, 60.0, (A, Y, 64))
    Umap[:, :, 64:] = rng.uniform(200.0, U + 0.5, (A, Y, 64))
    Umap[(Umap >= 20) & (Umap < 30)] += 10.0
    for row, cols, u in ((0, slice(0, 4), 254.6), (0, slice(4, 8), 255.5),
                         (1, slice(0, 4), 0.25),
                         (1, slice(64, 68), U - 1.0),
                         (1, slice(68, 72), U - 0.5)):
        Umap[:, row, cols] = u
        W[:, row, cols] = 0.5
    Pz = rng.uniform(0.0, 1.0, (A, Zf, U)).astype(np.float32)
    dL = rng.uniform(0.0, 1.0, (Zf, Y * X)).astype(np.float32)
    return Pz, W, Umap, dL, U


CASES = {
    "banded": lambda: banded_fields(seed=3),                      # Zf 24
    "span_fail": lambda: wide_fields(seed=6, Y=32, X=64, U=300),  # Zf 24
    "edges": lambda: _band_edge_fields(seed=4, Zf=20),
    "edges_z30": lambda: _band_edge_fields(seed=7, Zf=30),
}


def _case(name):
    Pz, W, Umap, dL, U = CASES[name]()
    Pz, W, Umap, dL = (np.array(x) for x in (Pz, W, Umap, dL))
    A, Y, X = W.shape
    F, u0 = tbp._pack_fields_banded(torch.from_numpy(W),
                                    torch.from_numpy(Umap), U)
    return Pz, W, Umap, dL, U, F, u0, tbp.DenseLayout(F, U, Y, X, u0)


def _block_index(Y, X):
    """Each raster voxel's position in the block-major fields."""
    return tbp.block_unpermute(torch.arange(Y * X), Y, X).reshape(-1)


def _band_taps(F, u0, U, Y, X):
    """Raster floor(u), band start and the plain version's band-masked
    tap weights, (A, Y*X) each."""
    A = F.shape[0]
    _, _, w0, w1 = tbp._taps(F, U, tbp._band_lo(u0))
    Fr, lo = tbp.band_to_raster(F, u0, Y, X)
    w0, w1 = (tbp.block_unpermute(w, Y, X).reshape(A, Y * X)
              for w in (w0, w1))
    return torch.floor(Fr[:, 1]).long(), lo, w0, w1


@pytest.mark.parametrize("case", list(CASES))
def test_band_window_emulation_matches_plain_and_jax(case, interpret):
    Pz, W, Umap, dL, U, F, u0, layout = _case(case)
    A, Y, X = W.shape
    win, maxw = layout.windows
    assert 0 < maxw <= tbp.BANDW
    Pzt = torch.from_numpy(Pz)
    out = emulate_fwd(Pzt, F, win, Y, X, _block_index(Y, X))
    _close(out, tbp.fwd_band_plain(Pzt, F, u0, Y, X))
    _close(out, jbp._fwd_banded(Pz, W, Umap))
    if case != "banded":  # the band drops taps the dense function keeps
        assert not tbp.band_span_ok(torch.from_numpy(W),
                                    torch.from_numpy(Umap), U)
        assert not np.allclose(out.numpy(), np.asarray(
            jbp._fwd_xla(Pz, W, Umap)), rtol=1e-3)


@pytest.mark.parametrize("case", list(CASES))
def test_band_gather_emulation_matches_plain_and_jax(case, interpret):
    Pz, W, Umap, dL, U, F, u0, layout = _case(case)
    A = W.shape[0]
    Zf = dL.shape[0]
    ptr, ent = layout.lists
    dLt = tbp.transpose_dl(torch.from_numpy(dL))
    out = emulate_bwd(dLt, ptr, ent, A, Zf, U)
    _close(out, tbp.bwd_band_plain(torch.from_numpy(dL), F, u0, U,
                                   *W.shape[1:]))
    _close(out, jbp._bwd_banded(dL, W, Umap, U))


@pytest.mark.parametrize("case", list(CASES))
def test_band_windows_hold_exactly_the_in_band_taps(case):
    """Every in-band tap of a tile lies in its window, both ends are
    taken by one, the window lies inside the tile's band, and a tile
    without in-band taps has lo > hi."""
    _, W, _, _, U, F, u0, layout = _case(case)
    A, Y, X = W.shape
    win, maxw = layout.windows
    tiles_x = X // tbp.FT
    assert win.dtype == torch.int32
    assert win.shape == (A, (Y // tbp.FT) * tiles_x, 2)
    fl, lo, w0, w1 = _band_taps(F, u0, U, Y, X)
    widths = []
    for a in range(A):
        for t in range(win.shape[1]):
            y0, x0 = (t // tiles_x) * tbp.FT, (t % tiles_x) * tbp.FT
            ys = torch.arange(y0, y0 + tbp.FT)
            xs = torch.arange(x0, x0 + tbp.FT)
            j = (ys[:, None] * X + xs[None, :]).reshape(-1)
            band = lo[a, j]
            assert bool((band == band[0]).all())  # one band per tile
            b0, b1 = int(band[0]), min(int(band[0]) + tbp.BANDW, U)
            cols = torch.cat([fl[a, j], fl[a, j] + 1])
            cols = cols[(cols >= b0) & (cols < b1)]
            w_lo, w_hi = (int(v) for v in win[a, t])
            if cols.numel() == 0:
                assert w_lo > w_hi
                continue
            assert (w_lo, w_hi) == (int(cols.min()), int(cols.max()))
            assert b0 <= w_lo and w_hi < b1
            widths.append(w_hi - w_lo + 1)
    assert maxw == max(widths)


@pytest.mark.parametrize("case", list(CASES))
def test_band_lists_hold_each_in_band_tap_once(case):
    """One entry per (angle, voxel) with an in-band tap, with the raster
    voxel index, grouped by floor(u) and ordered by voxel, with the
    plain version's band-masked weights (0 for a dropped tap)."""
    _, W, _, _, U, F, u0, layout = _case(case)
    A, Y, X = W.shape
    YX = Y * X
    ptr, ent = layout.lists
    assert ptr.dtype == ent.dtype == torch.int32
    assert ptr.shape == (A * (U + 1) + 1,) and ent.shape[1] == 4
    assert int(ptr[0]) == 0 and int(ptr[-1]) == ent.shape[0]
    fl, lo, w0, w1 = _band_taps(F, u0, U, Y, X)
    hi = torch.clamp(lo + tbp.BANDW, max=U)
    has = ((fl >= lo) & (fl < hi)) | ((fl + 1 >= lo) & (fl + 1 < hi))
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
        assert torch.equal(ent[sl, 2].view(torch.float32), w0[a, ja])
        assert torch.equal(ent[sl, 3].view(torch.float32), w1[a, ja])


@pytest.mark.parametrize("seed", [1, 3, 8])
def test_band_layout_equals_dense_where_span_ok(seed):
    """Where every band covers its block's u-range, the banded pair
    computes the dense function: the band-masked windows and lists are
    the dense ones."""
    _, W, Umap, _, U = banded_fields(seed=seed)
    Wt, Ut = torch.from_numpy(np.array(W)), torch.from_numpy(np.array(Umap))
    A, Y, X = Wt.shape
    assert tbp.band_span_ok(Wt, Ut, U)
    F, u0 = tbp._pack_fields_banded(Wt, Ut, U)
    band = tbp.DenseLayout(F, U, Y, X, u0)
    dense = tbp.DenseLayout(tbp._pack_fields(Wt, Ut), U, Y, X)
    assert torch.equal(band.windows[0], dense.windows[0])
    assert band.windows[1] == dense.windows[1]
    assert torch.equal(band.lists[0], dense.lists[0])
    assert torch.equal(band.lists[1], dense.lists[1])


def test_block_index_matches_the_kernels_addressing():
    """bp_fwd_band.cu BlockMajorFields::index(y, x, X)."""
    Y, X = 64, 192
    ys, xs = np.meshgrid(np.arange(Y), np.arange(X), indexing="ij")
    pos = (((ys // 32) * (X // 64) + xs // 64) * 2048 + (ys % 32) * 64 +
           xs % 64).reshape(-1)
    np.testing.assert_array_equal(_block_index(Y, X).numpy(), pos)


def test_band_layout_is_built_for_its_fields_only():
    Pz, W, Umap, dL, U, F, u0, layout = _case("banded")
    A, Y, X = W.shape
    layout.build()
    layout.check("bp_fwd_band", F, U, u0, (Y, X))
    for args in ((F.clone(), U, u0, (Y, X)), (F, U + 1, u0, (Y, X)),
                 (F, U, u0.clone(), (Y, X)), (F, U, None, (Y, X)),
                 (F, U, u0, (Y * 2, X // 2))):
        with pytest.raises(ValueError):
            layout.check("bp_fwd_band", *args)
    with pytest.raises(ValueError):  # the film does not tile into blocks
        tbp.DenseLayout(F[..., :48 * 32], U, 48, 32, u0)
    # on the CPU the wrappers run the plain versions whatever the layout
    Pzt, dLt = torch.from_numpy(Pz), torch.from_numpy(dL)
    assert torch.equal(tbp.fwd_band(Pzt, F, u0, Y, X, layout),
                       tbp.fwd_band_plain(Pzt, F, u0, Y, X))
    assert torch.equal(tbp.bwd_band(dLt, F, u0, U, Y, X, layout),
                       tbp.bwd_band_plain(dLt, F, u0, U, Y, X))
