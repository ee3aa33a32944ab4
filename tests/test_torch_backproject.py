"""drtvam_tpu_torch backprojection == the JAX package's.

The port's plain versions against the JAX take-based versions
(_fwd_xla/_bwd_xla) and against the four Pallas kernels in interpret
mode, on the field generators of test_backproject_banded.py (banded
u-geometry) and test_backproject_plain.py (wide, scattered u), at
rtol 1e-5 and atol 1e-5 * max. The CUDA kernels need a card:
test_torch_cuda.py and chip_smoke.py phase 3 hold them against these
plain versions there.
"""
import numpy as np
import pytest
import torch
import jax.numpy as jnp

from drtvam_tpu.ops import backproject as jbp
from drtvam_tpu_torch.ops import backproject as tbp

from test_backproject_banded import _fields as banded_fields
from test_backproject_plain import _fields as wide_fields
from torch_threads import one_torch_thread  # noqa: F401

TOL = 1e-5


@pytest.fixture
def interpret(monkeypatch):
    orig = jbp.pl.pallas_call
    monkeypatch.setattr(jbp.pl, "pallas_call",
                        lambda *a, **k: orig(*a, interpret=True, **k))


def _np(x):
    return np.asarray(x)


def _t(x):
    return torch.from_numpy(np.array(x))


def _close(out, ref):
    out, ref = _np(out), _np(ref)
    np.testing.assert_allclose(out, ref, rtol=TOL,
                               atol=TOL * np.abs(ref).max())


def _port_inputs(Pz, W, Umap, dL, U):
    return _t(Pz), _t(W), _t(Umap), _t(dL), U


@pytest.mark.parametrize("gen", ["banded", "wide"])
def test_dense_matches_jax(gen, interpret):
    Pz, W, Umap, dL, U = (banded_fields if gen == "banded"
                          else wide_fields)(seed=2)
    tPz, tW, tU, tdL, _ = _port_inputs(Pz, W, Umap, dL, U)
    F = tbp._pack_fields(tW, tU)
    fwd = tbp.fwd_dense(tPz, F)
    bwd = tbp.bwd_dense(tdL, F, U)
    _close(fwd, jbp._fwd_xla(Pz, W, Umap))
    _close(bwd, jbp._bwd_xla(dL, W, Umap, U))
    _close(fwd, jbp._fwd_pallas(Pz, W, Umap))
    _close(bwd, jbp._bwd_pallas(dL, W, Umap, U))


def test_banded_matches_jax(interpret):
    Pz, W, Umap, dL, U = banded_fields(seed=4)
    A, Y, X = W.shape
    tPz, tW, tU, tdL, _ = _port_inputs(Pz, W, Umap, dL, U)
    F, u0 = tbp._pack_fields_banded(tW, tU, U)
    fwd = tbp.fwd_band(tPz, F, u0, Y, X)
    bwd = tbp.bwd_band(tdL, F, u0, U, Y, X)
    _close(fwd, jbp._fwd_xla(Pz, W, Umap))
    _close(bwd, jbp._bwd_xla(dL, W, Umap, U))
    _close(fwd, jbp._fwd_banded(Pz, W, Umap))
    _close(bwd, jbp._bwd_banded(dL, W, Umap, U))


def test_packing_matches_jax():
    Pz, W, Umap, dL, U = banded_fields(seed=1)
    A, Y, X = W.shape
    tW, tU = _t(W), _t(Umap)
    np.testing.assert_array_equal(
        _np(tbp.block_permute(tW, Y, X)), _np(jbp.block_permute(W, Y, X)))
    per = tbp.block_permute(tU, Y, X).reshape(A, -1)
    np.testing.assert_array_equal(_np(tbp.block_unpermute(per, Y, X)),
                                  _np(Umap))
    F, u0 = tbp._pack_fields_banded(tW, tU, U)
    jF, ju0 = jbp._pack_fields_banded(W, Umap, U)
    np.testing.assert_array_equal(_np(u0), _np(ju0))
    np.testing.assert_array_equal(_np(F), _np(jF))
    jFd = jbp._pack_fields(W, Umap, U, jbp.TILE)
    np.testing.assert_array_equal(_np(tbp._pack_fields(tW, tU)),
                                  _np(jFd)[..., :Y * X])
    assert tbp.banded_eligible(W.shape, U) == jbp.banded_eligible(W.shape, U)
    # the banded geometry passes the span check, wide u-maps fail it
    for _, W2, U2, _, Uc in (banded_fields(seed=3),
                             wide_fields(seed=3, Y=32, X=64, U=300)):
        assert tbp.band_span_ok(_t(W2), _t(U2), Uc) == \
            bool(jbp.band_span_ok(W2, U2, Uc))


def test_band_drops_out_of_band_taps_like_jax(interpret):
    """Where a band cannot cover its cells (band_span_ok fails) the
    banded pair drops the taps outside it, as the JAX kernels do, and
    differs from the dense pair: the engine must not pick it there."""
    Pz, W, Umap, dL, U = wide_fields(seed=6, Y=32, X=64, U=300)
    tW, tU = _t(W), _t(Umap)
    assert tbp.banded_eligible(W.shape, U)
    assert not tbp.band_span_ok(tW, tU, U)
    F, u0 = tbp._pack_fields_banded(tW, tU, U)
    fwd = tbp.fwd_band(_t(Pz), F, u0, 32, 64)
    bwd = tbp.bwd_band(_t(dL), F, u0, U, 32, 64)
    _close(fwd, jbp._fwd_banded(Pz, W, Umap))
    _close(bwd, jbp._bwd_banded(dL, W, Umap, U))
    assert not np.allclose(_np(fwd), _np(jbp._fwd_xla(Pz, W, Umap)))


@pytest.mark.parametrize("banded", [False, True])
def test_adjoint_is_exact_transpose(banded):
    """<A p, v> == <p, A^T v> for the plain pair."""
    Pz, W, Umap, dL, U = banded_fields(seed=8)
    fields = tbp.PackedFields(_t(W), _t(Umap), U, banded)
    rng = np.random.default_rng(0)
    p = torch.from_numpy(rng.random(Pz.shape).astype(np.float32))
    v = torch.from_numpy(rng.random(dL.shape).astype(np.float32))
    lhs = float(torch.sum(fields.forward(p).double() * v.double()))
    rhs = float(torch.sum(p.double() * fields.adjoint(v).double()))
    assert abs(lhs - rhs) <= 1e-5 * abs(lhs)


@pytest.mark.parametrize("banded", [False, True])
def test_autograd_gradient_is_the_adjoint(banded):
    Pz, W, Umap, dL, U = banded_fields(seed=9)
    fields = tbp.PackedFields(_t(W), _t(Umap), U, banded)
    p = _t(Pz).requires_grad_(True)
    dose = tbp.backproject(p, fields)
    (g,) = torch.autograd.grad(dose, p, _t(dL))
    np.testing.assert_array_equal(_np(g), _np(fields.adjoint(_t(dL))))


def test_wrappers_reject_bad_input():
    Pz, W, Umap, dL, U = banded_fields(seed=0)
    F = tbp._pack_fields(_t(W), _t(Umap))
    with pytest.raises(ValueError):
        tbp.fwd_dense(_t(Pz).double(), F)
    with pytest.raises(ValueError):
        tbp.fwd_dense(_t(Pz)[:, :, :-1], F)
    with pytest.raises(ValueError):
        tbp.bwd_dense(_t(dL).t(), F, U)
    with pytest.raises(ValueError):
        tbp.fwd_band(_t(Pz), F, torch.zeros((1, 1), dtype=torch.int32),
                     48, 80)


def test_cpu_tensors_never_launch():
    Pz, W, Umap, dL, U = banded_fields(seed=0)
    tbp.reset_launches()
    fields = tbp.PackedFields(_t(W), _t(Umap), U, True)
    fields.adjoint(fields.forward(_t(Pz)))
    assert all(v == 0 for v in tbp.launches.values())
