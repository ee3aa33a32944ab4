"""drtvam_tpu_torch BallisticEngine == the JAX BallisticEngine(impl="xla")
on the four analytic vials of test_ballistic.py.

The transport fields come from the same host C++ and must be bitwise
equal; render_vol and pattern_grad go through the port's plain
backprojection on the CPU and agree to rtol 1e-5 (atol 1e-5 * max for
near-zero voxels), with the identity and a sparse pattern store."""
import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from drtvam_tpu.models.scene import Scene as JScene
from drtvam_tpu.ops.ballistic import BallisticEngine as JEngine
from drtvam_tpu_torch.models.scene import Scene as TScene
from drtvam_tpu_torch.ops.ballistic import BallisticEngine as TEngine

from test_ballistic import VIALS
from test_torch_scene import _vial
from torch_threads import one_torch_thread  # noqa: F401
from torch_jax_native import jax_native_libraries  # noqa: F401
from z_taps import z_taps

TOL = 1e-5


def _close(out, ref):
    out, ref = np.asarray(out), np.asarray(ref)
    np.testing.assert_allclose(out, ref, rtol=TOL,
                               atol=TOL * np.abs(ref).max())


def _engines(vial, tmp_path, sparse):
    cfg, resolve, kw = _vial(vial, tmp_path)
    js, ts = JScene(cfg, resolve), TScene(cfg, resolve)
    if sparse:
        n = js.projector.active_size()
        idx = np.sort(np.random.default_rng(1).choice(
            n, n // 3, replace=False)).astype(np.int32)
        for s in (js, ts):
            s.projector.set_active(idx, np.zeros(idx.size, np.float32))
    jstatic, jarr = js.build(mode="volume", **kw)
    tstatic, tarr = ts.build(mode="volume", **kw)
    je = JEngine(jstatic, jarr, impl="xla")
    te = TEngine(tstatic, tarr, "cpu")
    return ts, je, te


@pytest.mark.parametrize("sparse", [False, True])
@pytest.mark.parametrize("vial", list(VIALS))
def test_engine_matches_jax(vial, sparse, tmp_path):
    ts, je, te = _engines(vial, tmp_path, sparse)
    assert te.impl == "plain"
    assert te.identity_pixels == (not sparse) == je.identity_pixels
    np.testing.assert_array_equal(te.W_host, np.asarray(je.W))
    np.testing.assert_array_equal(te.U_host, np.asarray(je.Umap))

    inv_vol = np.float32(ts.sensor.inv_volume())
    rng = np.random.default_rng(7)
    p = rng.uniform(0.5, 1.5, te.n_active).astype(np.float32)
    v = rng.uniform(0.0, 1.0, ts.sensor.static.shape).astype(np.float32)

    vol_j = jax.jit(lambda d: je.render_vol(d, inv_vol))(jnp.asarray(p))
    g_j = jax.jit(lambda w: je.pattern_grad(w, inv_vol))(jnp.asarray(v))
    vol_t = te.render_vol(torch.from_numpy(p), float(inv_vol))
    g_t = te.pattern_grad(torch.from_numpy(v), float(inv_vol))
    assert np.asarray(vol_j).sum() > 0
    _close(vol_t, vol_j)
    _close(g_t, g_j)


def test_adjoint_is_exact_transpose(tmp_path):
    ts, _, te = _engines("cylindrical", tmp_path, sparse=False)
    inv_vol = float(ts.sensor.inv_volume())
    rng = np.random.default_rng(0)
    p = torch.from_numpy(rng.random(te.n_active).astype(np.float32))
    v = torch.from_numpy(rng.random(ts.sensor.static.shape)
                         .astype(np.float32))
    lhs = float(torch.sum(te.render_vol(p, inv_vol).double() * v.double()))
    rhs = float(torch.sum(p.double() * te.pattern_grad(v, inv_vol).double()))
    assert abs(lhs - rhs) / abs(lhs) < 1e-5
    # autograd through render_vol gives the explicit adjoint
    pg = p.clone().requires_grad_(True)
    (g,) = torch.autograd.grad(te.render_vol(pg, inv_vol), pg, v)
    _close(g, te.pattern_grad(v, inv_vol))


@pytest.mark.parametrize("regular", [True, False])
@pytest.mark.parametrize("resy, Z, pixel", [(400, 256, 0.025),
                                            (400, 160, 0.025),
                                            (160, 256, 0.0625)])
def test_z_tap_tables_are_exact_transposes(resy, Z, pixel, regular):
    """The forward's (Zf, K) and the adjoint's (R, K) tap tables hold the
    binning matrix and its transpose entry for entry, so the resample's
    adjoint (on the card the backward of the forward's gather) is the
    forward's exact transpose: <fwd(x), y> == <x, bwd(y)> to float32
    rounding. Regular and jittered sampling; Zf < R and Zf > R."""
    zt_i, zt_w, rt_i, rt_w = z_taps(resy, Z, regular, pixel)
    S = np.zeros((Z, resy), np.float32)
    np.add.at(S, (np.arange(Z)[:, None], zt_i.numpy()), zt_w.numpy())
    St = np.zeros((resy, Z), np.float32)
    np.add.at(St, (np.arange(resy)[:, None], rt_i.numpy()), rt_w.numpy())
    np.testing.assert_array_equal(St, S.T)
    assert np.count_nonzero(S) >= max(resy, Z) // 2
    rng = np.random.default_rng(9)
    x = torch.from_numpy(rng.uniform(-1.0, 1.0, (3, resy, 13))
                         .astype(np.float32))
    y = torch.from_numpy(rng.uniform(-1.0, 1.0, (3, Z, 13))
                         .astype(np.float32))
    fx = TEngine._tap_contract(x, zt_i, zt_w).double()
    by = TEngine._tap_contract(y, rt_i, rt_w).double()
    lhs, rhs = float((fx * y.double()).sum()), float((x.double() * by).sum())
    scale = float((fx.abs() * y.double().abs()).sum())
    assert abs(lhs - rhs) <= 4 * np.finfo(np.float32).eps * scale
