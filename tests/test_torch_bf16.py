"""drtvam_tpu_torch's bf16 operand path == the JAX package's.

The JAX package runs it with DRTVAM_MATMUL=bf16 (the bf16=True branch of
its four Pallas kernels) and an optimizer config with "history_dtype":
"bfloat16". Inputs are made from numpy seeds and fed to both packages:

- the four plain bf16 backprojection versions against the JAX bf16
  kernels in interpret mode, at rtol 1e-5 and atol 1e-5 * max (measured
  <= 2.7e-7 of the max: the adjoints sum in another order). A control
  that rounds only the operand, not the tap weights, is 8e-4 to 2e-3 of
  the max off: the tolerance sees the weight rounding;
- the bf16 engine, dense and banded, against BallisticEngine(impl=
  'pallas_bf16'): dose and pattern gradient at the same tolerance
  (measured: the dose bitwise, the gradient <= 3.2e-7 of the max);
- linear_lbfgs and DeviceLinearLBFGS with a bfloat16 history against
  fused_linear_lbfgs(history_dtype=bfloat16): the loss history to
  rtol 1e-4 and the same step count; a JAX bfloat16 loop state resumed;
- the slice as a whole: the bf16 engine under a bfloat16 history
  against the JAX package's, the loss history to rtol 1e-4;
- both CLIs with "history_dtype": "bfloat16".

The CUDA kernels need a card: test_torch_cuda.py and chip_smoke.py
phase 3 hold them against these plain versions there.
"""
import json

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from drtvam_tpu.models.scene import Scene as JScene
from drtvam_tpu.ops import backproject as jbp
from drtvam_tpu.ops.ballistic import BallisticEngine as JEngine
from drtvam_tpu.opt.device_lbfgs import fused_linear_lbfgs
from drtvam_tpu.opt.loss import ThresholdedLoss as JLoss
from drtvam_tpu.opt.optimize import main as jmain
from drtvam_tpu_torch.convert import lbfgs_state_from_numpy
from drtvam_tpu_torch.models.scene import Scene as TScene
from drtvam_tpu_torch.ops import backproject as tbp
from drtvam_tpu_torch.ops.ballistic import BallisticEngine as TEngine
from drtvam_tpu_torch.ops.ballistic import default_impl
from drtvam_tpu_torch.opt.device_lbfgs import (DeviceLinearLBFGS,
                                               linear_lbfgs)
from drtvam_tpu_torch.opt.optimize import main as tmain

from test_backproject_banded import _fields as banded_fields
from test_backproject_plain import _fields as wide_fields
from test_torch_lbfgs import N_STEPS, PROPS, _torch_fns, problem  # noqa
from test_torch_optimize import _config, _write, work  # noqa: F401
from test_torch_scene import _vial
from torch_threads import one_torch_thread  # noqa: F401
from torch_jax_native import jax_native_libraries  # noqa: F401

TOL = 1e-5


@pytest.fixture
def interpret(monkeypatch):
    orig = jbp.pl.pallas_call
    monkeypatch.setattr(jbp.pl, "pallas_call",
                        lambda *a, **k: orig(*a, interpret=True, **k))


def _t(x):
    return torch.from_numpy(np.array(x))


def _rel(out, ref):
    out, ref = np.asarray(out), np.asarray(ref)
    return float(np.abs(out - ref).max() / np.abs(ref).max())


def _close(out, ref, tol=TOL):
    out, ref = np.asarray(out), np.asarray(ref)
    np.testing.assert_allclose(out, ref, rtol=tol,
                               atol=tol * np.abs(ref).max())


# --------------------------------------------------------------------------
# the four plain versions


def _cases():
    """name -> (port bf16, JAX bf16 kernel, port f32 taps on the rounded
    operand: the control)."""
    Pz, W, Um, dL, U = wide_fields(seed=2)
    F = tbp._pack_fields(_t(W), _t(Um))
    Pb, Wb, Ub, dLb, Uc = banded_fields(seed=4)
    A, Y, X = Wb.shape
    Fb, u0 = tbp._pack_fields_banded(_t(Wb), _t(Ub), Uc)
    lo = tbp._band_lo(u0)
    r = tbp.round_bf16
    dLbp = tbp.block_permute(_t(dLb).reshape(-1, Y, X), Y, X).reshape(
        dLb.shape[0], -1)
    return {
        "bp_fwd_bf16": (
            lambda: tbp.fwd_dense(_t(Pz), F, bf16=True),
            lambda: jbp._fwd_pallas(Pz, W, Um, bf16=True),
            lambda: tbp._fwd_plain(r(_t(Pz)), tbp._taps(F, U))),
        "bp_bwd_bf16": (
            lambda: tbp.bwd_dense(_t(dL), F, U, bf16=True),
            lambda: jbp._bwd_pallas(dL, W, Um, U, bf16=True),
            lambda: tbp._bwd_plain(r(_t(dL)), tbp._taps(F, U), U)),
        "bp_fwd_band_bf16": (
            lambda: tbp.fwd_band(_t(Pb), Fb, u0, Y, X, bf16=True),
            lambda: jbp._fwd_banded(Pb, Wb, Ub, bf16=True),
            lambda: tbp.block_unpermute(
                tbp._fwd_plain(r(_t(Pb)), tbp._taps(Fb, Uc, lo)), Y, X
            ).reshape(Pb.shape[1], Y * X)),
        "bp_bwd_band_bf16": (
            lambda: tbp.bwd_band(_t(dLb), Fb, u0, Uc, Y, X, bf16=True),
            lambda: jbp._bwd_banded(dLb, Wb, Ub, Uc, bf16=True),
            lambda: tbp._bwd_plain(r(dLbp), tbp._taps(Fb, Uc, lo), Uc)),
    }


@pytest.mark.parametrize("name", ["bp_fwd_bf16", "bp_bwd_bf16",
                                  "bp_fwd_band_bf16", "bp_bwd_band_bf16"])
def test_plain_bf16_matches_jax_kernel(name, interpret):
    port, jax_kernel, operand_only = _cases()[name]
    ref = np.asarray(jax_kernel())
    _close(port(), ref)
    # the control: rounding the operand alone misses the weights'
    # rounding by 8e-4 to 2e-3 of the max, far outside the tolerance
    assert _rel(operand_only(), ref) > 10 * TOL


def test_bf16_differs_from_f32():
    """The flag reaches the plain versions: bf16 is ~2e-3 of the max
    away from float32."""
    Pz, W, Um, dL, U = wide_fields(seed=2)
    F = tbp._pack_fields(_t(W), _t(Um))
    f32 = tbp.fwd_dense(_t(Pz), F)
    assert 1e-4 < _rel(tbp.fwd_dense(_t(Pz), F, bf16=True), f32) < 1e-2


@pytest.mark.parametrize("banded", [False, True])
def test_bf16_pair_adjoint_and_autograd(banded):
    """PackedFields(bf16=True) runs both directions in bf16; on operands
    that bfloat16 holds exactly the pair is an exact transpose, and
    autograd through backproject gives the bf16 adjoint."""
    Pz, W, Um, dL, U = banded_fields(seed=8)
    fields = tbp.PackedFields(_t(W), _t(Um), U, banded, bf16=True)
    rng = np.random.default_rng(0)
    p = tbp.round_bf16(torch.from_numpy(rng.random(Pz.shape)
                                        .astype(np.float32)))
    v = tbp.round_bf16(torch.from_numpy(rng.random(dL.shape)
                                        .astype(np.float32)))
    lhs = float(torch.sum(fields.forward(p).double() * v.double()))
    rhs = float(torch.sum(p.double() * fields.adjoint(v).double()))
    assert abs(lhs - rhs) <= 1e-5 * abs(lhs)
    pg = _t(Pz).requires_grad_(True)
    (g,) = torch.autograd.grad(tbp.backproject(pg, fields), pg, _t(dL))
    np.testing.assert_array_equal(g.numpy(),
                                  fields.adjoint(_t(dL)).numpy())


# --------------------------------------------------------------------------
# the engine


def _band_config(tmp_path):
    """_vial's index-matched scene with a 160-column DMD and a 64x64 film:
    banded_eligible, and its u-spans fit the band."""
    cfg, resolve, kw = _vial("index_matched", tmp_path)
    cfg["projector"].update(resx=160, pixel_size=0.1231 * 40 / 160)
    cfg["sensor"]["film"].update(resx=64, resy=64)
    return cfg, resolve, kw


@pytest.mark.parametrize("banded", [False, True])
def test_bf16_engine_matches_jax(banded, tmp_path, interpret):
    cfg, resolve, kw = (_band_config(tmp_path) if banded
                        else _vial("cylindrical", tmp_path))
    js, ts = JScene(cfg, resolve), TScene(cfg, resolve)
    je = JEngine(*js.build(mode="volume", **kw), impl="pallas_bf16")
    te = TEngine(*ts.build(mode="volume", **kw), "cpu", impl="plain_bf16")
    # both upgrade a band-fitting scene to the banded pair
    assert je.impl == ("pallas_band_bf16" if banded else "pallas_bf16")
    assert te.impl == ("plain_band_bf16" if banded else "plain_bf16")
    assert te.fields.bf16 and te.fields.banded == banded

    inv_vol = np.float32(ts.sensor.inv_volume())
    rng = np.random.default_rng(7)
    p = rng.uniform(0.5, 1.5, te.n_active).astype(np.float32)
    v = rng.uniform(0.0, 1.0, ts.sensor.static.shape).astype(np.float32)
    vol_j = je.render_vol(jnp.asarray(p), inv_vol)
    g_j = je.pattern_grad(jnp.asarray(v), inv_vol)
    pt = torch.from_numpy(p).requires_grad_(True)
    vol_t = te.render_vol(pt, float(inv_vol))
    g_t = te.pattern_grad(torch.from_numpy(v), float(inv_vol))
    (auto_g,) = torch.autograd.grad(vol_t, pt, torch.from_numpy(v))
    assert np.asarray(vol_j).sum() > 0
    _close(vol_t.detach(), vol_j, TOL)
    _close(g_t, g_j, TOL)
    np.testing.assert_array_equal(auto_g.numpy(), g_t.numpy())
    # and the bf16 dose is not the float32 one
    vol_f = TEngine(*ts.build(mode="volume", **kw), "cpu").render_vol(
        torch.from_numpy(p), float(inv_vol))
    assert _rel(vol_t.detach(), vol_f) > 10 * TOL


def test_default_impl_follows_drtvam_matmul(monkeypatch):
    cuda = torch.device("cuda")
    monkeypatch.delenv("DRTVAM_MATMUL", raising=False)
    assert default_impl(cuda) == "cuda"
    monkeypatch.setenv("DRTVAM_MATMUL", "bf16")
    assert default_impl(cuda) == "cuda_bf16"
    # the CPU keeps the float32 reference, as the JAX package's 'xla'
    assert default_impl("cpu") == "plain"
    for other in ("f32", "BF16", "fp16", ""):
        monkeypatch.setenv("DRTVAM_MATMUL", other)
        assert default_impl(cuda) == "cuda"


def test_engine_impl_choice(monkeypatch, tmp_path):
    monkeypatch.setenv("DRTVAM_MATMUL", "bf16")
    cfg, resolve, kw = _vial("cylindrical", tmp_path)
    built = TScene(cfg, resolve).build(mode="volume", **kw)
    assert TEngine(*built, "cpu").impl == "plain"
    assert TEngine(*built, "cpu", impl="plain_bf16").impl == "plain_bf16"
    for bad in ("cuda", "cuda_bf16", "plain_band_bf16", "xla", "bf16"):
        with pytest.raises(ValueError):
            TEngine(*built, "cpu", impl=bad)
    cfg, resolve, kw = _band_config(tmp_path)
    built = TScene(cfg, resolve).build(mode="volume", **kw)
    assert TEngine(*built, "cpu").impl == "plain"
    assert TEngine(*built, "cpu", impl="plain_band").impl == "plain_band"


def test_cpu_bf16_never_launches():
    Pz, W, Um, dL, U = banded_fields(seed=0)
    tbp.reset_launches()
    for banded in (False, True):
        f = tbp.PackedFields(_t(W), _t(Um), U, banded, bf16=True)
        f.adjoint(f.forward(_t(Pz)))
    assert all(v == 0 for v in tbp.launches.values())


# --------------------------------------------------------------------------
# Linear L-BFGS with a bfloat16 history


def _jax_run(problem, stop_i=None):  # noqa: F811
    je, _, target, inv_vol = problem
    loss_obj, tgt = JLoss(PROPS), jnp.asarray(target)

    def render(p):
        return je.render_vol(p, inv_vol)

    def value_grad(p):
        vol = render(p)
        loss = loss_obj(vol, tgt, p)
        dvol, dpat = jax.grad(lambda v, q: loss_obj(v, tgt, q),
                              argnums=(0, 1))(vol, p)
        return vol, loss, je.pattern_grad(dvol, inv_vol) + dpat

    def cand(vol, dvol, alpha, z):
        return loss_obj(vol + alpha * dvol, tgt, z)

    p0 = jnp.zeros((je.n_active,), jnp.float32)
    run = jax.jit(lambda p, s: fused_linear_lbfgs(
        value_grad, render, cand, p, N_STEPS, history_dtype=jnp.bfloat16,
        stop_i=s, return_state=True))
    p, hist, n, state = run(p0, N_STEPS if stop_i is None else stop_i)
    return np.asarray(p), np.asarray(hist), int(n), \
        jax.tree_util.tree_map(np.asarray, state)


def test_bf16_history_matches_fused_jax(problem):  # noqa: F811
    p_j, hist_j, n_j, _ = _jax_run(problem)
    value_grad, render, cand = _torch_fns(problem)
    p0 = torch.zeros((problem[1].n_active,), dtype=torch.float32)
    p_t, hist_t, n_t, st = linear_lbfgs(value_grad, render, cand, p0,
                                        N_STEPS, history_dtype="bfloat16",
                                        return_state=True)
    assert st["S"].dtype == st["Yh"].dtype == torch.bfloat16
    assert n_t == n_j == N_STEPS
    assert hist_j[-1] < hist_j[0]
    np.testing.assert_allclose(hist_t.numpy(), hist_j, rtol=1e-4)
    np.testing.assert_allclose(p_t.numpy(), p_j, rtol=1e-3,
                               atol=1e-3 * np.abs(p_j).max())

    # DeviceLinearLBFGS (the CLI's optimizer) follows the same iterates
    opt = DeviceLinearLBFGS(dir_fn=render, cand_fn=cand,
                            history_dtype=torch.bfloat16)
    p, hist = p0, []
    for _ in range(N_STEPS):
        vol, loss, g = value_grad(p)
        hist.append(float(loss))
        p = opt.step(p, g, vol, loss)
    assert opt._state["S"].dtype == torch.bfloat16
    np.testing.assert_array_equal(np.float32(hist), hist_t.numpy())


def test_resumes_from_a_jax_bf16_state(problem):  # noqa: F811
    p_j, hist_j, _, _ = _jax_run(problem)
    _, _, n_half, state = _jax_run(problem, stop_i=3)
    assert n_half == 3 and state["S"].dtype.name == "bfloat16"
    st = lbfgs_state_from_numpy(state)
    assert st["S"].dtype == st["Yh"].dtype == torch.bfloat16
    np.testing.assert_array_equal(st["Yh"].view(torch.int16).numpy(),
                                  state["Yh"].view(np.int16))
    value_grad, render, cand = _torch_fns(problem)
    p_t, hist_t, n_t = linear_lbfgs(value_grad, render, cand, None, N_STEPS,
                                    history_dtype=torch.bfloat16, state=st)
    assert n_t == N_STEPS
    np.testing.assert_allclose(hist_t.numpy(), hist_j, rtol=1e-4)
    np.testing.assert_allclose(p_t.numpy(), p_j, rtol=1e-3,
                               atol=1e-3 * np.abs(p_j).max())
    with pytest.raises(ValueError):  # a float32 run given a bf16 state
        linear_lbfgs(value_grad, render, cand, None, N_STEPS,
                     state=lbfgs_state_from_numpy(state))


def test_bf16_slice_matches_jax(tmp_path, interpret):
    """The slice as a whole: the bf16 engine and a bfloat16 history
    together, against BallisticEngine(impl="pallas_bf16") under
    fused_linear_lbfgs(history_dtype=bfloat16)."""
    cfg, resolve, kw = _vial("cylindrical", tmp_path)
    js, ts = JScene(cfg, resolve), TScene(cfg, resolve)
    je = JEngine(*js.build(mode="volume", **kw), impl="pallas_bf16")
    te = TEngine(*ts.build(mode="volume", **kw), "cpu", impl="plain_bf16")
    target = np.asarray(ts.sensor.discretize(ts.target_bank()))
    bf16_problem = (je, te, target, np.float32(ts.sensor.inv_volume()))
    _, hist_j, n_j, _ = _jax_run(bf16_problem)
    value_grad, render, cand = _torch_fns(bf16_problem)
    p0 = torch.zeros((te.n_active,), dtype=torch.float32)
    _, hist_t, n_t = linear_lbfgs(value_grad, render, cand, p0, N_STEPS,
                                  history_dtype="bfloat16")
    assert n_t == n_j == N_STEPS and hist_j[-1] < hist_j[0]
    np.testing.assert_allclose(hist_t.numpy(), hist_j, rtol=1e-4)


@pytest.mark.parametrize("bad", ["int32", "bf16", "nope", torch.int64])
def test_history_dtype_must_be_floating(bad):
    with pytest.raises(ValueError):
        DeviceLinearLBFGS(dir_fn=None, cand_fn=None, history_dtype=bad)


def test_clis_agree_with_a_bf16_history(work):  # noqa: F811
    """The optimizer config's history_dtype reaches both optimizers."""
    cfgs = {}
    for name in ("jax", "torch"):
        cfgs[name] = _config(work, name)
        cfgs[name]["optimizer"] = {"type": "lbfgs",
                                   "history_dtype": "bfloat16"}
    jmain([_write(work, cfgs["jax"], "jax.json"), "--backend", "cpu"])
    tmain([_write(work, cfgs["torch"], "torch.json"), "--device", "cpu"])
    j, t = work / "jax", work / "torch"
    np.testing.assert_allclose(np.load(t / "loss.npy"),
                               np.load(j / "loss.npy"), rtol=1e-3)
    fj, ft = np.load(j / "final.npy"), np.load(t / "final.npy")
    np.testing.assert_allclose(ft, fj, rtol=1e-3, atol=1e-3 * fj.max())
    saved = json.loads((t / "opt_config.json").read_text())
    assert saved["optimizer"]["history_dtype"] == "bfloat16"
