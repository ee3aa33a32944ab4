"""drtvam_tpu_torch linear_lbfgs == the JAX fused_linear_lbfgs on a small
ballistic scene: the same loss history (rtol 1e-4) and step count over
5 steps, and a JAX loop state carried across with
lbfgs_state_from_numpy resumes to the same result."""
import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from drtvam_tpu.opt.device_lbfgs import fused_linear_lbfgs
from drtvam_tpu.opt.loss import ThresholdedLoss as JLoss
from drtvam_tpu_torch.convert import lbfgs_state_from_numpy
from drtvam_tpu_torch.opt.device_lbfgs import (DeviceLinearLBFGS,
                                               linear_lbfgs)
from drtvam_tpu_torch.opt.loss import ThresholdedLoss as TLoss

from test_torch_ballistic import _engines
from torch_threads import one_torch_thread  # noqa: F401
from torch_jax_native import jax_native_libraries  # noqa: F401

N_STEPS = 5
PROPS = {"tl": 0.85, "tu": 0.95, "weight_sparsity": 1e-6}


@pytest.fixture(scope="module")
def problem(tmp_path_factory):
    ts, je, te = _engines("cylindrical", tmp_path_factory.mktemp("lb"),
                          sparse=False)
    target = np.asarray(ts.sensor.discretize(ts.target_bank()))
    inv_vol = np.float32(ts.sensor.inv_volume())
    return je, te, target, inv_vol


def _jax_run(problem, stop_i=None):
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
        value_grad, render, cand, p, N_STEPS, stop_i=s, return_state=True))
    p, hist, n, state = run(p0, N_STEPS if stop_i is None else stop_i)
    return np.asarray(p), np.asarray(hist), int(n), \
        jax.tree_util.tree_map(np.asarray, state)


def _torch_fns(problem):
    _, te, target, inv_vol = problem
    loss_obj, tgt = TLoss(PROPS), torch.from_numpy(target)
    inv_vol = float(inv_vol)

    def value_grad(p):
        with torch.no_grad():
            vol = te.render_vol(p, inv_vol)
        v, q = vol.clone().requires_grad_(True), p.clone().requires_grad_(True)
        loss = loss_obj(v, tgt, q)
        dvol, dpat = torch.autograd.grad(loss, (v, q))
        return vol, loss.detach(), te.pattern_grad(dvol, inv_vol) + dpat

    @torch.no_grad()
    def render(z):
        return te.render_vol(z, inv_vol)

    @torch.no_grad()
    def cand(vol, dvol, alpha, z):
        return loss_obj(vol + alpha * dvol, tgt, z)

    return value_grad, render, cand


def test_matches_fused_jax(problem):
    p_j, hist_j, n_j, _ = _jax_run(problem)
    value_grad, render, cand = _torch_fns(problem)
    p0 = torch.zeros((problem[1].n_active,), dtype=torch.float32)
    p_t, hist_t, n_t = linear_lbfgs(value_grad, render, cand, p0, N_STEPS)
    assert n_t == n_j == N_STEPS
    assert hist_j[-1] < hist_j[0]
    np.testing.assert_allclose(hist_t.numpy(), hist_j, rtol=1e-4)
    np.testing.assert_allclose(p_t.numpy(), p_j, rtol=1e-3,
                               atol=1e-3 * np.abs(p_j).max())


def test_resumes_from_a_jax_state(problem):
    p_j, hist_j, _, _ = _jax_run(problem)
    _, _, n_half, state = _jax_run(problem, stop_i=3)
    assert n_half == 3
    value_grad, render, cand = _torch_fns(problem)
    st = lbfgs_state_from_numpy(state)
    p_t, hist_t, n_t = linear_lbfgs(value_grad, render, cand, None, N_STEPS,
                                    state=st)
    assert n_t == N_STEPS
    np.testing.assert_allclose(hist_t.numpy(), hist_j, rtol=1e-4)
    np.testing.assert_allclose(p_t.numpy(), p_j, rtol=1e-3,
                               atol=1e-3 * np.abs(p_j).max())
    with pytest.raises(ValueError):
        linear_lbfgs(value_grad, render, cand, None, N_STEPS, m=4,
                     state=lbfgs_state_from_numpy(state))
    with pytest.raises(ValueError):
        linear_lbfgs(value_grad, render, cand, None, N_STEPS + 1,
                     state=lbfgs_state_from_numpy(state))


def test_steppable_matches_loop(problem):
    """DeviceLinearLBFGS.step (the CLI's optimizer) follows the same
    iterates as linear_lbfgs."""
    value_grad, render, cand = _torch_fns(problem)
    p0 = torch.zeros((problem[1].n_active,), dtype=torch.float32)
    _, hist_loop, _ = linear_lbfgs(value_grad, render, cand, p0, N_STEPS)
    opt = DeviceLinearLBFGS(dir_fn=render, cand_fn=cand)
    p, hist = p0, []
    for _ in range(N_STEPS):
        vol, loss, g = value_grad(p)
        hist.append(float(loss))
        p = opt.step(p, g, vol, loss)
    np.testing.assert_array_equal(np.float32(hist), hist_loop.numpy())
