"""drtvam_tpu_torch losses: the exact values and gradients test_loss.py
asserts for the JAX package (one-channel targets), and the thresholded
and L2 losses with the sparsity term against JAX on random inputs
(rtol 1e-6 on values, 1e-5 on gradients)."""
import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from drtvam_tpu.opt import loss as jloss
from drtvam_tpu_torch.opt import loss as tloss
from torch_threads import one_torch_thread  # noqa: F401


def _t(x):
    return torch.tensor(np.asarray(x, np.float32))


def value_grad(loss_fn, pred, target, patterns=None):
    pred = _t(pred).requires_grad_(True)
    target = _t(target)
    patterns = 0 * target if patterns is None else _t(patterns)
    loss = loss_fn(pred, target, patterns)
    (g,) = torch.autograd.grad(loss, pred)
    return float(loss.detach()), g.numpy().ravel()


def test_l2():
    target = np.array([1, 1, 0, 0], np.float32).reshape(2, 2, 1)
    pred = np.array([1, 2, 3, 4], np.float32).reshape(2, 2, 1)
    loss, g = value_grad(tloss.L2Loss({"reduction": "sum"}), pred, target)
    assert loss == 26
    assert np.allclose(g, [0, 2, 6, 8])
    loss, g = value_grad(tloss.L2Loss({"reduction": "mean"}), pred, target)
    assert loss == 6.5
    assert np.allclose(g, [0, 0.5, 1.5, 2])

    # grayscale target
    target = np.array([0.2, 0.8, 0.5, 0.0]).reshape(2, 2, 1)
    pred = np.ones((2, 2, 1), np.float32)
    loss, g = value_grad(tloss.L2Loss({"reduction": "sum"}), pred, target)
    assert np.allclose(loss, 0.8**2 + 0.2**2 + 0.5**2 + 1.0)
    assert np.allclose(g, [1.6, 0.4, 1.0, 2.0])


@pytest.mark.parametrize("props, pred, loss_ref, grad_ref", [
    ({"K": 2, "tl": 0.9, "tu": 0.95, "reduction": "sum"},
     [0.5, 0.97, 0.92, 0.5], 0.45**2 + 0.02**2, [-0.9, 0.0, 0.04, 0.0]),
    ({"K": 2, "tl": 0.9, "tu": 0.95, "reduction": "mean"},
     [0.5, 0.97, 0.92, 0.5], (0.45**2 + 0.02**2) / 4,
     [-0.225, 0.0, 0.01, 0.0]),
    ({"K": 1, "tl": 0.9, "tu": 0.95, "reduction": "sum"},
     [0.5, 1.1, 0.92, 0.5], 0.57, [-1, 1.0, 1.0, 0.0]),
    ({"K": 2, "tl": 0.4, "tu": 0.95, "reduction": "sum"},
     [0.5, 0.97, 0.92, 0.5], 0.45**2 + 0.52**2 + 0.1**2,
     [-0.9, 0.0, 1.04, 0.2]),
    ({"K": 2, "tl": 0.9, "tu": 0.99, "reduction": "sum"},
     [0.5, 0.97, 0.92, 0.5], 0.49**2 + 0.02**2 + 0.02**2,
     [-0.98, -0.04, 0.04, 0.0]),
])
def test_thresholded(props, pred, loss_ref, grad_ref):
    target = np.array([1, 1, 0, 0], np.float32).reshape(2, 2)
    pred = np.array(pred, np.float32).reshape(2, 2, 1)
    loss, g = value_grad(tloss.ThresholdedLoss(props), pred, target)
    assert np.allclose(loss, loss_ref, atol=1e-6)
    assert np.allclose(g, grad_ref)


def test_empty_threshold_window_rejected():
    with pytest.raises(ValueError):
        tloss.ThresholdedLoss({"tl": 0.95, "tu": 0.9})


@pytest.mark.parametrize("name, props", [
    ("threshold", {"tl": 0.8, "tu": 0.9, "weight_sparsity": 1e-3}),
    ("threshold", {"K": 3, "M": 2, "weight_sparsity": 0.5,
                   "reduction": "mean", "weight_void": 2.0}),
    ("l2", {"weight_sparsity": 1e-2}),
    ("l2", {"M": 2, "weight_sparsity": 0.3, "reduction": "mean"}),
])
def test_matches_jax(name, props):
    rng = np.random.default_rng(3)
    dose = rng.uniform(0.0, 1.3, (6, 5, 4, 1)).astype(np.float32)
    target = (rng.uniform(size=(6, 5, 4, 1)) > 0.6).astype(np.float32)
    pats = rng.uniform(-0.5, 2.0, (50,)).astype(np.float32)
    jfn, tfn = jloss.losses[name](props), tloss.losses[name](props)

    jl, (jgd, jgp) = jax.value_and_grad(
        lambda d, p: jfn(d, jnp.asarray(target), p), argnums=(0, 1))(
            jnp.asarray(dose), jnp.asarray(pats))
    d = _t(dose).requires_grad_(True)
    p = _t(pats).requires_grad_(True)
    tl = tfn(d, _t(target), p)
    tgd, tgp = torch.autograd.grad(tl, (d, p))
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=1e-6)
    np.testing.assert_allclose(tgd.numpy(), np.asarray(jgd), rtol=1e-5,
                               atol=1e-5 * np.abs(np.asarray(jgd)).max())
    np.testing.assert_allclose(tgp.numpy(), np.asarray(jgp), rtol=1e-5,
                               atol=1e-5 * np.abs(np.asarray(jgp)).max())
