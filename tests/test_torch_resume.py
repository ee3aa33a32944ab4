"""Checkpoints and resume in the port (drtvam_tpu_torch/opt/checkpoint.py,
optimize()'s checkpoint_every / resume) against the JAX package's
(drtvam_tpu/opt/checkpoint.py), on the CPU, on tests/test_checkpoint.py's
config (an index-matched vial, 24 angles, 24x8 DMD, 24x24x8 film, 6
steps; 3 steps written, then resumed to 6).

Tolerances, with their reasons:
  * the port resumed against the port uninterrupted: bitwise (the same
    float32 operations in the same order on the CPU, the state restored
    exactly);
  * across packages (a checkpoint that one package wrote, resumed by the
    other, against the JAX package's uninterrupted run): the loss
    history to 1e-4 and the patterns to rtol 1e-4 with an atol of 1e-4
    of their max (the ballistic dose agrees to ~1e-6 per step, tests/
    test_torch_ballistic.py; six steps of the optimizer carry it). With
    a bfloat16 history the patterns to 1e-3 (measured 4.6e-4 on 2 of
    4,608): a row element whose float32 value differs by ~1e-6 next to
    a bfloat16 rounding boundary rounds to the other neighbour, a step
    of 2^-8 in that element of the direction;
  * the checkpoint files: the same keys, dtypes and shapes in both
    packages.
"""
import os
import shutil

import numpy as np
import pytest

from drtvam_tpu.opt.optimize import optimize as joptimize
from drtvam_tpu_torch.opt.optimize import optimize as toptimize
from torch_threads import one_torch_thread  # noqa: F401
from torch_jax_native import jax_native_libraries  # noqa: F401

OPTIMIZERS = {"lbfgs": {"type": "lbfgs"},
              "adam": {"type": "adam", "lr": 0.05},
              "sgd": {"type": "sgd", "lr": 0.02},
              "sgd_momentum": {"type": "sgd", "lr": 0.01, "momentum": 0.9},
              "lbfgs_bf16": {"type": "lbfgs", "history_dtype": "bfloat16"}}


def _config(mesh_path, out, **kw):
    cfg = {
        "vial": {"type": "index_matched", "r": 5.0,
                 "medium": {"ior": 1.4, "extinction": 0.05, "albedo": 0.0}},
        "projector": {"type": "collimated", "n_patterns": 24, "resx": 24,
                      "resy": 8, "pixel_size": 0.2,
                      "motion": "circular", "distance": 20},
        "sensor": {"type": "dda", "scalex": 4, "scaley": 4, "scalez": 1.4,
                   "film": {"type": "vfilm", "resx": 24, "resy": 24,
                            "resz": 8}},
        "target": {"filename": mesh_path, "size": 3.0},
        "loss": {"type": "threshold", "tl": 0.85, "tu": 0.95},
        "n_steps": 6,
        "output": out,
    }
    cfg.update(kw)
    return cfg


def _run(run, mesh, out, opt, **kw):
    os.makedirs(out, exist_ok=True)
    cfg = _config(mesh, out, optimizer=dict(OPTIMIZERS[opt]), **kw)
    if run is toptimize:
        return toptimize(cfg, device="cpu")
    return joptimize(cfg)


def _partial(run, mesh, out, opt):
    """3 steps, a checkpoint at each."""
    _run(run, mesh, out, opt, n_steps=3, checkpoint_every=1)
    with np.load(os.path.join(out, "checkpoint.npz")) as f:
        assert int(f["step"]) == 2
        return {k: f[k] for k in f.files}


def _resume(run, mesh, out, opt):
    _run(run, mesh, out, opt, checkpoint_every=2, resume=True)


def _result(out):
    with np.load(os.path.join(out, "patterns.npz")) as f:
        return np.load(os.path.join(out, "loss.npy")), f["patterns"]


@pytest.fixture(scope="module")
def jax_runs(box_hole_mesh, tmp_path_factory):
    """The JAX package's uninterrupted 6-step runs and its 3-step
    checkpoints, for lbfgs, adam and a bfloat16 L-BFGS history."""
    root = tmp_path_factory.mktemp("jax_runs")
    out = {}
    for opt in ("lbfgs", "adam", "lbfgs_bf16"):
        full = str(root / f"{opt}_full")
        _run(joptimize, box_hole_mesh, full, opt)
        part = str(root / f"{opt}_part")
        ckpt = _partial(joptimize, box_hole_mesh, part, opt)
        out[opt] = (_result(full), part, ckpt)
    return out


def _close(got, ref, rtol=1e-4):
    (lt, pt), (lj, pj) = got, ref
    np.testing.assert_allclose(lt, lj, rtol=1e-4)
    np.testing.assert_allclose(pt, pj, rtol=rtol, atol=rtol * pj.max())


@pytest.mark.parametrize("opt", ["lbfgs", "adam", "sgd", "sgd_momentum"])
def test_port_resume_matches_uninterrupted(box_hole_mesh, tmp_path, opt):
    full, part = str(tmp_path / "full"), str(tmp_path / "part")
    _run(toptimize, box_hole_mesh, full, opt)
    _partial(toptimize, box_hole_mesh, part, opt)
    _resume(toptimize, box_hole_mesh, part, opt)
    (la, pa), (lb, pb) = _result(full), _result(part)
    np.testing.assert_array_equal(lb, la)
    np.testing.assert_array_equal(pb, pa)
    with np.load(os.path.join(part, "checkpoint.npz")) as f:
        assert int(f["step"]) == 5
        np.testing.assert_array_equal(f["loss_hist"], la)


@pytest.mark.parametrize("opt", ["lbfgs", "adam", "lbfgs_bf16"])
def test_port_resumes_a_jax_checkpoint(box_hole_mesh, tmp_path, jax_runs,
                                       opt):
    """The JAX package's 3-step checkpoint, resumed by the port to 6
    steps, against the JAX package's uninterrupted run. A bfloat16
    history reads back as '|V2' rows."""
    ref, part, ckpt = jax_runs[opt]
    if opt == "lbfgs_bf16":
        assert ckpt["opt_S"].dtype.str == "|V2"
    out = str(tmp_path / "resumed")
    shutil.copytree(part, out)
    _resume(toptimize, box_hole_mesh, out, opt)
    _close(_result(out), ref, 1e-3 if opt == "lbfgs_bf16" else 1e-4)


def test_jax_cannot_resume_its_bf16_checkpoint(box_hole_mesh, tmp_path,
                                               jax_runs):
    """A deviation of the reference (ROADMAP queue 3): jnp.asarray of the
    '|V2' rows raises, so the JAX package cannot resume its own
    bfloat16-history checkpoint; the port can (above)."""
    out = str(tmp_path / "resumed")
    shutil.copytree(jax_runs["lbfgs_bf16"][1], out)
    with pytest.raises(TypeError):
        _resume(joptimize, box_hole_mesh, out, "lbfgs_bf16")


@pytest.mark.parametrize("opt", ["lbfgs", "adam"])
def test_jax_resumes_a_port_checkpoint(box_hole_mesh, tmp_path, jax_runs,
                                       opt):
    """The port's 3-step checkpoint has the JAX file's keys, dtypes and
    shapes; the JAX package resumes it to its uninterrupted run."""
    ref, _, jckpt = jax_runs[opt]
    out = str(tmp_path / "part")
    ckpt = _partial(toptimize, box_hole_mesh, out, opt)
    assert sorted(ckpt) == sorted(jckpt)
    for k in ckpt:
        assert (ckpt[k].dtype, ckpt[k].shape) == \
            (jckpt[k].dtype, jckpt[k].shape), k
    _resume(joptimize, box_hole_mesh, out, opt)
    _close(_result(out), ref)


def test_bf16_checkpoint_keys_match(box_hole_mesh, tmp_path, jax_runs):
    ckpt = _partial(toptimize, box_hole_mesh, str(tmp_path / "p"),
                    "lbfgs_bf16")
    jckpt = jax_runs["lbfgs_bf16"][2]
    assert sorted(ckpt) == sorted(jckpt)
    for k in ckpt:
        assert (ckpt[k].dtype, ckpt[k].shape) == \
            (jckpt[k].dtype, jckpt[k].shape), k


def test_mismatched_optimizer_raises(box_hole_mesh, tmp_path, jax_runs):
    out = str(tmp_path / "o")
    _partial(toptimize, box_hole_mesh, out, "lbfgs")
    with pytest.raises(ValueError, match="optimizer"):
        _resume(toptimize, box_hole_mesh, out, "adam")
    # a JAX-written adam checkpoint, resumed as lbfgs
    out = str(tmp_path / "j")
    shutil.copytree(jax_runs["adam"][1], out)
    with pytest.raises(ValueError, match="optimizer"):
        _resume(toptimize, box_hole_mesh, out, "lbfgs")


def test_resume_with_another_active_set_raises(box_hole_mesh, tmp_path):
    """The checkpoint's pixel store is set before the engine is built,
    and must be the set this run's cull keeps."""
    out = str(tmp_path / "o")
    _partial(toptimize, box_hole_mesh, out, "lbfgs")
    with pytest.raises(ValueError, match="active pixel set"):
        _run(toptimize, box_hole_mesh, out, "lbfgs", resume=True,
             filter_radon=True)


def test_resume_without_a_checkpoint_starts_from_scratch(box_hole_mesh,
                                                         tmp_path, capsys):
    full, fresh = str(tmp_path / "full"), str(tmp_path / "fresh")
    _run(toptimize, box_hole_mesh, full, "lbfgs")
    _run(toptimize, box_hole_mesh, fresh, "lbfgs", resume=True)
    assert "No checkpoint found" in capsys.readouterr().out
    np.testing.assert_array_equal(_result(fresh)[0], _result(full)[0])
