"""The port's multi-GPU layer (drtvam_tpu_torch/parallel/) on the CPU:
ranks spawned as processes (tests/torch_parallel_worker.py), a gloo
group joined through a file:// rendezvous under tmp_path (or torchrun's
variables), one torch thread each, the plain route. Every input is made
from a seed with numpy.

  * the sharded wavefront (tests/test_sharding.py's scene: cylindrical,
    albedo 0.5, dda, spp 2, seed 3), a residual static with its chord
    bank (the hybrid engine's first-scatter dda residual) and a scene
    that keeps the target (a two-channel film), at worlds 2 and 4,
    against the port's single-process render: the dose to rtol 2e-5,
    atol 1e-6 (the ranks' doses are summed in another order), the
    pattern gradient bitwise (each pixel's lanes are summed on one rank,
    the others add exact zeros); and against the JAX package's
    render_sharded on the 8-virtual-device mesh: 1e-4 of the max,
    tests/test_torch_wavefront.py's same-seed bar;
  * the angle-sharded ballistic engine (tests/test_ballistic_sharding.py's
    24-angle scene), float32 and the bf16 operand form, against the
    port's unsharded engine at the JAX test's bar (dose rtol 2e-5, atol
    1e-7; gradient rtol 2e-5, atol 1e-9; the autograd gradient equal to
    pattern_grad), and against the JAX package's shard_ballistic_engine:
    rtol 1e-5, atol 1e-5 of the max;
  * the errors: angles that do not divide over the ranks, a static with
    medium_grads (ROADMAP.md item 22);
  * init_multihost: nothing configured, nothing done; two processes
    configured through torchrun's variables on tests/scene_fixtures.py's
    tiny_scattering_scene, against one process (as tests/test_multihost.py
    holds the JAX package)."""
import dataclasses
import json
import os
import socket

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from drtvam_tpu.models.scene import Scene as JScene
from drtvam_tpu.ops.ballistic import BallisticEngine as JEngine
from drtvam_tpu.ops.mesh import make_box, save_ply
from drtvam_tpu.parallel.shard import (make_mesh, render_sharded,
                                       shard_ballistic_engine)
from drtvam_tpu_torch.convert import scene_from_jax
from drtvam_tpu_torch.models.scene import Scene as TScene
from drtvam_tpu_torch.ops import render as tr
from drtvam_tpu_torch.ops.ballistic import BallisticEngine
from drtvam_tpu_torch.ops.hybrid import ScatteringEngine
from drtvam_tpu_torch.ops.march import scene_tensors
from drtvam_tpu_torch.parallel import multihost
from scene_fixtures import tiny_scattering_scene
from torch_jax_native import jax_native_libraries  # noqa: F401
from torch_parallel_worker import spawn
from torch_threads import one_torch_thread  # noqa: F401

WORLDS = (2, 4)
SEED, SPP = 3, 2
SAME_SEED_TOL = 1e-4


def _wf_config(path, surface_aware=False):
    """tests/test_sharding.py's scene."""
    film = {"type": "vfilm", "resx": 16, "resy": 16, "resz": 8}
    sensor = {"type": "dda", "scalex": 5, "scaley": 5, "scalez": 1.25,
              "film": film}
    cfg = {"vial": {"type": "cylindrical", "r_int": 7, "r_ext": 8,
                    "ior": 1.54,
                    "medium": {"ior": 1.40, "phase": {"type": "rayleigh"},
                               "extinction": 0.1, "albedo": 0.5}},
           "projector": {"type": "collimated", "n_patterns": 12,
                         "resx": 16, "resy": 8, "pixel_size": 0.3,
                         "motion": "circular", "distance": 20},
           "sensor": sensor, "target": {"filename": path, "size": 4.0},
           "output": "."}
    if surface_aware:
        cfg["final_sensor"] = json.loads(json.dumps(sensor))
        film["surface_aware"] = True
    return cfg


def _ballistic_config(path, n_patterns=24, resx=32, resy=16, film=32):
    """tests/test_ballistic_sharding.py's scene."""
    return {"vial": {"type": "cylindrical", "r_int": 2.3, "r_ext": 2.6,
                     "ior": 1.54,
                     "medium": {"ior": 1.40, "extinction": 0.1,
                                "albedo": 0.0,
                                "phase": {"type": "rayleigh"}}},
            "projector": {"type": "collimated", "n_patterns": n_patterns,
                          "resx": resx, "resy": resy,
                          "pixel_size": 0.1531, "motion": "circular",
                          "distance": 20},
            "sensor": {"type": "dda", "scalex": 5.07, "scaley": 5.07,
                       "scalez": 1.29,
                       "film": {"type": "vfilm", "resx": film,
                                "resy": film, "resz": film // 2}},
            "target": {"filename": path, "size": 4.0}, "output": "."}


def _numpy(arr):
    return {k: (v.numpy() if torch.is_tensor(v) else np.asarray(v))
            for k, v in arr.items()}


def _wf_case(static, arr, n_seed):
    """A wavefront case: the static, its tensors as numpy, the patterns
    and the dose cotangent from seed n_seed, and the port's
    single-process dose and gradient of <dose, dL>."""
    rng = np.random.default_rng(n_seed)
    n = static.projector.n_active
    data = rng.uniform(0.5, 2.0, n).astype(np.float32)
    dL = rng.uniform(0.0, 1.0, static.sensor.shape).astype(np.float32)
    inv_vol = 0.7
    at = scene_tensors(arr, "cpu")
    p = torch.from_numpy(data).requires_grad_(True)
    v = tr.render(static, at, p, inv_vol, seed=SEED, spp=SPP)
    (g,) = torch.autograd.grad(v, p, torch.from_numpy(dL))
    case = {"kind": "wavefront", "static": static, "arr": _numpy(arr),
            "data": data, "dL": dL, "inv_vol": inv_vol, "seed": SEED,
            "spp": SPP}
    return case, (v.detach().numpy(), g.numpy())


def _ballistic_case(static, arr, impl, tgt_seed):
    """A ballistic case: dvol from the unsharded engine's dose (the JAX
    test's mean squared error against a seeded target), and the
    unsharded dose, pattern gradient."""
    eng = BallisticEngine(static, arr, "cpu", impl=impl)
    n = static.projector.n_active
    data = np.linspace(0.5, 1.5, n, dtype=np.float32)
    inv_vol = 0.9
    v = eng.render_vol(torch.from_numpy(data), inv_vol).detach()
    tgt = np.random.default_rng(tgt_seed).random(v.shape).astype(np.float32)
    dvol = (2.0 * (v.numpy() - tgt) / v.numel()).astype(np.float32)
    g = eng.pattern_grad(torch.from_numpy(dvol), inv_vol).numpy()
    case = {"kind": "ballistic", "static": static, "arr": arr, "impl": impl,
            "data": data, "dvol": dvol, "inv_vol": inv_vol}
    return case, (v.numpy(), g)


def _jax_dose_and_vjp(fn, data, ct):
    """fn(data) and its vector-Jacobian product with ct, jitted."""
    def both(d, c):
        v, vjp = jax.vjp(fn, d)
        return v, vjp(c)[0]

    v, g = jax.jit(both)(jnp.asarray(data), jnp.asarray(ct))
    return np.asarray(v), np.asarray(g)


@pytest.fixture(scope="module")
def work(tmp_path_factory):
    path = tmp_path_factory.mktemp("tparallel") / "t.ply"
    save_ply(make_box((0.5, 0.5, 0.5)), str(path))
    return str(path)


@pytest.fixture(scope="module")
def cases(work):
    """Every case the ranks run, and the single-process results; the JAX
    package's sharded results on its 8-device mesh."""
    cases, single, jax_ref = {}, {}, {}
    # the wavefront: the JAX test's scene, converted
    jsc = JScene(_wf_config(work))
    jst, jarr = jsc.build(mode="volume", include_target=False, max_depth=8,
                          rr_depth=6)
    ts, ta = scene_from_jax(jst, jarr)
    cases["analog"], single["analog"] = _wf_case(ts, ta, 0)
    c = cases["analog"]
    mesh = make_mesh()
    assert len(jax.devices()) == 8
    jax_ref["analog"] = _jax_dose_and_vjp(lambda d: render_sharded(
        mesh, jst, jarr, d, jnp.float32(c["inv_vol"]), seed=SEED, spp=SPP,
        chunk=1 << 14), c["data"], c["dL"])
    # the hybrid engine's residual: first scatter on the chord bank, dda
    eng = ScatteringEngine(ts, ta, "cpu")
    cases["residual"], single["residual"] = _wf_case(eng.static_s, eng.arr,
                                                     1)
    assert tr.make_params(eng.static_s, eng.arr, 0, 1).residual > 0
    # the target kept: a two-channel film
    sc = TScene(_wf_config(work, surface_aware=True))
    st, at = sc.build(mode="volume", max_depth=8, rr_depth=6)
    assert st.sensor.channels == 2 and tr.target_mode(st) == 2
    cases["target"], single["target"] = _wf_case(st, at, 2)
    # medium_grads: the sharded adjoint forms no medium cotangents
    cases["medium_grads"] = {"kind": "raises", "of": "wavefront", "case": dict(
        cases["analog"], static=dataclasses.replace(ts, medium_grads=True))}
    # the ballistic engine, float32 and the bf16 operand form
    jsc = JScene(_ballistic_config(work))
    jst, jarr = jsc.build(mode="volume", include_target=False,
                          regular_sampling=True)
    bs, ba = scene_from_jax(jst, jarr)
    for impl in ("plain", "plain_bf16"):
        cases[impl], single[impl] = _ballistic_case(bs, ba, impl, 0)
    c = cases["plain"]
    jeng = shard_ballistic_engine(JEngine(jst, jarr, impl="xla"), mesh)
    jax_ref["plain"] = _jax_dose_and_vjp(lambda d: jeng.render_vol(
        d, jnp.float32(c["inv_vol"])), c["data"], c["dvol"])
    # 9 angles divide over neither world
    jsc = JScene(_ballistic_config(work, 9, 8, 4, 8))
    bs9, ba9 = scene_from_jax(*jsc.build(mode="volume", include_target=False,
                                         regular_sampling=True))
    cases["indivisible"] = {"kind": "raises", "of": "ballistic", "case": dict(
        cases["plain"], static=bs9, arr=ba9,
        data=np.ones(bs9.projector.n_active, np.float32),
        dvol=np.ones(bs9.sensor.shape, np.float32))}
    return cases, single, jax_ref


@pytest.fixture(scope="module", params=WORLDS)
def sharded(request, cases, tmp_path_factory):
    """rank 0's results of one spawned world."""
    d = tmp_path_factory.mktemp(f"world{request.param}")
    return request.param, spawn(request.param, str(d / "init"), cases[0],
                                str(d / "out.pkl"))


@pytest.mark.parametrize("name", ["analog", "residual", "target"])
def test_sharded_wavefront_matches_single_process(name, cases, sharded):
    _, res = sharded
    v, g = res[name]
    v1, g1 = cases[1][name]
    assert v.shape == v1.shape and v1.sum() > 0 and np.isfinite(v).all()
    np.testing.assert_allclose(v, v1, rtol=2e-5, atol=1e-6)
    assert np.array_equal(g, g1)
    assert np.abs(g1).max() > 0


def _within(port, ref, tol):
    scale = float(np.abs(ref).max())
    assert scale > 0
    assert float(np.abs(port - ref).max()) <= tol * scale


def test_sharded_wavefront_matches_jax(cases, sharded):
    _, res = sharded
    v, g = res["analog"]
    vj, gj = cases[2]["analog"]
    assert v.shape == vj.shape and g.shape == gj.shape
    _within(v, vj, SAME_SEED_TOL)
    _within(g, gj, SAME_SEED_TOL)


@pytest.mark.parametrize("impl", ["plain", "plain_bf16"])
def test_sharded_ballistic_matches_unsharded(impl, cases, sharded):
    _, res = sharded
    v, g, g_auto = res[impl]
    v1, g1 = cases[1][impl]
    assert v1.sum() > 0
    np.testing.assert_allclose(v, v1, rtol=2e-5, atol=1e-7)
    np.testing.assert_allclose(g, g1, rtol=2e-5, atol=1e-9)
    np.testing.assert_allclose(g_auto, g, rtol=1e-6, atol=1e-12)


def test_sharded_ballistic_matches_jax(cases, sharded):
    _, res = sharded
    v, g, _ = res["plain"]
    vj, gj = cases[2]["plain"]
    for port, ref in ((v, vj), (g, gj)):
        assert port.shape == ref.shape
        np.testing.assert_allclose(port, ref, rtol=1e-5,
                                   atol=1e-5 * float(np.abs(ref).max()))


def test_sharded_errors(sharded):
    world, res = sharded
    assert res["indivisible"] == \
        f"ValueError: 9 angles do not divide over {world} devices"
    assert res["medium_grads"].startswith("NotImplementedError")
    assert "ROADMAP.md item 22" in res["medium_grads"]


def test_init_multihost_unconfigured_is_a_no_op(monkeypatch):
    for k in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK",
              "LOCAL_RANK"):
        monkeypatch.delenv(k, raising=False)
    assert multihost.init_multihost() is False
    assert not torch.distributed.is_initialized()
    assert multihost.is_coordinator()
    assert multihost.global_mesh()[0] is None


def _free_port():
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_two_torchrun_processes_match_one(tmp_path):
    """Two ranks configured as torchrun configures them (MASTER_ADDR,
    MASTER_PORT, WORLD_SIZE, RANK, LOCAL_RANK) on the JAX multihost
    test's scene, against one process: the dose to rtol 2e-5, atol 1e-6,
    the gradient bitwise."""
    static, arr, _, _ = tiny_scattering_scene(str(tmp_path))
    case, (v1, g1) = _wf_case(*scene_from_jax(static, arr), 3)
    res = spawn(2, _free_port(), {"tiny": case},
                os.path.join(tmp_path, "out.pkl"), torchrun=True)
    v, g = res["tiny"]
    assert v1.sum() > 0
    np.testing.assert_allclose(v, v1, rtol=2e-5, atol=1e-6)
    assert np.array_equal(g, g1)
