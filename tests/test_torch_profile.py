"""The `profile` key of the port's CLI (drtvam_tpu_torch/opt/optimize.py
`_profiled`; the JAX driver's drtvam_tpu/opt/optimize.py:507-515,
:603-604) on a shrunk copy of the verify recipe's config (30 angles of
48x12, a 40x40x20 film, 3 steps), on the CPU: true, "true" and a path
each write one Chrome trace (`*.pt.trace.json`) of the loop into the
directory the JAX driver would trace into, and change no number of the
run: the loss history, final.npy and every other artifact but
timing.npy (wall seconds) are bitwise those of the same run without it,
under L-BFGS, Adam and the hybrid engine's progressive schedule. Without
the key no trace is written. Both CLIs make the trace directory on the
same config (the JAX one writes jax.profiler's files there)."""
import json
import os

import numpy as np
import pytest

from drtvam_tpu.opt.optimize import main as jmain
from drtvam_tpu_torch.ops.mesh import make_box_with_hole, save_ply
from drtvam_tpu_torch.opt.optimize import main as tmain
from drtvam_tpu_torch.opt.optimize import profile_dir
from torch_threads import one_torch_thread  # noqa: F401
from torch_jax_native import jax_native_libraries  # noqa: F401

# the loop's modes, as config changes: (name, changes)
MODES = {
    "lbfgs": {},
    "adam": {"optimizer": {"type": "adam"}},
    "hybrid_progressive": {"vial.medium.albedo": 0.5, "spp": 2,
                           "spp_ref": 2, "progressive": True,
                           "n_steps": 7},
}


def _config(work, out, mode):
    cfg = {
        "vial": {"type": "cylindrical", "r_int": 7, "r_ext": 8, "ior": 1.54,
                 "medium": {"ior": 1.40, "phase": {"type": "rayleigh"},
                            "extinction": 0.1, "albedo": 0.0}},
        "projector": {"type": "collimated", "n_patterns": 30, "resx": 48,
                      "resy": 12, "pixel_size": 0.104,
                      "motion": "circular", "distance": 20},
        "sensor": {"type": "dda", "scalex": 5, "scaley": 5, "scalez": 1.25,
                   "film": {"type": "vfilm", "resx": 40, "resy": 40,
                            "resz": 20}},
        "target": {"filename": "box_hole.ply", "size": 4.0},
        "loss": {"type": "threshold", "tl": 0.85, "tu": 0.95},
        "n_steps": 3, "output": str(work / out)}
    for key, value in MODES[mode].items():
        *head, last = key.split(".")
        node = cfg
        for k in head:
            node = node[k]
        node[last] = value
    return cfg


def _run(work, cfg, name, main=tmain, *flags):
    path = work / f"{name}.json"
    path.write_text(json.dumps(cfg))
    main([str(path), *(flags or ("--device", "cpu"))])
    return work / name


def _files(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


@pytest.fixture(scope="module")
def work(tmp_path_factory):
    path = tmp_path_factory.mktemp("profile")
    save_ply(make_box_with_hole((2.0, 2.0, 0.5), 1.0,
                                hole_center_xy=(-1.0, 0.0)),
             str(path / "box_hole.ply"))
    return path


@pytest.fixture(scope="module")
def plain_runs(work):
    """Each mode's run without `profile`, once: {mode: output dir}."""
    return {}


def _plain(work, plain_runs, mode, capsys):
    if mode not in plain_runs:
        plain_runs[mode] = _run(work, _config(work, f"plain_{mode}", mode),
                                f"plain_{mode}")
        assert "Profiling to" not in capsys.readouterr().out
    return plain_runs[mode]


def test_profile_dir_resolves_as_the_jax_driver():
    assert profile_dir(True, "out") == os.path.join("out", "trace")
    assert profile_dir("true", "out") == os.path.join("out", "trace")
    assert profile_dir("/some/where", "out") == "/some/where"
    for off in (None, False, "", 0):
        assert profile_dir(off, "out") is None


@pytest.mark.parametrize("value,mode", [
    (True, "lbfgs"), ("true", "lbfgs"), ("path", "lbfgs"), (True, "adam"),
    (True, "hybrid_progressive")])
def test_profile_traces_the_loop_and_changes_nothing(value, mode, work,
                                                     plain_runs, capsys):
    plain = _plain(work, plain_runs, mode, capsys)
    name = f"prof_{mode}_{value}"
    cfg = _config(work, name, mode)
    trace_dir = str(work / name / "trace")
    if value == "path":
        trace_dir = str(work / f"{name}_elsewhere" / "tr")
        cfg["profile"] = trace_dir
    else:
        cfg["profile"] = value
    out = _run(work, cfg, name)
    assert f"Profiling to {trace_dir}" in capsys.readouterr().out
    traces = [f for f in os.listdir(trace_dir)
              if f.endswith(".pt.trace.json")]
    assert len(traces) == 1
    with open(os.path.join(trace_dir, traces[0])) as f:
        events = json.load(f)["traceEvents"]
    ops = {e.get("name", "") for e in events}
    assert any(n.startswith("aten::") for n in ops)
    # the run's numbers and artifacts: bitwise those without the trace
    files = [f for f in _files(out) if not f.startswith("trace")]
    assert files == _files(plain)
    for f in files:
        if f == "opt_config.json":
            a, b = (json.loads((d / f).read_text()) for d in (out, plain))
            assert {k: v for k, v in a.items()
                    if k not in ("profile", "output")} == \
                {k: v for k, v in b.items() if k != "output"}
        elif f.endswith(".npy") and f != "timing.npy":
            np.testing.assert_array_equal(np.load(out / f),
                                          np.load(plain / f), err_msg=f)
        elif not f.endswith(".npy"):
            assert (out / f).read_bytes() == (plain / f).read_bytes(), f


def test_no_trace_without_profile(work, plain_runs, capsys):
    plain = _plain(work, plain_runs, "lbfgs", capsys)
    assert not (plain / "trace").exists()
    assert not any(f.endswith(".pt.trace.json") for f in _files(plain))


def test_both_clis_make_the_trace_directory(work):
    """The JAX CLI's `profile` runs on the CPU here: both packages make
    <output>/trace on the same config, each with its profiler's files."""
    cfg = _config(work, "jax_prof", "lbfgs")
    cfg.update(profile=True, n_steps=2)
    j = _run(work, cfg, "jax_prof", jmain, "--backend", "cpu")
    cfg["output"] = str(work / "torch_prof")
    t = _run(work, cfg, "torch_prof")
    for out in (j, t):
        assert (out / "trace").is_dir()
        assert any(f.startswith("trace") for f in _files(out))
