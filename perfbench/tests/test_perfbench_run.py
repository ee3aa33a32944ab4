"""A whole run on the CPU at the test size (the chip's look skipped):
the configuration merged with its traffic mix is what optimize()
accepts, and the comparison passes; with the timed path broken
underneath it the run comes out not correct, once for each fault a cell
can have (a step that leaves the state unchanged, half of the angles or
pixels left out and the rest doubled, an answer altered where it is
produced; the cells use one chip, so no exchange between chips can be
left out); and the controls fail the comparison: the reference in
bfloat16 put in the program's place (ballistic), the program with its
scattering albedo or its final render's samples off the configuration's
(hybrid)."""
import json
import time

import numpy as np
import pytest

from perfbench import readings
from perfbench.harness import runner
from perfbench.harness.check import Checker
from perfbench.harness.manifest import Cell

BALLISTIC = "benchy-idx.ballistic"
HYBRID = "benchy-sq-scatter.hybrid-sa-radon"
SEED = 2**33 + 17


def _run(root, cell, trace=False):
    return runner.run(Cell(cell, root), SEED, 0.5, trace, "cpu",
                      time.perf_counter())


@pytest.mark.parametrize("cell", [BALLISTIC, HYBRID])
def test_a_sound_run_is_correct(tiny_root, cell):
    res = _run(tiny_root, cell)
    assert res["correct"] is True, res["checks"]
    assert list(res)[-1] == "checks"
    assert set(res["metrics"]) == {m["name"] for m in
                                   Cell(cell, tiny_root).end_to_end}
    assert res["attempted"] >= 1 and res["failed"] == 0
    json.dumps(res)


def test_a_traced_run_reads_the_per_layer_metrics(tiny_root):
    res = _run(tiny_root, HYBRID, trace=True)
    assert res["correct"] is True
    # on the CPU no device operation is traced: the device's metrics
    # stay silent, those of the program's own timings are read
    assert {"scene_s", "cull_s", "precompute_s", "final_render_s",
            "steps_per_solve"} <= set(res["metrics"])
    assert "bp_roofline" not in res["metrics"]
    assert "res_ms.step" not in res["metrics"]
    assert res["device"]["window_s"] > 0.0
    assert len(res["breakdown"]["idle_gaps"]) <= 10


def _unchanged(monkeypatch):
    from drtvam_tpu_torch.opt.device_lbfgs import DeviceLinearLBFGS
    monkeypatch.setattr(DeviceLinearLBFGS, "step",
                        lambda self, data, *a, **k: data)


def _half_the_angles(monkeypatch):
    from drtvam_tpu_torch.ops.ballistic import BallisticEngine
    orig = BallisticEngine.render_vol

    def render_vol(self, d, inv_vol):
        d = d.reshape(self.shape_dense[0], -1).clone()
        d[1::2] = 0.0
        return 2.0 * orig(self, d.reshape(-1), inv_vol)
    monkeypatch.setattr(BallisticEngine, "render_vol", render_vol)


def _half_the_pixels(monkeypatch):
    from drtvam_tpu_torch.ops.hybrid import ScatteringEngine
    orig = ScatteringEngine.render_vol

    def render_vol(self, d, inv_vol, seed=0):
        d = d.clone()
        d[1::2] = 0.0
        return 2.0 * orig(self, d, inv_vol, seed)
    monkeypatch.setattr(ScatteringEngine, "render_vol", render_vol)


def _altered(monkeypatch):
    from drtvam_tpu_torch.opt import optimize as opt
    orig = opt._final_render

    def final_render(*a, **k):
        vol = orig(*a, **k).copy()
        vol.reshape(-1)[vol.size // 2] += 0.05 * vol.max()
        return vol
    monkeypatch.setattr(opt, "_final_render", final_render)


@pytest.mark.parametrize("cell,fault", [
    (BALLISTIC, _unchanged), (BALLISTIC, _half_the_angles),
    (BALLISTIC, _altered), (HYBRID, _unchanged), (HYBRID, _half_the_pixels),
    (HYBRID, _altered)])
def test_a_broken_timed_path_is_not_correct(tiny_root, monkeypatch, cell,
                                            fault):
    fault(monkeypatch)
    res = _run(tiny_root, cell)
    assert res["correct"] is False
    failed = [k for k, c in res["checks"].items() if c["value"] > c["limit"]]
    assert failed


def test_the_bf16_control_fails_the_dose_comparison(tiny_root, tmp_path):
    c = Cell(BALLISTIC, tiny_root)
    r = runner.Runner(c, "cpu", str(tmp_path))
    solves, _, _, _ = r.window(np.random.default_rng(SEED), 0.0)
    chk = Checker(c, "cpu")
    s = solves[0]
    sound = chk.numbers(s)
    s.vol = chk.impl.ref.dose(s.patterns, "bf16").numpy().astype(np.float32)
    control = chk.numbers(s)
    assert sound["dose_gap"] <= c.limits["dose_gap"]
    assert control["dose_gap"] > c.limits["dose_gap"]


@pytest.mark.parametrize("control,number", [
    ("config:vial.medium.albedo=0.45", "residual_sum_gap"),
    ("config:spp_ref=1", "residual_noise")])
def test_the_hybrid_controls_fail_the_comparison(tiny_root, tmp_path,
                                                 control, number):
    c = Cell(HYBRID, tiny_root)
    r = runner.Runner(c, "cpu", str(tmp_path))
    undo = readings.apply_control(r, c, control)
    try:
        solves, _, _, _ = r.window(np.random.default_rng(SEED), 0.0)
    finally:
        undo()
    nums = Checker(c, "cpu").numbers(solves[0])
    assert nums[number] > c.limits[number]
