"""The harness's copies of the program's arithmetic against their
originals: the IoU sweep (utils/metrics.py), the backprojection bound
(chip_smoke.py `bound`, `compulsory_bytes`) and the trace summary
(chip_smoke.py `trace_summary`)."""
import importlib.util
import json
import os
import types

import numpy as np
import pytest

from perfbench.harness import iou, peaks
from perfbench.harness import trace as tr

from conftest import ROOT


@pytest.fixture(scope="module")
def cs():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_best_iou_is_the_program_s(seed):
    from drtvam_tpu_torch.utils.metrics import best_iou
    rng = np.random.default_rng(seed)
    tgt = (rng.uniform(size=(12, 10, 9, 1)) > 0.6).astype(np.float32)
    vol = (tgt * rng.uniform(0.7, 1.2, tgt.shape) +
           rng.uniform(0.0, 0.9, tgt.shape)).astype(np.float32)
    assert iou.best_iou(vol, tgt) == best_iou(vol, tgt, n_thresholds=301)


@pytest.mark.parametrize("taps,bf", [(1_000_000, False), (10, False),
                                     (52_000_000, False)])
def test_bp_bound_is_chip_smoke_s(cs, taps, bf):
    A, Zf, U, Y, X = 400, 256, 400, 256, 256
    fields = types.SimpleNamespace(
        A=A, U=U, Y=Y, X=X,
        F=types.SimpleNamespace(numel=lambda: A * 2 * Y * X))
    nb = peaks.bp_bytes(A, Zf, U, Y, X)
    assert nb == cs.compulsory_bytes("bp_fwd", fields, Zf) == \
        cs.compulsory_bytes("bp_bwd", fields, Zf)
    ms, by = cs.bound(taps, Zf, nb)
    s, by2 = peaks.bp_bound_s(taps, Zf, nb)
    assert by == by2 and s * 1e3 == pytest.approx(ms, rel=1e-12)
    assert peaks.F32_FLOPS == cs.F32_FLOPS
    assert peaks.HBM_BYTES_PER_S == cs.HBM_BYTES_PER_S


def _trace(path, events):
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, "h_1.1.pt.trace.json"), "w") as f:
        json.dump({"traceEvents": events}, f)
    return str(path)


EVENTS = [
    {"ph": "X", "cat": "cpu_op", "name": "aten::add", "ts": 0, "dur": 100},
    {"ph": "X", "cat": "kernel", "name": "void fwd_kernel<float>", "ts": 10,
     "dur": 20},
    {"ph": "X", "cat": "kernel", "name": "elementwise", "ts": 25, "dur": 15},
    {"ph": "X", "cat": "kernel", "name": "void fwd_kernel<float>", "ts": 60,
     "dur": 10},
    {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy HtoD", "ts": 80,
     "dur": 5},
    {"ph": "i", "name": "marker", "ts": 3},
]


def test_trace_summary_agrees_with_chip_smoke_s(cs, tmp_path):
    d = _trace(tmp_path / "t", EVENTS)
    ev = tr.load(tr.trace_file(d))
    mine = tr.summarize(ev)
    kernels_only = [e for e in ev if e.get("cat") != "gpu_memcpy"]
    theirs = cs.trace_summary(d)
    assert mine["window_us"] == theirs["window_us"] == 100
    # chip_smoke counts kernels alone; the harness adds copies and fills
    assert tr.summarize(kernels_only)["busy_us"] == theirs["kernel_us"] == 40
    assert mine["busy_us"] == 45
    assert mine["by_name"]["void fwd_kernel<float>"] == [2, 30.0]
    assert mine["gaps"] == [(0.0, 10.0), (40.0, 60.0), (70.0, 80.0),
                            (85.0, 100.0)]


def test_trace_window_clips_the_operations():
    s = tr.summarize([e for e in EVENTS if e["ph"] == "X"], (20, 65))
    assert s["window_us"] == 45
    assert s["busy_us"] == 25   # [20, 40] and [60, 65]
    assert tr.host_op_at(EVENTS, 50) == "aten::add"
