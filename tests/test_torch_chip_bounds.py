"""chip_smoke.py's bounds of the dda residual forward as the final render
runs it (its path pass and walk pass, dda_bounds): with the target kept,
its grid cells and triangle tests count in the whole forward's bound and
in the path pass's, which also counts its records at 32 bytes; the walk
pass's counts its steps alone. The prologue forms' bound (phase 18), the
summary of a `profile` trace (phase 19) and the names of the prologue
kernels' instantiations in the build record."""
import importlib.util
import os

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def cs():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# the final render's counts on a surface-aware film's scale: 0.647 G lanes
# (spp 16), ~3.9 bounces, ~2.4 records, ~131 triangle tests a lane
N_ACTIVE, N_CELLS, SPP = 40_462_400, 256 ** 3, 16
STATS = {"iterations": 2_526_712_122, "steps": 99_439_832_971,
         "records": 1_544_328_350, "cells": 3_002_222_005,
         "triangles": 84_765_719_048}


@pytest.mark.parametrize("target", [True, False])
def test_final_render_bounds_count_each_pass_s_work(cs, target):
    stats = dict(STATS) if target else dict(STATS, cells=0, triangles=0)
    lanes = N_ACTIVE * SPP
    b = cs.dda_bounds(N_ACTIVE, N_CELLS, lanes, stats)
    ms = 1e3 / cs.F32_FLOPS
    path_ops = (cs.RES_LANE_OPS * lanes + cs.RES_EVENT_OPS *
                stats["iterations"] + cs.CULL_CELL_OPS * stats["cells"] +
                cs.CULL_TRI_OPS * stats["triangles"])
    path_bytes = (4 * N_ACTIVE + 32 * stats["records"]) / \
        cs.HBM_BYTES_PER_S * 1e3
    assert b["path_"][0] == pytest.approx(max(path_ops * ms, path_bytes))
    assert b[""][0] == pytest.approx(
        (path_ops + cs.WF_STEP_OPS * stats["steps"]) * ms)
    assert b["walk_"] == (pytest.approx(cs.WF_STEP_OPS * stats["steps"] * ms),
                          "operations")
    # the target's triangle tests are most of the path pass's work; without
    # them the path pass's records set its bound
    assert b["path_"][1] == ("operations" if target else "bytes")
    if target:
        no_mesh = cs.dda_bounds(N_ACTIVE, N_CELLS, lanes,
                                dict(STATS, cells=0, triangles=0))
        assert b["path_"][0] > 3 * no_mesh["path_"][0]
        assert b[""][0] - no_mesh[""][0] == pytest.approx(
            (cs.CULL_CELL_OPS * STATS["cells"] +
             cs.CULL_TRI_OPS * STATS["triangles"]) * ms)


def test_prologue_bound_counts_the_prologue_iterations(cs):
    """A prologue form's bound: res_bound's work plus each prologue
    iteration's bookkeeping and analytic surface tests."""
    stats = {"iterations": 1000, "steps": 0, "prologue_iters": 5000,
             "cells": 30, "triangles": 70}
    ms, by = cs.prologue_bound(400, 100, stats, 3)
    ops = (cs.RES_LANE_OPS * 100 + cs.RES_EVENT_OPS * 1000 +
           cs.CULL_CELL_OPS * 30 + cs.CULL_TRI_OPS * 70 +
           (cs.PROLOGUE_ITER_OPS + 3 * cs.CULL_SURF_OPS) * 5000)
    assert (ms, by) == (pytest.approx(ops / cs.F32_FLOPS * 1e3),
                        "operations")
    assert cs.prologue_bound(1 << 40, 100, stats, 3)[1] == "bytes"


def _trace(path, events):
    import json
    path.mkdir()
    (path / "host_1.123.pt.trace.json").write_text(json.dumps(
        {"traceEvents": events}))
    return str(path)


def test_trace_summary_merges_the_kernel_intervals(cs, tmp_path):
    """The busy share counts each instant once where kernels overlap (two
    streams), over the window of every complete event; the kernels sorted
    by device time with their launches."""
    ev = [{"ph": "X", "cat": "cpu_op", "name": "aten::mm", "ts": 0,
           "dur": 100},
          {"ph": "X", "cat": "kernel", "name": "void fwd_kernel<float>()",
           "ts": 10, "dur": 20},
          {"ph": "X", "cat": "kernel", "name": "void bwd_kernel<float>()",
           "ts": 25, "dur": 10},
          {"ph": "X", "cat": "kernel", "name": "void fwd_kernel<float>()",
           "ts": 60, "dur": 40},
          {"ph": "i", "cat": "marker", "name": "x", "ts": 500}]
    s = cs.trace_summary(_trace(tmp_path / "t", ev))
    assert s["window_us"] == 100 and s["kernel_us"] == 25 + 40
    assert s["busy_share"] == pytest.approx(0.65)
    assert s["kernel_launches"] == 3
    top = s["top_kernels"]
    assert [k["name"] for k in top] == ["void fwd_kernel<float>()",
                                        "void bwd_kernel<float>()"]
    assert (top[0]["launches"], top[0]["total_us"]) == (2, 60.0)


def test_trace_summary_of_a_cpu_trace(cs, tmp_path):
    """torch.profiler's own Chrome trace of a CPU run (as the port's
    `profile` writes it): operator events, no kernel, a busy share of 0."""
    import torch
    from torch.profiler import (ProfilerActivity, profile,
                                tensorboard_trace_handler)
    d = str(tmp_path / "trace")
    with profile(activities=[ProfilerActivity.CPU],
                 on_trace_ready=tensorboard_trace_handler(d)):
        x = torch.ones(64, 64)
        (x @ x).sum()
    s = cs.trace_summary(d)
    assert s["events"] > 0 and s["kernel_launches"] == 0
    assert s["busy_share"] == 0.0 and s["window_us"] > 0


@pytest.mark.parametrize("mangled,name", [
    ("_ZN2wf19res_prologue_kernelILi2ELi3ELb1ELb0ELb0ELb1EEEv8WfParams",
     "residual DELTA, FAST_RESIDUAL, prologue, forward, target"),
    ("_ZN2wf10res_kernelILi0ELi2ELb1ELb1ELb1ELb0EEEv8WfParams",
     "residual DDA, FIRST_SCATTER, path pass, counting"),
    ("_ZN2wf23res_tgt_prologue_kernelILb1ELb0EEEv8WfParams",
     "residual target path pass, DDA, FIRST_SCATTER, prologue, counting, "
     "global banks"),
    ("_ZN2wf19res_tgt_path_kernelILi2ELb0ELb1EEEv8WfParams",
     "residual target path pass, DDA, FIRST_SCATTER, staged")])
def test_instantiation_names_the_prologue_kernels(cs, mangled, name):
    assert cs.instantiation(mangled) == name
