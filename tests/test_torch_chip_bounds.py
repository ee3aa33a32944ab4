"""chip_smoke.py's bounds of the dda residual forward as the final render
runs it (its path pass and walk pass, dda_bounds): with the target kept,
its grid cells and triangle tests count in the whole forward's bound and
in the path pass's, which also counts its records at 32 bytes; the walk
pass's counts its steps alone."""
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
