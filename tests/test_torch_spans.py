"""The spans and counters of the port's optimize()
(drtvam_tpu_torch/utils/spans.py), on the CPU, on the tiny configs of
test_torch_profile.py: `timings` keeps every key it had and adds the
host spans' seconds and the counters (`fan_builds`: one host fan for each
engine built; `search_evals`: one for each Armijo candidate); each span
lies inside its phase, in the timings and in a torch.profiler trace of
the call; and without a profiler recording no span enters
`record_function`."""
import json

import pytest
import torch

from drtvam_tpu_torch.opt import optimize as opt
from drtvam_tpu_torch.utils import spans
from test_torch_profile import _config
from torch_threads import one_torch_thread  # noqa: F401

# the keys optimize() filled before it had spans
PHASE_KEYS = {"scene_s", "cull_s", "precompute_s", "loop_s",
              "final_render_s", "artifacts_s", "checkpoint_write_s",
              "active_pixels"}
# the host spans a ballistic run times, and its counters
HOST_SPANS = {"optimize_s", "scene_build_s", "voxelize_s", "target_io_s",
              "build_s", "fan_s", "layout_s", "upload_s", "z_taps_s",
              "pixels_s", "inv_volume_s", "dose_files_s", "pattern_files_s",
              "histogram_s"}
COUNTERS = {"fan_builds", "search_evals"}
# spans around device work in flight: in a trace, never in `timings`
TRACE_ONLY = {"step", "render", "resample", "loss", "pattern_grad",
              "lbfgs", "search", "readback", "pack"}
# each sub-span and the phase span it lies in
INSIDE = {"scene_build": "scene", "voxelize": "scene", "target_io": "scene",
          "cull_adjoint": "cull", "step": "loop", "dose_files": "artifacts",
          "pattern_files": "artifacts", "histogram": "artifacts",
          "scene": "optimize", "cull": "optimize", "loop": "optimize",
          "final_render": "optimize", "artifacts": "optimize"}


def _optimize(work, cfg, **kw):
    return opt.optimize(cfg, resolve_path=opt.make_resolver(str(work)),
                        device="cpu", **kw)


def _hybrid(work, out):
    cfg = _config(work, out, "lbfgs")
    cfg["vial"]["medium"]["albedo"] = 0.5
    cfg.update(filter_radon=True, spp=1, spp_ref=1, n_steps=1)
    return cfg


@pytest.fixture(scope="module")
def work(tmp_path_factory):
    from drtvam_tpu_torch.ops.mesh import make_box_with_hole, save_ply
    path = tmp_path_factory.mktemp("spans")
    save_ply(make_box_with_hole((2.0, 2.0, 0.5), 1.0,
                                hole_center_xy=(-1.0, 0.0)),
             str(path / "box_hole.ply"))
    return path


@pytest.fixture(scope="module")
def traced(work):
    """{config: (timings, user_annotation events)} of the ballistic and
    the hybrid config, each optimized once under a torch.profiler."""
    from torch.profiler import ProfilerActivity, profile
    out = {}
    for name, cfg in (("ballistic", _config(work, "tr_ballistic", "lbfgs")),
                      ("hybrid", _hybrid(work, "tr_hybrid"))):
        t = {}
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            _optimize(work, cfg, timings=t)
        path = work / f"{name}.pt.trace.json"
        prof.export_chrome_trace(str(path))
        events = [e for e in json.loads(path.read_text())["traceEvents"]
                  if e.get("cat") == "user_annotation"]
        out[name] = (t, events)
    return out


def test_timings_keep_their_keys_and_add_the_spans(work):
    t = {}
    _optimize(work, _config(work, "keys", "lbfgs"), timings=t)
    assert PHASE_KEYS | HOST_SPANS | COUNTERS <= set(t)
    assert not {k + "_s" for k in TRACE_ONLY} & set(t)
    assert all(t[k] >= 0.0 for k in HOST_SPANS)


@pytest.mark.parametrize("config", ["ballistic", "hybrid"])
def test_sub_spans_lie_within_their_phases(traced, config):
    t, events = traced[config]
    assert t["scene_build_s"] + t["voxelize_s"] + t["target_io_s"] <= \
        t["scene_s"]
    assert t["dose_files_s"] + t["pattern_files_s"] + t["histogram_s"] <= \
        t["artifacts_s"]
    engine = sum(t.get(k, 0.0) for k in (
        "build_s", "fan_s", "layout_s", "upload_s", "z_taps_s", "pixels_s",
        "chords_s", "inv_volume_s", "cull_adjoint_s"))
    assert engine <= t["cull_s"] + t["precompute_s"] + t["final_render_s"]
    assert sum(t[k] for k in PHASE_KEYS - {"checkpoint_write_s",
                                           "active_pixels"}) <= \
        t["optimize_s"]
    # in the trace, on the kernels' clock: each sub-span inside a span
    # of its phase
    by_name = {}
    for e in events:
        by_name.setdefault(e["name"], []).append(
            (float(e["ts"]), float(e["ts"]) + float(e["dur"])))
    for child, parent in INSIDE.items():
        if child == "cull_adjoint" and config == "ballistic":
            continue
        assert by_name[child], child
        for s, e in by_name[child]:
            assert any(ps <= s + 1e-3 and e <= pe + 1e-3
                       for ps, pe in by_name[parent]), (child, parent)


@pytest.mark.parametrize("config,fans", [("ballistic", 2), ("hybrid", 3)])
def test_fan_builds_count_the_engines(traced, config, fans):
    """The ballistic run rasterizes the loop engine's fan and the final
    render's; the hybrid run with filter_radon the cull's too."""
    t, events = traced[config]
    assert t["fan_builds"] == fans
    assert sum(e["name"] == "fan" for e in events) == fans


def test_search_evals_count_the_candidates(work, monkeypatch):
    calls = []
    make = opt._make_step_fns

    def counted(*a):
        fns = make(*a)
        cand = fns["cand_fn"]

        def cand_fn(*b):
            calls.append(1)
            return cand(*b)
        fns["cand_fn"] = cand_fn
        return fns
    monkeypatch.setattr(opt, "_make_step_fns", counted)
    t = {}
    _optimize(work, _config(work, "evals", "lbfgs"), timings=t)
    assert len(calls) >= 3
    assert t["search_evals"] == len(calls)


def test_no_record_function_without_a_profiler(work, monkeypatch):
    entered = []

    def record_function(name):
        entered.append(name)
        return torch.autograd.profiler.record_function(name)
    monkeypatch.setattr(spans, "record_function", record_function)
    _optimize(work, _config(work, "unprofiled", "lbfgs"))
    assert entered == []
    # the same patch sees the spans of a profiled block
    from torch.profiler import profile
    with profile(), spans.recording({}):
        with spans.span("fan"):
            pass
    assert entered == ["fan"]


def test_spans_and_counters_add_to_the_active_recorder():
    outer, inner = {}, {}
    spans.count("n")          # no recorder: nothing
    with spans.recording(outer):
        with spans.span("a"), spans.span("b", timed=False):
            spans.count("n", 2)
        with spans.recording(inner):
            spans.count("n")
        spans.count("n")

        @spans.span("a")
        def f():
            return 7
        assert f() == 7
    spans.count("n")
    assert set(outer) == {"a_s", "n"} and outer["n"] == 3
    assert inner == {"n": 1}
    assert outer["a_s"] > 0.0
