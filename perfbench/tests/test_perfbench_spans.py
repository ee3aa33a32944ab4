"""harness/spans.py on a synthetic Chrome trace (nested spans on the
program's thread, a launch from the autograd engine's thread, operations
tied to their launches by correlation id), and the readers of the
program's spans and counters: found by name, silent (None) where a trace
or a timings dict lacks what they read, as at a parent that has no
spans."""
import types

import pytest

from perfbench.harness import spans
from perfbench.harness.manifest import Cell

MAIN, AUTOGRAD = 1, 2
SPAN_READERS = ("resample_ms.step", "loss_ms.step", "lbfgs_ms.step")
TIMING_READERS = ("voxelize_s", "target_io_s", "fan_s", "fan_builds",
                  "chords_s")


def _span(name, ts, dur, tid=MAIN):
    return {"ph": "X", "cat": "user_annotation", "name": name, "ts": ts,
            "dur": dur, "pid": 0, "tid": tid}


def _launch(corr, ts, tid=MAIN):
    return {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
            "ts": ts, "dur": 1.0, "pid": 0, "tid": tid,
            "args": {"correlation": corr}}


def _op(corr, ts, dur, cat="kernel"):
    return {"ph": "X", "cat": cat, "name": f"k{corr}", "ts": ts,
            "dur": dur, "pid": 9, "tid": 7, "args": {"correlation": corr}}


def _trace():
    """Two steps of 100 us: render (resample inside) 0-40, loss 40-60
    whose backward launches on the autograd thread, lbfgs 60-80; one
    launch in each step outside any span but the step, one operation
    with no launch."""
    ev = [_span("loop", 0, 200)]
    for k, t in enumerate((0.0, 100.0)):
        ev += [_span("step", t, 100), _span("render", t, 40),
               _span("resample", t + 5, 10), _span("loss", t + 40, 20),
               _span("lbfgs", t + 60, 20)]
        c = 10 * k
        ev += [_launch(c + 1, t + 6), _op(c + 1, t + 10, 4),
               _launch(c + 2, t + 20), _op(c + 2, t + 20, 10),
               _launch(c + 3, t + 45, tid=AUTOGRAD), _op(c + 3, t + 45, 6),
               _launch(c + 4, t + 65), _op(c + 4, t + 66, 2, "gpu_memcpy"),
               _launch(c + 5, t + 90), _op(c + 5, t + 90, 1)]
    return ev + [_op(99, 300, 5)]


def test_operations_are_put_under_the_spans_of_their_launch():
    ev = _trace()
    under = {e["args"]["correlation"]: names
             for e, names in spans.launched_under(ev)}
    assert under[1] == ("loop", "step", "render", "resample")
    assert under[2] == ("loop", "step", "render")
    assert under[3] == ("loop", "step", "loss")     # from the other thread
    assert under[14] == ("loop", "step", "lbfgs")
    assert under[5] == ("loop", "step") and under[99] == ()
    assert spans.device_us_under(ev, "render") == 2 * (4 + 10)
    assert spans.device_us_under(ev, "resample") == 2 * 4
    assert spans.device_us_under(ev, "loss") == 2 * 6
    assert spans.device_us_under(ev, "lbfgs") == 2 * 2
    assert spans.device_us_under(ev, "search") is None
    assert spans.device_us_by_leaf(ev) == {
        "resample": 8.0, "render": 20.0, "loss": 12.0, "lbfgs": 4.0,
        "step": 2.0, None: 5.0}


def test_idle_is_split_by_the_innermost_span():
    ev = [_span("optimize", 0, 100), _span("scene", 0, 30),
          _span("voxelize", 5, 20), _span("fan", 40, 30),
          _launch(1, 72), _op(1, 80, 10)]
    idle = spans.idle_by_span(ev, (0.0, 120.0))
    assert idle == pytest.approx({"scene": 10.0, "voxelize": 20.0,
                                  "optimize": 30.0, "fan": 30.0,
                                  None: 20.0})
    assert sum(idle.values()) == pytest.approx(120.0 - 10.0)
    assert spans.idle_by_span([_op(1, 0, 5)], (0.0, 10.0)) == {None: 5.0}


def test_segments_clip_a_child_to_its_parent():
    segs = spans._segments([(0.0, 10.0, "a"), (5.0, 10.0005, "b"),
                            (10.0, 12.0, "c")])
    assert segs == [(0.0, 5.0, ("a",)), (5.0, 10.0, ("a", "b")),
                    (10.0, 12.0, ("c",))]


def _ctx(cell, events, timings):
    solve = types.SimpleNamespace(steps=2, timings=timings)
    return types.SimpleNamespace(
        cell=cell, loop={"events": events, "solve": solve}, solves=[solve],
        mean_timing=lambda k: timings.get(k))


def test_the_readers_read_spans_and_counters_or_nothing(tiny_root):
    cell = Cell("benchy-sq-scatter.hybrid-sa-radon", tiny_root)
    names = {m["name"] for m in cell.per_layer}
    assert set(SPAN_READERS) | set(TIMING_READERS) | \
        {"search_evals.step"} <= names
    with_spans = _ctx(cell, _trace(), {"search_evals": 5, "fan_s": 1.5,
                                       "fan_builds": 3, "chords_s": 0.5,
                                       "voxelize_s": 0.2,
                                       "target_io_s": 0.1})
    without = _ctx(cell, [e for e in _trace()
                          if e["cat"] != "user_annotation"], {})
    want = {"resample_ms.step": 4e-3, "loss_ms.step": 6e-3,
            "lbfgs_ms.step": 2e-3, "search_evals.step": 2.5,
            "voxelize_s": 0.2, "target_io_s": 0.1, "fan_s": 1.5,
            "fan_builds": 3, "chords_s": 0.5}
    for name, value in want.items():
        read = cell.metric_reader(name)
        assert read(with_spans) == pytest.approx(value), name
        assert read(without) is None, name
    # no device operation (a CPU run): the device readers stay silent
    cpu = _ctx(cell, [e for e in _trace() if e["cat"] == "user_annotation"],
               {})
    assert all(cell.metric_reader(n)(cpu) is None for n in SPAN_READERS)
    idx = Cell("benchy-idx.ballistic", tiny_root)
    assert set(SPAN_READERS) <= {m["name"] for m in idx.per_layer}
    assert not set(TIMING_READERS) & {m["name"] for m in idx.per_layer}
