"""A configuration, a traffic mix with a comparison of its own and a
per-layer metric are taken up as new files and entries of
BENCHMARK.json, with no existing file of the benchmark edited."""
import hashlib
import json
import os
import types

import numpy as np

from perfbench.harness.check import Checker
from perfbench.harness.manifest import Cell

# a comparison of the test's own: the summed final dose against the
# reference's dose of the final patterns
REFERENCE = '''
from perfbench.reference.ballistic import Check as Ballistic


class Check(Ballistic):
    NAMES = ("dose_sum_gap",)

    def numbers(self, s):
        d = self.ref.dose(s.patterns)
        return {"dose_sum_gap": abs(float(s.vol.sum()) / float(d.sum())
                                    - 1.0)}
'''


def _digest(root):
    out = {}
    for d, _, files in os.walk(os.path.join(root, "perfbench")):
        for f in files:
            p = os.path.join(d, f)
            with open(p, "rb") as fh:
                out[os.path.relpath(p, root)] = hashlib.sha256(
                    fh.read()).hexdigest()
    return out


def test_new_files_are_found_by_name(tiny_root):
    before = _digest(tiny_root)
    pb = os.path.join(tiny_root, "perfbench")
    with open(os.path.join(pb, "configs", "benchy-idx.json")) as f:
        cfg = json.load(f)
    cfg["vial"] = {"type": "square", "w_int": 6.8, "w_ext": 7.2,
                   "ior": 1.54, "medium": cfg["vial"]["medium"]}
    with open(os.path.join(pb, "configs", "benchy-sq.json"), "w") as f:
        json.dump(cfg, f)
    with open(os.path.join(pb, "traffic", "ballistic.json")) as f:
        traffic = json.load(f)
    traffic["optimize"]["n_steps"] = 3
    traffic["check"] = {"reference": "dose_sum"}
    with open(os.path.join(pb, "traffic", "short.json"), "w") as f:
        json.dump(traffic, f)
    with open(os.path.join(pb, "reference", "dose_sum.py"), "w") as f:
        f.write(REFERENCE)
    with open(os.path.join(pb, "limits", "benchy-sq.short.json"), "w") as f:
        json.dump({"dose_sum_gap": 1e-9}, f)
    with open(os.path.join(pb, "metrics", "loop_s.py"), "w") as f:
        f.write("def read(ctx):\n    return ctx.mean_timing('loop_s')\n")
    man_path = os.path.join(tiny_root, "BENCHMARK.json")
    with open(man_path) as f:
        man = json.load(f)
    man["configs"].append({"name": "benchy-sq", "source": "x",
                           "file": "perfbench/configs/benchy-sq.json",
                           "reduced": [], "why": "x"})
    man["workloads"].append({"name": "benchy-sq.short", "config":
                             "benchy-sq", "traffic": "short", "chips": 1,
                             "why": "x"})
    man["per_layer"].append({"name": "loop_s", "unit": "s", "better":
                             "lower", "source": "program_span", "layer":
                             "optimizer + loss", "moves": "solve_s",
                             "workloads": ["benchy-sq.short"]})
    with open(man_path, "w") as f:
        json.dump(man, f)
    after = _digest(tiny_root)
    assert all(after[k] == v for k, v in before.items())

    cell = Cell("benchy-sq.short", tiny_root)
    assert cell.config["vial"]["type"] == "square"
    assert cell.program_config()["n_steps"] == 3
    assert [m["name"] for m in cell.per_layer] == ["loop_s"]
    read = cell.metric_reader("loop_s")

    class Ctx:
        def mean_timing(self, key):
            return {"loop_s": 1.5}[key]
    assert read(Ctx()) == 1.5
    chk = Checker(cell, "cpu")
    assert chk.names == ("dose_sum_gap",)
    cfg = cell.program_config()
    pat = np.ones((cfg["projector"]["n_patterns"], cfg["projector"]["resy"],
                   cfg["projector"]["resx"]), np.float32)
    s = types.SimpleNamespace(patterns=pat,
                              vol=chk.impl.ref.dose(pat).numpy())
    ok, checks, _ = chk.run([s], np.random.default_rng(0))
    assert ok and checks["dose_sum_gap"]["value"] < 1e-12
    old = Cell("benchy-idx.ballistic", tiny_root)
    assert "loop_s" not in [m["name"] for m in old.per_layer]
    assert "phantom" not in cell.program_config()
