"""BENCHMARK.json and the files it names, found by name.

A cell (`workloads` entry) names a configuration (`configs` entry, its
`file`) and a traffic mix (`traffic/<name>.json`); each per-layer
metric is `metrics/<name>.py`, each cell's limits of the correctness
comparison `limits/<cell>.json`. Nothing here lists a cell, a
configuration, a mix or a metric: adding one is adding its files and
its entry in BENCHMARK.json.
"""
from __future__ import annotations

import importlib.util
import json
import os

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)

# keys of a configuration file that describe it and are not the
# program's configuration
DESCRIPTIVE = ("source", "reduced", "assumed", "phantom")


def load_manifest(root=ROOT):
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


class Cell:
    """One workload of the manifest with everything it names."""

    def __init__(self, name, root=ROOT):
        self.root = root
        self.bench_dir = os.path.join(root, "perfbench")
        man = load_manifest(root)
        cells = {w["name"]: w for w in man["workloads"]}
        if name not in cells:
            raise KeyError(f"no workload '{name}' in BENCHMARK.json (have "
                           f"{sorted(cells)})")
        self.entry = cells[name]
        self.name = name
        self.chips = int(self.entry["chips"])
        self.run_seconds = int(man["run_seconds"])
        confs = {c["name"]: c for c in man["configs"]}
        self.config_entry = confs[self.entry["config"]]
        with open(os.path.join(root, self.config_entry["file"])) as f:
            self.config = json.load(f)
        with open(os.path.join(self.bench_dir, "traffic",
                               self.entry["traffic"] + ".json")) as f:
            self.traffic = json.load(f)
        with open(os.path.join(self.bench_dir, "limits",
                               name + ".json")) as f:
            self.limits = json.load(f)
        self.end_to_end = [m for m in man["end_to_end"]
                           if name in m.get("workloads", [name])]
        self.per_layer = [m for m in man["per_layer"]
                          if name in m.get("workloads", [name])]

    def program_config(self):
        """The configuration as the program reads it: the file without
        its descriptive keys, merged with the traffic mix's `optimize`
        keys (no target file and no output yet). A mix's `film` keys go
        into the loop's film; the configuration's own sensor then
        becomes the final sensor."""
        cfg = json.loads(json.dumps(
            {k: v for k, v in self.config.items() if k not in DESCRIPTIVE}))
        cfg.update(json.loads(json.dumps(self.traffic["optimize"])))
        if self.traffic.get("film"):
            cfg["final_sensor"] = json.loads(json.dumps(cfg["sensor"]))
            cfg["sensor"]["film"].update(self.traffic["film"])
        return cfg

    def metric_reader(self, name):
        """`read(ctx)` of metrics/<name>.py."""
        path = os.path.join(self.bench_dir, "metrics", name + ".py")
        spec = importlib.util.spec_from_file_location(
            "perfbench_metric_" + name.replace(".", "_").replace("-", "_"),
            path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod.read
