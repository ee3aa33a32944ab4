"""On the card: one run of each cell at its own size comes out correct
and reports every metric of its cell. Skips without a CUDA device."""
import time

import pytest

from perfbench.harness import runner
from perfbench.harness.manifest import ROOT, Cell, load_manifest

CELLS = [w["name"] for w in load_manifest()["workloads"]]


@pytest.mark.parametrize("cell", CELLS)
def test_a_run_on_the_card_is_correct(cell, cuda_device):
    c = Cell(cell, ROOT)
    res = runner.run(c, 2**32 + 99, 1.0, False, cuda_device,
                     time.perf_counter())
    assert res["correct"] is True, res["checks"]
    assert set(res["metrics"]) == {m["name"] for m in c.end_to_end}
    assert res["device"]["platform"] == "gpu"
