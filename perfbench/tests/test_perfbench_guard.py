"""The JAX guard compares whole top-level names; the reference imports
nothing of the program; no file of the benchmark reads the JAX
package's benchmark, bench.py or a fixed path under /tmp; a run
without a card, or without the program, prints no result."""
import ast
import os
import subprocess
import sys

from perfbench.harness import guard

from conftest import ROOT

BENCH = os.path.join(ROOT, "perfbench")


def test_guard_compares_whole_top_level_names():
    assert guard.jax_modules({"drtvam_tpu_torch", "drtvam_tpu_torch.ops",
                              "numpy", "jaxtyping"}) == set()
    assert guard.jax_modules({"drtvam_tpu.ops.march", "jaxlib.xla_client",
                              "flax.linen", "jax"}) == \
        {"drtvam_tpu", "jaxlib", "flax", "jax"}


def _sources(sub=""):
    for d, _, files in os.walk(os.path.join(BENCH, sub)):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def _imports(path):
    with open(path) as f:
        tree = ast.parse(f.read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_reference_imports_nothing_of_the_program():
    for p in _sources("reference"):
        tops = {m.split(".")[0] for m in _imports(p)}
        assert not tops & {"drtvam_tpu_torch", "drtvam_tpu", "jax"}, p


def test_nothing_imports_jax_or_the_jax_package():
    for p in _sources():
        tops = {m.split(".")[0] for m in _imports(p)}
        assert not tops & guard.FORBIDDEN, p


def test_no_file_reads_bench_py_benchmarks_or_tmp():
    for p in _sources():
        if os.sep + "tests" + os.sep in p:
            continue
        with open(p) as f:
            text = f.read()
        for word in ("benchmarks/", "bench.py", "'/tmp", '"/tmp'):
            assert word not in text, (p, word)


def test_no_result_without_a_card_or_without_the_program(tmp_path):
    import shutil
    import torch
    if not torch.cuda.is_available():
        r = subprocess.run([sys.executable, "perfbench/run.py",
                            "--workload", "benchy-idx.ballistic", "--seed",
                            "3", "--seconds", "1", "--trace", "0"],
                           cwd=ROOT, capture_output=True, text=True,
                           timeout=300)
        assert r.returncode != 0 and r.stdout.strip() == ""
    # a directory with BENCHMARK.json and the benchmark's files alone
    shutil.copytree(BENCH, tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("tests", "__pycache__"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    env = dict(os.environ, PYTHONPATH="")
    r = subprocess.run([sys.executable, "perfbench/run.py", "--workload",
                        "benchy-idx.ballistic", "--seed", "3", "--seconds",
                        "1", "--trace", "0"], cwd=tmp_path, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode != 0 and r.stdout.strip() == ""
