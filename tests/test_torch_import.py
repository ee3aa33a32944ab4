"""drtvam_tpu_torch imports without jax and never imports jax, optax or
the JAX package (importing anything under drtvam_tpu loads jax)."""
import os
import re
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "drtvam_tpu_torch")
FORBIDDEN = re.compile(
    r"^\s*(import|from)\s+(jax|optax|drtvam_tpu)(\.|\s|,|$)", re.M)


def _sources():
    for d, _, files in os.walk(PKG):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)
    yield os.path.join(ROOT, "chip_smoke.py")


def test_every_module_imports_with_jax_blocked():
    code = """
import importlib, pkgutil, sys
sys.modules["jax"] = None
sys.modules["optax"] = None
sys.modules["drtvam_tpu"] = None
import drtvam_tpu_torch
names = [m.name for m in pkgutil.walk_packages(drtvam_tpu_torch.__path__,
                                               "drtvam_tpu_torch.")
         if m.name != "drtvam_tpu_torch.__main__"]
for n in names:
    importlib.import_module(n)
assert "jax" not in sys.modules or sys.modules["jax"] is None
print(len(names))
"""
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 20


def test_no_jax_or_reference_imports_in_sources():
    bad = []
    for path in _sources():
        with open(path) as f:
            for m in FORBIDDEN.finditer(f.read()):
                bad.append(f"{os.path.relpath(path, ROOT)}: {m.group(0)}")
    assert not bad, bad


def test_parallel_imports_without_jax_triton_or_nvcc():
    """drtvam_tpu_torch.parallel (torch.distributed) imports with jax,
    triton and the JAX package blocked and no nvcc on PATH, and loads
    none of them."""
    code = """
import sys
for name in ("jax", "optax", "triton", "drtvam_tpu"):
    sys.modules[name] = None
from drtvam_tpu_torch.parallel import multihost, shard
assert callable(shard.render_sharded) and callable(multihost.init_multihost)
assert not [m for m in sys.modules if m.split(".")[0] in
            ("jax", "triton", "drtvam_tpu") and sys.modules[m] is not None]
"""
    env = dict(os.environ, PATH=os.path.dirname(sys.executable))
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    srcs = [os.path.join(PKG, "parallel", f)
            for f in ("__init__.py", "shard.py", "multihost.py")]
    for path in srcs:
        with open(path) as f:
            assert not FORBIDDEN.search(f.read()), path
