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
