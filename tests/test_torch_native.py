"""drtvam_tpu_torch builds only from its own sources.

The port keeps its own copy of the host C++ it runs (csrc/host/) and its
CUDA kernels (csrc/): every source and include directory that native.py
hands to g++ or nvcc must lie under drtvam_tpu_torch/, and no module of
the port names a path into the JAX package."""
import os
import re
from unittest import mock

import pytest

from drtvam_tpu_torch import native
from drtvam_tpu_torch.ops import backproject as bp

PKG = os.path.dirname(os.path.abspath(native.__file__))


def _compiled_paths(monkeypatch, build):
    """Run `build` with the compilers and the loader stubbed out; return
    every source file and include directory of the commands issued."""
    cmds = []
    monkeypatch.setattr(native, "_libs", {})
    monkeypatch.setattr(native, "_stale", lambda lib, deps: True)
    monkeypatch.setattr(native, "_start",
                        lambda cmd, lib_path: cmds.append(cmd) or cmd)
    monkeypatch.setattr(native, "_finish", lambda job, timeout=600: None)
    monkeypatch.setattr(native.ctypes, "CDLL", lambda path: mock.MagicMock())
    build()
    paths = []
    for cmd in cmds:
        paths += [a for a in cmd if a.endswith((".cpp", ".cu"))]
        paths += [cmd[i + 1] for i, a in enumerate(cmd) if a == "-I"]
    return cmds, paths


def _under_pkg(path):
    return os.path.commonpath([os.path.realpath(path), PKG]) == PKG


@pytest.mark.parametrize("name", sorted(native._HOST_SETUP))
def test_host_sources_are_the_ports_own(name, monkeypatch):
    cmds, paths = _compiled_paths(monkeypatch,
                                  lambda: native.load_host(name))
    assert len(cmds) == 1 and paths
    for p in paths:
        assert _under_pkg(p) and os.path.exists(p), p


def test_cuda_sources_are_the_ports_own(monkeypatch):
    cmds, paths = _compiled_paths(monkeypatch, bp.build_kernels)
    assert len(cmds) == len(bp.KERNELS)
    assert sorted(os.path.basename(p) for p in paths
                  if p.endswith(".cu")) == sorted(k + ".cu"
                                                  for k in bp.KERNELS)
    for p in paths:
        assert _under_pkg(p) and os.path.exists(p), p


def test_no_module_names_a_path_into_the_jax_package():
    """A string literal naming drtvam_tpu as a path component (the old
    by-path build joined "drtvam_tpu", "native")."""
    pat = re.compile(r"""["']drtvam_tpu(/[^"']*)?["']""")
    hits = []
    for root, _, files in os.walk(PKG):
        for f in files:
            if f.endswith(".py"):
                path = os.path.join(root, f)
                with open(path) as fh:
                    hits += [f"{path}: {m.group(0)}"
                             for m in pat.finditer(fh.read())]
    assert not hits, hits
