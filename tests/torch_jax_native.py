"""The JAX package's native host libraries, loaded for a port test module
before its JAX code runs. Import the fixture into a test module to apply
it there.

The JAX package builds `libtransport2d.so` and `libmesh_accel.so` with
g++ straight onto their load paths at first use, and caches a failed
load for the rest of the process. Under several test workers one worker
can load another's half-written library, fail, and then voxelize every
target with the JAX package's jnp path, whose targets differ from the
native ones (ROADMAP queue 3): the port's tests would then compare the
port against another reference. The fixture serialises the first build
and load across this host's workers with a file lock, retries a load that
failed, and asserts that the native voxelizer answers.
"""
import fcntl
import os
import tempfile
import time

import numpy as np
import pytest

LOCK = os.path.join(tempfile.gettempdir(), "drtvam_tpu_native.lock")
TRIES = 5


def _load_native():
    from drtvam_tpu import native
    for k in ("transport2d", "mesh_accel"):
        if native._libs.get(k, False) is None:
            del native._libs[k]
    return native.available() and native.mesh_accel_available()


def _voxelizes():
    from drtvam_tpu.native import voxelize_mesh_native
    v0 = np.array([[-0.5, -0.5, 0.0]], np.float32)
    e1 = np.array([[1.0, 0.0, 0.0]], np.float32)
    e2 = np.array([[0.0, 1.0, 0.0]], np.float32)
    out = voxelize_mesh_native((v0, e1, e2), np.full(3, -1.0, np.float32),
                               np.full(3, 1.0, np.float32), (4, 4, 4), 0)
    return isinstance(out, np.ndarray) and out.shape == (4, 4, 4)


@pytest.fixture(autouse=True, scope="module")
def jax_native_libraries():
    with open(LOCK, "w") as f:
        fcntl.flock(f, fcntl.LOCK_EX)
        try:
            for i in range(TRIES):
                if _load_native():
                    break
                time.sleep(1.0 + i)
        finally:
            fcntl.flock(f, fcntl.LOCK_UN)
    assert _voxelizes(), ("the JAX package's native voxelizer did not "
                          "load: its jnp fallback gives other targets")
    yield
