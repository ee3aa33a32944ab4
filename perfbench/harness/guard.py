"""The JAX guard: the benchmark runs the PyTorch port alone. A module
counts by its top-level name (the part before the first dot), compared
whole, so that `drtvam_tpu_torch` is not taken for `drtvam_tpu`."""
from __future__ import annotations

import sys

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "drtvam_tpu"})


def jax_modules(modules=None):
    """Top-level names of the loaded modules that are forbidden."""
    names = sys.modules if modules is None else modules
    return {m.split(".", 1)[0] for m in names} & FORBIDDEN
