"""Counter-based per-lane RNG of the wavefront path tracer (counterpart
of drtvam_tpu/core/rng.py, bit for bit).

PCG3D (Jarzynski & Olano, "Hash Functions for GPU Rendering", JCGT
2020) over (seed + 0x9E3779B9, lane, counter): draw k of lane i is a
pure function of (seed, i, k), so the adjoint replays the primal's
paths by re-seeding. Each call yields 3 words; a draw consumes 1, 2 or
3 of them and advances the lane's counter by one.

torch on the CPU cannot add or shift uint32, so words live in int64
holding values in [0, 2**32), reduced with `& 0xFFFFFFFF` after every
add and multiply. A product of two words can pass 2**63 and wrap; only
its low 32 bits are kept, and a wrapping multiply leaves those exact
(tests/test_torch_rng.py holds the stream to the JAX package's bits at
edge seeds, lanes and counters). The CUDA kernels (csrc/wf_trace.cuh)
run the same hash in native uint32.
"""
from __future__ import annotations

import torch

MASK = 0xFFFFFFFF
_M = 1664525
_A = 1013904223
_GOLDEN = 0x9E3779B9
_INV24 = 1.0 / (1 << 24)   # exact in float32


def _pcg3d(x, y, z):
    x = (x * _M + _A) & MASK
    y = (y * _M + _A) & MASK
    z = (z * _M + _A) & MASK
    x = (x + y * z) & MASK
    y = (y + z * x) & MASK
    z = (z + x * y) & MASK
    x = x ^ (x >> 16)
    y = y ^ (y >> 16)
    z = z ^ (z >> 16)
    x = (x + y * z) & MASK
    y = (y + z * x) & MASK
    z = (z + x * y) & MASK
    return x, y, z


def _to_unit(bits):
    # top 24 bits -> [0, 1) float32, exact
    return (bits >> 8).to(torch.float32) * _INV24


class Sampler:
    """Per-lane sampler over a wavefront.

    Lane ids and counters are int64 tensors holding uint32 values:
        ctr = sampler.init(n, device)
        u, ctr = sampler.next_1d(lane, ctr)
    The seed is baked at construction."""

    def __init__(self, seed):
        self.seed = int(seed) & MASK
        self.key = (self.seed + _GOLDEN) & MASK

    def init(self, n, device="cpu"):
        return torch.zeros((n,), dtype=torch.int64, device=device)

    def _hash(self, lane, ctr):
        key = torch.full_like(lane, self.key)
        return _pcg3d(key, lane, ctr)

    def next_1d(self, lane, ctr):
        x, _, _ = self._hash(lane, ctr)
        return _to_unit(x), (ctr + 1) & MASK

    def next_2d(self, lane, ctr):
        x, y, _ = self._hash(lane, ctr)
        return torch.stack([_to_unit(x), _to_unit(y)], -1), (ctr + 1) & MASK

    def next_3d(self, lane, ctr):
        x, y, z = self._hash(lane, ctr)
        u = torch.stack([_to_unit(x), _to_unit(y), _to_unit(z)], -1)
        return u, (ctr + 1) & MASK
