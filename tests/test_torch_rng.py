"""The port's PCG3D sampler == the JAX package's, bit for bit.

The port carries uint32 words in int64 (torch on the CPU cannot add or
shift uint32); products of two words wrap past 2**63 and only their low
32 bits are kept. These tests hold every hash word and every draw to the
JAX package's at edge seeds, lanes and counters."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from drtvam_tpu.core import rng as jrng
from drtvam_tpu_torch.core import rng as trng


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: the plain wavefront's many small ops gain
    nothing from more, and the suite runs several workers on one host,
    where spinning thread pools slow every worker down."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

EDGE = np.array([0, 1, 2, 0x7FFFFFFF, 0x80000000, 0x9E3779B9, 0x61C88646,
                 0x61C88647, 0xFFFFFFFE, 0xFFFFFFFF], np.uint64)
# 0x61C88647 + 0x9E3779B9 wraps to key 0
SEEDS = [0, 1, 12345, 0x61C88647, 0x80000000, 0xFFFFFFFF]


def _grid(seed):
    """Edge values crossed with each other, plus random words."""
    rng = np.random.default_rng(seed % 1000)
    lane, ctr = np.meshgrid(EDGE, EDGE, indexing="ij")
    rand = rng.integers(0, 2 ** 32, (2, 4096), dtype=np.uint64)
    return (np.concatenate([lane.ravel(), rand[0]]).astype(np.uint32),
            np.concatenate([ctr.ravel(), rand[1]]).astype(np.uint32))


def _t(a):
    return torch.from_numpy(a.astype(np.int64))


@pytest.mark.parametrize("seed", SEEDS)
def test_hash_words_bitwise(seed):
    lane, ctr = _grid(seed)
    key = np.uint32((seed + 0x9E3779B9) & 0xFFFFFFFF)
    keys = np.full_like(lane, key)
    jx = [np.asarray(w) for w in jrng._pcg3d(jnp.asarray(keys),
                                             jnp.asarray(lane),
                                             jnp.asarray(ctr))]
    tx = [w.numpy() for w in trng._pcg3d(_t(keys), _t(lane), _t(ctr))]
    for a, b in zip(jx, tx):
        assert b.min() >= 0 and b.max() <= 0xFFFFFFFF
        np.testing.assert_array_equal(b.astype(np.uint32), a)


@pytest.mark.parametrize("seed", SEEDS)
def test_draws_and_counters_bitwise(seed):
    lane, ctr = _grid(seed + 1)
    # the JAX sampler takes seeds past int32 as uint32 (render passes one)
    js, ts = jrng.Sampler(np.uint32(seed)), trng.Sampler(seed)
    jl, jc = jnp.asarray(lane), jnp.asarray(ctr)
    tl, tc = _t(lane), _t(ctr)
    for name in ("next_1d", "next_2d", "next_3d"):
        ju, jc2 = getattr(js, name)(jl, jc)
        tu, tc2 = getattr(ts, name)(tl, tc)
        assert tu.dtype == torch.float32
        np.testing.assert_array_equal(tu.numpy(), np.asarray(ju))
        # the counter wraps at 2**32, as uint32 does
        np.testing.assert_array_equal(tc2.numpy().astype(np.uint32),
                                      np.asarray(jc2))


def test_stream_replays_along_a_path():
    """Draws chained through the counter, as a lane consumes them."""
    lane = np.arange(0, 2 ** 32, 2 ** 22, dtype=np.uint64).astype(np.uint32)
    js, ts = jrng.Sampler(7), trng.Sampler(7)
    jc, tc = js.init(lane.size), ts.init(lane.size)
    jl, tl = jnp.asarray(lane), _t(lane)
    for _ in range(20):
        ju, jc = js.next_2d(jl, jc)
        tu, tc = ts.next_2d(tl, tc)
        np.testing.assert_array_equal(tu.numpy(), np.asarray(ju))
    assert int(tc[0]) == 20
