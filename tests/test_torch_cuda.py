"""The four CUDA backprojection kernels == their plain versions, on a
card. Free of jax (the card's machine has none), so it runs there with

    python -m pytest --noconftest -q tests/test_torch_cuda.py

On a machine without CUDA every test skips; chip_smoke.py phase 3 runs
the same comparison at the bench shapes."""
import numpy as np
import pytest
import torch

from drtvam_tpu_torch.ops import backproject as bp

TOL = 1e-5  # f32 sums in another order; the adjoints use atomics


def _fields(seed, A=5, Y=64, X=128, U=300, Zf=40):
    """Banded u-geometry: u an affine projection of (x, y) per angle."""
    rng = np.random.default_rng(seed)
    W = rng.uniform(0.0, 1.0, (A, Y, X)).astype(np.float32)
    W[W < 0.3] = 0.0
    ys, xs = np.meshgrid(np.arange(Y), np.arange(X), indexing="ij")
    scale = (U - 8) / np.hypot(Y, X) / 2
    Umap = np.empty((A, Y, X), np.float32)
    for a in range(A):
        th = 2 * np.pi * a / A
        proj = np.cos(th) * xs + np.sin(th) * ys
        Umap[a] = (proj - proj.min()) * scale + 3.0 + \
            rng.uniform(-0.4, 0.4, (Y, X))
    Pz = rng.uniform(0.0, 1.0, (A, Zf, U)).astype(np.float32)
    dL = rng.uniform(0.0, 1.0, (Zf, Y * X)).astype(np.float32)
    return [torch.from_numpy(x) for x in (Pz, W, Umap, dL)] + [U]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; chip_smoke.py phase 3 covers it")
    return torch.device("cuda")


def _close(out, ref):
    ref = ref.numpy()
    np.testing.assert_allclose(out.cpu().numpy(), ref, rtol=TOL,
                               atol=TOL * np.abs(ref).max())


@pytest.mark.parametrize("banded", [False, True])
def test_kernels_match_plain(banded, cuda_device):
    Pz, W, Umap, dL, U = _fields(seed=11)
    assert bp.band_span_ok(W, Umap, U)
    cpu = bp.PackedFields(W, Umap, U, banded)
    gpu = bp.PackedFields(W.to(cuda_device), Umap.to(cuda_device), U,
                          banded)
    names = ("bp_fwd_band", "bp_bwd_band") if banded else \
        ("bp_fwd", "bp_bwd")
    before = dict(bp.launches)
    fwd = gpu.forward(Pz.to(cuda_device))
    bwd = gpu.adjoint(dL.to(cuda_device))
    torch.cuda.synchronize()
    for n in names:
        assert bp.launches[n] == before[n] + 1
    _close(fwd, cpu.forward(Pz))
    _close(bwd, cpu.adjoint(dL))


def test_kernels_reject_cpu_cuda_mix(cuda_device):
    Pz, W, Umap, dL, U = _fields(seed=0)
    F = bp._pack_fields(W, Umap).to(cuda_device)
    with pytest.raises(ValueError):
        bp.fwd_dense(Pz, F)
