"""The ballistic engine's z-resample on the card: one hand-written
gather per direction (csrc/zres.cu).

    out[a, j, u] = sum_k w[j, k] * x[a, idx[j, k], u]

The forward takes the engine's (Zf, K) tap tables, the adjoint the
(R, K) tables of the transposed binning matrix (ops/ballistic.py
`z_tap_tables`), so both directions are gathers and neither needs
atomics. The kernel evaluates every tap in table order and rounds each
product and each sum on its own, so its output is bitwise the plain
version's, `BallisticEngine._tap_contract`, which the CPU route runs.
`gather` takes CUDA tensors only; `resample` is differentiable, its
backward the other direction's gather.

`launches` counts kernel launches; each launch also adds to the
recorder's `resample_launches` (utils/spans.py `count`)."""
from __future__ import annotations

import ctypes

import torch

from .backproject import _check
from ..utils.spans import count

KERNELS = ("zres",)
TAPS = 4  # K of the tap tables: csrc/zres.cu kTaps
launches = {k: 0 for k in KERNELS}


def _setup(lib):
    lib.zres_gather.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + \
        [ctypes.c_void_p]
    lib.zres_gather.restype = ctypes.c_int


def build_kernels():
    """Build (nvcc, at first use) and load the kernel: {name: lib}."""
    from ..native import load_cuda
    return load_cuda(KERNELS, {"zres": _setup})


def gather(x, idx, w):
    """(A, n_in, U) float32 x, (n_out, TAPS) int64 idx with entries in
    [0, n_in), (n_out, TAPS) float32 w, all on one CUDA device ->
    (A, n_out, U) float32."""
    A, n_in, U = x.shape
    n_out, K = idx.shape
    if K != TAPS:
        raise ValueError(f"zres: tables of {K} taps a row, the kernel "
                         f"takes {TAPS}")
    dev = _check("zres", (x, idx, w),
                 (torch.float32, torch.int64, torch.float32),
                 ((A, n_in, U), (n_out, K), (n_out, K)))
    if dev.type != "cuda":
        raise ValueError("zres: takes CUDA tensors; the plain version is "
                         "BallisticEngine._tap_contract")
    out = torch.empty((A, n_out, U), dtype=torch.float32, device=dev)
    if out.numel() == 0:
        return out
    with torch.cuda.device(dev):
        fn = build_kernels()["zres"].zres_gather
        err = fn(x.data_ptr(), idx.data_ptr(), w.data_ptr(), out.data_ptr(),
                 A, n_in, n_out, U, K,
                 torch.cuda.current_stream(dev).cuda_stream)
    launches["zres"] += 1
    count("resample_launches")
    if err != 0:
        raise RuntimeError(f"zres: CUDA launch failed, cudaError_t {err}")
    return out


class ZResample(torch.autograd.Function):
    """out = gather(x, *taps); the backward gathers with adjoint_taps,
    the transposed tables."""

    @staticmethod
    def forward(ctx, x, taps, adjoint_taps):
        ctx.adjoint_taps = adjoint_taps
        return gather(x, *taps)

    @staticmethod
    def backward(ctx, out_bar):
        return gather(out_bar.contiguous(), *ctx.adjoint_taps), None, None


def resample(x, taps, adjoint_taps):
    """Differentiable z-resample of CUDA tensors: x (A, n_in, U), taps
    the (idx, w) pair of this direction, adjoint_taps the other's."""
    return ZResample.apply(x.contiguous(), taps, adjoint_taps)
