"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense,
at its 700 W limit) and the backprojection pair's least time (the
arithmetic of the port's chip_smoke.py `bound` / `compulsory_bytes`,
copied): 2 flops per (tap, z row) at the float32 peak outside the tensor
cores, or each input read once and each output written once at the HBM
rate, whichever is longer."""
from __future__ import annotations

F32_FLOPS = 67e12
HBM_BYTES_PER_S = 3.35e12


def bp_bytes(A, Zf, U, Y, X):
    """Compulsory bytes of one float32 backprojection (either way): the
    resampled patterns (A, Zf, U), the packed fields (A, 2, Y*X) and the
    dose (Zf, Y*X)."""
    return 4 * A * Zf * U + 4 * A * 2 * Y * X + 4 * Zf * Y * X


def bp_bound_s(n_taps, Zf, n_bytes):
    """(least seconds, 'operations' or 'bytes') of one launch."""
    flop_s = 2.0 * n_taps * Zf / F32_FLOPS
    byte_s = n_bytes / HBM_BYTES_PER_S
    return max(flop_s, byte_s), ("operations" if flop_s >= byte_s
                                 else "bytes")
