"""Layer: backprojection kernels (ops/backproject.py, csrc/bp_*.cu).
The least time of the loop's backprojections over their measured device
time, in percent: per forward or adjoint launch, 2 flops per (tap, z
row) at the float32 peak, or each input read once and each output
written once at the HBM rate (harness/peaks.py), whichever is longer.
The taps are counted from the geometry by the reference (two per film
cell that an angle's light reaches), not from the port's layout.
Measured time: the trace's bp_* kernels. Moves step_ms."""
import re

from perfbench.harness.peaks import bp_bound_s, bp_bytes

LAUNCH = re.compile(r"(?<![A-Za-z0-9_])(fwd_kernel|bwd_kernel)"
                    r"(?![A-Za-z0-9_])")
LAYER = re.compile(r"(?<![A-Za-z0-9_])(fwd_kernel|bwd_kernel|"
                   r"transpose_kernel)(?![A-Za-z0-9_])")


def read(ctx):
    if ctx.loop is None:
        return None
    w = ctx.work
    n, us = 0, 0.0
    for name, (count, t) in ctx.loop["summary"]["by_name"].items():
        if LAUNCH.search(name):
            n += count
        if LAYER.search(name):
            us += t
    if n == 0 or us <= 0.0:
        return None
    least, _ = bp_bound_s(w["taps"], w["Zf"],
                          bp_bytes(w["A"], w["Zf"], w["U"], w["Y"], w["X"]))
    return 100.0 * n * least / (us * 1e-6)
