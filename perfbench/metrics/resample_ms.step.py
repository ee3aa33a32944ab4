"""Layer: optimizer + loss (ops/ballistic.py's `resample` span: the
K-tap z-resample, _resample_fwd and _resample_bwd). The device time of
the operations launched inside a `resample` span in the program's trace
of its loop (harness/spans.py), in milliseconds per optimizer step;
moves step_ms."""
from perfbench.harness.spans import ms_per_step


def read(ctx):
    return ms_per_step(ctx.loop, "resample")
