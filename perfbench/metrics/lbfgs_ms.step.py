"""Layer: optimizer + loss (opt/device_lbfgs.py's `lbfgs` span: the
history's update and two-loop direction, history_step, and the clamped
update). The device time of the operations launched inside an `lbfgs`
span in the program's trace of its loop (harness/spans.py), in
milliseconds per optimizer step; moves step_ms."""
from perfbench.harness.spans import ms_per_step


def read(ctx):
    return ms_per_step(ctx.loop, "lbfgs")
