"""Layer: optimizer + loss (opt/loss.py under opt/optimize.py's `loss`
span: the primal loss, its autograd in the adjoint and every Armijo
candidate). The device time of the operations launched inside a `loss`
span in the program's trace of its loop (harness/spans.py), in
milliseconds per optimizer step; moves step_ms."""
from perfbench.harness.spans import ms_per_step


def read(ctx):
    return ms_per_step(ctx.loop, "loss")
