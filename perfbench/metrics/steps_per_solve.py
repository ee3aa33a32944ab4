"""Layer: optimizer + loss (opt/device_lbfgs.py, opt/loss.py). The
optimizer steps an optimization ran (the non-zero rows of its
timing.npy, the converging step counted), the mean over the window's
optimizations; moves solve_s."""


def read(ctx):
    if not ctx.solves:
        return None
    return sum(s.steps for s in ctx.solves) / len(ctx.solves)
