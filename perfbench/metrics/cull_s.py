"""Layer: DMD-pixel culling (opt/optimize.py _cull, ops/ballistic.py
radon_active_ballistic, ops/render.py render_radon). The seconds
optimize() times as `cull_s` (its `timings`), the mean over the window's
optimizations; moves solve_s."""


def read(ctx):
    return ctx.mean_timing("cull_s")
