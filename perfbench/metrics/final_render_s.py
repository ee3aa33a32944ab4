"""Layer: final render (opt/optimize.py _final_render). The seconds optimize() times as `final_render_s`
(its `timings`), the mean over the window's optimizations; moves
solve_s."""


def read(ctx):
    return ctx.mean_timing("final_render_s")
