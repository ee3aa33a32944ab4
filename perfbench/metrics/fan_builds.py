"""Layer: transport precompute (ops/transport2d.py build_transport's
`fan_builds` counter: one for each host ray fan rasterized). The fans
optimize() counts in its `timings` for one optimization, the mean over
the window's optimizations; moves solve_s."""


def read(ctx):
    return ctx.mean_timing("fan_builds")
