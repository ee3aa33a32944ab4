"""Layer: transport precompute (ops/transport2d.py build_transport's
`fan` span: the host ray fan, csrc/host/transport2d.cpp rasterize_fan).
The seconds optimize() records as `fan_s` (its `timings`: every fan of
an optimization summed, the cull's, the loop engine's and the final
render's), the mean over the window's optimizations; moves solve_s."""


def read(ctx):
    return ctx.mean_timing("fan_s")
