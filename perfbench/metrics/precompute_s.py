"""Layer: transport precompute (ops/transport2d.py -> csrc/host/transport2d.cpp, ops/ballistic.py, ops/backproject.py DenseLayout; the hybrid chord bank). The seconds optimize() times as `precompute_s`
(its `timings`), the mean over the window's optimizations; moves
solve_s."""


def read(ctx):
    return ctx.mean_timing("precompute_s")
