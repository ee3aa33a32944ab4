"""Layer: scene + voxelize (opt/optimize.py's `voxelize` span:
sensor.discretize and, on a surface-aware film, sensor.compute_volume,
ops/voxelize.py -> csrc/host/mesh_accel.cpp). The seconds optimize()
records as `voxelize_s` (its `timings`), the mean over the window's
optimizations; moves solve_s."""


def read(ctx):
    return ctx.mean_timing("voxelize_s")
