"""Layer: scene + voxelize (models/scene.py, ops/voxelize.py -> csrc/host/mesh_accel.cpp). The seconds optimize() times as `scene_s`
(its `timings`), the mean over the window's optimizations; moves
solve_s."""


def read(ctx):
    return ctx.mean_timing("scene_s")
