"""Layer: scene + voxelize (opt/optimize.py's `target_io` span: the
target's EXR and NPY writes inside the scene phase). The seconds
optimize() records as `target_io_s` (its `timings`), the mean over the
window's optimizations; moves solve_s."""


def read(ctx):
    return ctx.mean_timing("target_io_s")
