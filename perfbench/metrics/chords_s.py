"""Layer: transport precompute (ops/hybrid.py ScatteringEngine's
`chords` span: ops/transport2d.py build_chords and chord_pack on the
host, for the loop's engine and the final render's). The seconds
optimize() records as `chords_s` (its `timings`), the mean over the
window's optimizations; moves solve_s."""


def read(ctx):
    return ctx.mean_timing("chords_s")
