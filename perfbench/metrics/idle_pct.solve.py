"""Layer: device. The share of a whole optimization (the harness's own
torch.profiler trace of optimize(), cut where its artifacts begin) in
which no operation ran on the card, in percent; moves solve_s."""


def read(ctx):
    if ctx.solve_trace is None:
        return None
    s = ctx.solve_trace["summary"]
    return 100.0 * (1.0 - s["busy_us"] / s["window_us"])
