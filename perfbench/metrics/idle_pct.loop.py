"""Layer: device. The share of the program's loop trace (its `profile`
key: the loop, from the built optimizer to the last step) in which no
operation ran on the card, in percent; moves step_ms."""


def read(ctx):
    if ctx.loop is None:
        return None
    s = ctx.loop["summary"]
    return 100.0 * (1.0 - s["busy_us"] / s["window_us"])
