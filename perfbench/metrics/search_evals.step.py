"""Layer: optimizer + loss (opt/device_lbfgs.py armijo_search's
`search_evals` counter: one for each candidate loss of the line search,
each a host readback). The window's summed `search_evals` over its
summed optimizer steps; moves step_ms."""


def read(ctx):
    with_key = [s for s in ctx.solves if "search_evals" in s.timings]
    steps = sum(s.steps for s in with_key)
    if not steps:
        return None
    return sum(s.timings["search_evals"] for s in with_key) / steps
