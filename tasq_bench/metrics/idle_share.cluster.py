"""Device: share of the profiled window in which no kernel, copy or set
ran on the card, in %."""


def read(ctx):
    w = ctx.traced.get("window_s")
    if not w:
        return None
    return 100.0 * (1.0 - ctx.traced["busy_s"] / w)
