"""Whole epoch step: the least device time of every K1, K2, K3 and
decide launch of the window (``bounds.kernels``) as a share of the
window, in %."""


def read(ctx):
    t = ctx.traced.get("bound_s", {}).get("all")
    w = ctx.traced.get("run_window_s")
    if not t or not w:
        return None
    return 100.0 * t / w
