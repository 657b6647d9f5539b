"""Cluster control: the window's seconds over its epochs (the ``epochs``
counter summed over the passes), in milliseconds an epoch."""


def read(ctx):
    epochs = (ctx.traced.get("counters") or {}).get("epochs")
    w = ctx.traced.get("run_window_s")
    if not epochs or not w:
        return None
    return 1e3 * w / epochs
