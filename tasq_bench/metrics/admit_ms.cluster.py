"""Cluster control: self time of the admission spans (``cluster_epoch_step``
where admission runs as kernel K2, ``scheduler.admit`` where it runs on
the host), their duration less the spans they hold, over the window's
epochs, in milliseconds an epoch."""
import bisect

ADMISSION = ("cluster_epoch_step", "scheduler.admit")


def read(ctx):
    spans = sorted(ctx.traced.get("spans", ()), key=lambda s: s.t0)
    epochs = (ctx.traced.get("counters") or {}).get("epochs")
    admits = [s for s in spans if s.name in ADMISSION]
    if not admits or not epochs:
        return None
    starts = [s.t0 for s in spans]
    total = 0.0
    for a in admits:
        child = 0.0
        i = bisect.bisect_left(starts, a.t0)
        while i < len(spans) and spans[i].t0 <= a.t1:
            s = spans[i]
            if s.depth == a.depth + 1 and s.t1 <= a.t1 and s is not a:
                child += s.t1 - s.t0
            i += 1
        total += (a.t1 - a.t0) - child
    return 1e3 * total / epochs
