"""Cluster control: host time featurizing the trace's template pool, the
``cluster.featurize`` spans (one in each pass's set-up) summed over the
window's epochs (the ``epochs`` counter), in milliseconds an epoch."""


def read(ctx):
    epochs = (ctx.traced.get("counters") or {}).get("epochs")
    spans = [s.t1 - s.t0 for s in ctx.traced.get("spans", ())
             if s.name == "cluster.featurize"]
    if not spans or not epochs:
        return None
    return 1e3 * sum(spans) / epochs
