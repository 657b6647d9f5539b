"""Cluster control: device time of the fabric's model-path decides (the
model's fused graphs: forward, decode and the policy), the ``device_ms``
of the ``fabric.decide`` spans whose ``path`` is ``model``, summed over
the window's epochs (the ``epochs`` counter), in milliseconds an epoch."""


def read(ctx):
    epochs = (ctx.traced.get("counters") or {}).get("epochs")
    device = [s.attrs["device_ms"] for s in ctx.traced.get("spans", ())
              if s.name == "fabric.decide" and s.attrs.get("path") == "model"
              and "device_ms" in s.attrs]
    if not device or not epochs:
        return None
    return sum(device) / epochs
