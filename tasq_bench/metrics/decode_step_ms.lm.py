"""LM serving: device time of a decode step, the ``device_ms`` of the
``lm.decode`` spans (one a step, CUDA events around the step) summed
over the window's steps and divided by their number, in milliseconds a
step."""


def read(ctx):
    device = [s.attrs["device_ms"] for s in ctx.traced.get("spans", ())
              if s.name == "lm.decode" and "device_ms" in s.attrs]
    if not device:
        return None
    return sum(device) / len(device)
