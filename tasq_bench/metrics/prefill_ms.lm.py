"""LM serving: device time of a batch's prefill, the ``device_ms`` that
each ``lm.prefill`` span carries (CUDA events around the prefill call),
summed over the window's batches and divided by their number, in
milliseconds a batch."""


def read(ctx):
    device = [s.attrs["device_ms"] for s in ctx.traced.get("spans", ())
              if s.name == "lm.prefill" and "device_ms" in s.attrs]
    if not device:
        return None
    return sum(device) / len(device)
