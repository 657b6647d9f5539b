"""LM serving: the MoE FFNs' share of the device time, the ``device_ms``
of the ``lm.moe`` spans (one a layer call) over that of the ``lm.prefill``
and ``lm.decode`` spans that hold them, in %."""


def read(ctx):
    spans = ctx.traced.get("spans", ())
    ms = lambda names: sum(s.attrs["device_ms"] for s in spans
                           if s.name in names and "device_ms" in s.attrs)
    whole = ms(("lm.prefill", "lm.decode"))
    moe = ms(("lm.moe",))
    if not whole or not moe:
        return None
    return 100.0 * moe / whole
