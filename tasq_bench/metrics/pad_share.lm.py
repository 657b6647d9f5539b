"""LM serving: the share of the prefills' token slots that are
left-padding, ``lm_pad_tokens`` over ``lm_pad_tokens`` +
``lm_prompt_tokens``, in %."""


def read(ctx):
    c = ctx.traced.get("counters") or {}
    pads, real = c.get("lm_pad_tokens"), c.get("lm_prompt_tokens")
    if pads is None or not real:
        return None
    return 100.0 * pads / (pads + real)
