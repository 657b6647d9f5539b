"""LM serving: host time of a decode step, the duration of the
``lm.decode`` spans on the host's clock (the step's enqueue: nothing in
it waits for the card), over the window's steps, in milliseconds a step.
Near ``decode_step_ms.lm`` or above it, the step is bound by its
launches."""


def read(ctx):
    host = [s.t1 - s.t0 for s in ctx.traced.get("spans", ())
            if s.name == "lm.decode"]
    if not host:
        return None
    return 1000.0 * sum(host) / len(host)
