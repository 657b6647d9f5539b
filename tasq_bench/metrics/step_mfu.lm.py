"""Whole serving step: model FLOPs of the window's real tokens (prompts
without their padding, and the kept generated tokens; ``bounds.lm``) over
the window's seconds times the H100's dense bf16 peak, in %."""
from tasq_bench.bounds import lm as bounds


def read(ctx):
    flops = ctx.traced.get("model_flops")
    w = ctx.traced.get("run_window_s")
    if not flops or not w:
        return None
    return 100.0 * flops / (w * bounds.BF16_FLOPS_PER_S)
