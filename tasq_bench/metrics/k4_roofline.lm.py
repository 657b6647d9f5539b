"""Kernels: K4, flash attention (csrc/flash_attention.cu), in the LM
cell's prefills: the least time of its launches in the profiled window
(``bounds.lm``: unmasked causal pairs and bytes) over the device time of
its kernels there, in %."""
from tasq_bench.tracing import kernel_seconds


def read(ctx):
    bound = ctx.traced.get("bound_s", {}).get("K4")
    spent = kernel_seconds(ctx.traced.get("kernel_s", {}), "flash_attention")
    if not bound or not spent:
        return None
    return 100.0 * bound / spent
