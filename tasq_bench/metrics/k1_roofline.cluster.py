"""Kernels: K1, AREPAS runtimes (csrc/skyline.cu): the least time of its launches in the profiled
window (``bounds.kernels``) over the device time of its kernel
there (``arepas_runtimes_kernel``), in %."""
from tasq_bench.tracing import kernel_seconds


def read(ctx):
    bound = ctx.traced.get("bound_s", {}).get("K1")
    spent = kernel_seconds(ctx.traced.get("kernel_s", {}), "arepas_runtimes_kernel")
    if not bound or not spent:
        return None
    return 100.0 * bound / spent
