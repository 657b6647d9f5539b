"""Kernels: K5, the Mamba-2 SSD chunk scan (csrc/ssd.cu), in the LM cell's
prefills: the least time of its launches in the profiled window
(``bounds.lm``: the chunked scan's operations and bytes) over the device
time of its kernels there (``ssd_tc``, or ``ssd_kernel`` on the CUDA
cores), in %."""
from tasq_bench.tracing import kernel_seconds


def read(ctx):
    bound = ctx.traced.get("bound_s", {}).get("K5")
    kernels = ctx.traced.get("kernel_s", {})
    spent = (kernel_seconds(kernels, "ssd_tc")
             + kernel_seconds(kernels, "ssd_kernel"))
    if not bound or not spent:
        return None
    return 100.0 * bound / spent
