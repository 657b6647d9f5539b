"""Kernels: K3, the fused elastic resize (csrc/cluster_step.cu): the least time of its launches in the profiled
window (``bounds.kernels``) over the device time of its kernel
there (``resize_step_kernel``), in %."""
from tasq_bench.tracing import kernel_seconds


def read(ctx):
    bound = ctx.traced.get("bound_s", {}).get("K3")
    spent = kernel_seconds(ctx.traced.get("kernel_s", {}), "resize_step_kernel")
    if not bound or not spent:
        return None
    return 100.0 * bound / spent
