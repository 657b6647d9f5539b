"""Roofline rows for the port's kernels on the H100, and the analytic
model FLOPs of an LM step."""
from repro_torch.roofline.analysis import (H100, HW, Hardware,
                                           KernelRoofline, kernel_roofline)
from repro_torch.roofline.model_flops import model_flops

__all__ = ["H100", "HW", "Hardware", "KernelRoofline", "kernel_roofline",
           "model_flops"]
