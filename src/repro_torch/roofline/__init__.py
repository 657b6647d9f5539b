"""Roofline rows for the port's streaming kernels on the H100."""
from repro_torch.roofline.analysis import (H100, HW, Hardware,
                                           KernelRoofline, kernel_roofline)

__all__ = ["H100", "HW", "Hardware", "KernelRoofline", "kernel_roofline"]
