"""Roofline rows for the port's kernels on the H100, the three-term
roofline of the dry run's cells, and the analytic model FLOPs of an LM
step."""
from repro_torch.roofline.analysis import (H100, HW, Hardware,
                                           KernelRoofline, LocalProgramCounter,
                                           RooflineReport, collective_bytes,
                                           host_copy_bandwidth,
                                           kernel_roofline,
                                           parse_hlo_collectives,
                                           roofline_terms)
from repro_torch.roofline.model_flops import model_flops

__all__ = ["H100", "HW", "Hardware", "KernelRoofline", "LocalProgramCounter",
           "RooflineReport", "collective_bytes", "host_copy_bandwidth",
           "kernel_roofline", "parse_hlo_collectives", "roofline_terms",
           "model_flops"]
