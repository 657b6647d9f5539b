"""The port's hand-written Hopper kernels and their public wrappers.

  K1  ops.arepas_runtimes — bulk AREPAS runtimes (csrc/skyline.cu);
      replaces repro/kernels/skyline.py::skyline_runtimes.
  K2  ops.cluster_epoch_step — fused expire/release/admit/scatter epoch
      step over the lease tables (csrc/cluster_step.cu); replaces
      repro/kernels/cluster_step.py::epoch_step_pallas.
  K3  ops.cluster_resize_step — fused priced shrink decision + AREPAS +
      repriced lease end (csrc/cluster_step.cu); replaces
      repro/kernels/cluster_step.py::resize_step_pallas.

The TPU kernels not ported yet are listed in ROADMAP.md.
"""
from repro_torch.kernels.ops import (arepas_runtimes, cluster_epoch_step,
                                     cluster_resize_step, launch_counts,
                                     reset_launch_counts)

__all__ = ["arepas_runtimes", "cluster_epoch_step", "cluster_resize_step",
           "launch_counts", "reset_launch_counts"]
