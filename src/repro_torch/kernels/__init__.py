"""The port's hand-written Hopper kernels and their public wrappers.

  K1  ops.arepas_runtimes (padded pool + row index) and
      ops.arepas_runtimes_ragged (flat values + offsets) — bulk AREPAS
      runtimes (csrc/skyline.cu); replaces
      repro/kernels/skyline.py::skyline_runtimes.
  K2  ops.cluster_epoch_step — fused expire/release/admit/scatter epoch
      step over the lease tables (csrc/cluster_step.cu); replaces
      repro/kernels/cluster_step.py::epoch_step_pallas.
  K3  ops.cluster_resize_step — fused priced shrink decision + AREPAS +
      repriced lease end (csrc/cluster_step.cu); replaces
      repro/kernels/cluster_step.py::resize_step_pallas.
  K4  ops.flash_attention — causal GQA online-softmax attention forward
      (csrc/flash_attention.cu); replaces
      repro/kernels/flash_attention.py::flash_attention_bhsd.
  K5  ops.ssd_scan — the Mamba-2 SSD chunk scan forward (csrc/ssd.cu);
      replaces repro/kernels/ssd.py::ssd_chunk_scan.

K4 and K5 train through ``torch.autograd.Function``s whose backward
recomputes the plain formulation, as the reference's ``custom_vjp``s do.
"""
from repro_torch.kernels.ops import (arepas_runtimes, arepas_runtimes_ragged,
                                     cluster_epoch_step, cluster_resize_step,
                                     flash_attention, launch_counts,
                                     reset_launch_counts, ssd_scan)

__all__ = ["arepas_runtimes", "arepas_runtimes_ragged", "cluster_epoch_step",
           "cluster_resize_step", "flash_attention", "ssd_scan",
           "launch_counts", "reset_launch_counts"]
