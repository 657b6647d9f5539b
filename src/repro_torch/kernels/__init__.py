"""The port's hand-written Hopper kernels and their public wrappers.

  K1  ops.arepas_runtimes — bulk AREPAS runtimes (csrc/skyline.cu);
      replaces repro/kernels/skyline.py::skyline_runtimes.

The TPU kernels not ported yet are listed in ROADMAP.md.
"""
from repro_torch.kernels.ops import (arepas_runtimes, launch_counts,
                                     reset_launch_counts)

__all__ = ["arepas_runtimes", "launch_counts", "reset_launch_counts"]
