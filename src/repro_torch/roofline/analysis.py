"""Roofline of the port's kernels on one NVIDIA H100.

A kernel's least time on the card is the larger of two terms: the bytes it
must move (each operand read once, each result written once) at the memory
rate, and the operations it must do at the card's peak rate for their type.
The fused cluster-epoch kernel (K2, ``kernels/cluster_step.py``) does
essentially no arithmetic per byte, so its row has no operations term
(``flops_per_launch`` 0) and its bound is the bytes term alone. Flash
attention (K4) is the other extreme: its bound is its operations at the
bf16 tensor-core rate. ``bytes_per_launch`` and ``flops_per_launch`` are
analytic (from the operand and result shapes), not measured.

``Hardware`` holds one card's published rates. ``H100`` is the H100 SXM
from NVIDIA's data sheet (80 GB of HBM3 at 3.35 TB/s; 989 TFLOP/s dense
bf16 on the tensor cores; 67 TFLOP/s float32 outside them), at its full
700 W power limit. The reference's TPU record and its HLO collective
parser belong to the multi-card LM stack and are not carried over.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

__all__ = ["H100", "HW", "Hardware", "KernelRoofline", "kernel_roofline"]


@dataclasses.dataclass(frozen=True)
class Hardware:
    name: str
    hbm_bw: float                 # bytes/s of device memory
    bf16_tensor_flops: float = 0.0  # dense bf16 tensor-core FLOP/s
    fp32_flops: float = 0.0       # float32 FLOP/s outside the tensor cores


H100 = Hardware(name="NVIDIA H100 SXM (data sheet)", hbm_bw=3.35e12,
                bf16_tensor_flops=989e12, fp32_flops=67e12)
HW = H100


@dataclasses.dataclass
class KernelRoofline:
    kernel: str                       # e.g. "cluster_epoch_step"
    launches: int
    bytes_per_launch: float           # analytic operand+result traffic
    wall_s: float                     # total wall across all launches
    items: int = 0                    # events (or candidates) processed
    hw: Hardware = HW
    flops_per_launch: float = 0.0     # analytic operations, at the bf16
                                      # tensor-core rate

    @property
    def total_bytes(self) -> float:
        return self.launches * self.bytes_per_launch

    @property
    def achieved_bw(self) -> float:
        """Bytes actually streamed per wall second."""
        return self.total_bytes / self.wall_s if self.wall_s > 0 else 0.0

    @property
    def bound_s(self) -> float:
        """Least time on the card: the larger of the traffic at the memory
        rate and the operations at the bf16 tensor-core rate."""
        bytes_s = self.total_bytes / self.hw.hbm_bw
        if not self.flops_per_launch:
            return bytes_s
        return max(bytes_s, self.launches * self.flops_per_launch
                   / self.hw.bf16_tensor_flops)

    @property
    def bound_fraction(self) -> float:
        """Share of the roofline achieved (bound over wall time)."""
        return self.bound_s / self.wall_s if self.wall_s > 0 else 0.0

    def row(self) -> Dict:
        return {
            "kernel": self.kernel,
            "hardware": self.hw.name,
            "launches": self.launches,
            "bytes_per_launch": int(self.bytes_per_launch),
            "total_gb": round(self.total_bytes / 1e9, 4),
            "wall_s": round(self.wall_s, 6),
            "items": self.items,
            "items_per_s": (round(self.items / self.wall_s, 1)
                            if self.wall_s > 0 else None),
            "achieved_gb_s": round(self.achieved_bw / 1e9, 4),
            "hbm_bound_frac": round(self.bound_fraction, 6),
            "bound_s": round(self.bound_s, 9),
        }


def kernel_roofline(kernel: str, *, launches: int, bytes_per_launch: float,
                    wall_s: float, items: int = 0, hw: Hardware = HW,
                    flops_per_launch: float = 0.0) -> KernelRoofline:
    return KernelRoofline(kernel=kernel, launches=launches,
                          bytes_per_launch=bytes_per_launch, wall_s=wall_s,
                          items=items, hw=hw,
                          flops_per_launch=flops_per_launch)
