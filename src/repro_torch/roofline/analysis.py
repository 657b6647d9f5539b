"""Roofline of the port's streaming kernels on one NVIDIA H100.

The fused cluster-epoch kernel (K2, ``kernels/cluster_step.py``) does
essentially no arithmetic per byte: a replay epoch reads the (K, L) lease
tables and the (K, Q) queue head and writes them back. Its roofline is
therefore one term: the time the memory system needs to move the analytic
traffic, against the measured time. ``bytes_per_launch`` is analytic
(summed from the operand and result shapes), not measured.

``Hardware`` holds one card's published memory rate. ``H100`` is the
H100 SXM from NVIDIA's data sheet (80 GB of HBM3 at 3.35 TB/s), at its
full 700 W power limit. The reference's TPU v5e record and its HLO collective parser belong
to the LM stack and are not carried over.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

__all__ = ["H100", "HW", "Hardware", "KernelRoofline", "kernel_roofline"]


@dataclasses.dataclass(frozen=True)
class Hardware:
    name: str
    hbm_bw: float                 # bytes/s of device memory


H100 = Hardware(name="NVIDIA H100 SXM (data sheet)", hbm_bw=3.35e12)
HW = H100


@dataclasses.dataclass
class KernelRoofline:
    kernel: str                       # e.g. "cluster_epoch_step"
    launches: int
    bytes_per_launch: float           # analytic operand+result traffic
    wall_s: float                     # total wall across all launches
    items: int = 0                    # events (or candidates) processed
    hw: Hardware = HW

    @property
    def total_bytes(self) -> float:
        return self.launches * self.bytes_per_launch

    @property
    def achieved_bw(self) -> float:
        """Bytes actually streamed per wall second."""
        return self.total_bytes / self.wall_s if self.wall_s > 0 else 0.0

    @property
    def bound_s(self) -> float:
        """Least time on the card: the traffic at the memory rate."""
        return self.total_bytes / self.hw.hbm_bw

    @property
    def bound_fraction(self) -> float:
        """Share of the memory roofline achieved."""
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
                    wall_s: float, items: int = 0,
                    hw: Hardware = HW) -> KernelRoofline:
    return KernelRoofline(kernel=kernel, launches=launches,
                          bytes_per_launch=bytes_per_launch, wall_s=wall_s,
                          items=items, hw=hw)
