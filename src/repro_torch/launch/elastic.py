"""Elastic scaling controller: survive host loss, continue on a smaller mesh.

The port of ``repro.launch.elastic``. Policy: on a failure, drop to the
largest power-of-two data-parallel degree the healthy hosts can form. The
model-parallel degree is fixed by the architecture's sharding (changing
it mid-job would reshape every weight shard); data parallel is the cheap
axis to shrink. Restore re-shards the latest checkpoint onto the new mesh
(``CheckpointManager.restore(shardings=...)`` reads full host views), and
the deterministic skip-ahead pipeline re-partitions the data stream: no
coordination with dead hosts is needed.

The controller is hardware-agnostic: ``healthy_hosts`` comes from
whatever health signal the deployment has. Tests drive it with simulated
failures. ``MeshPlan.build()`` makes the plan's ``DeviceMesh`` over the
default process group, which must hold exactly the plan's chips.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch.distributed as dist

from repro_torch.launch.mesh import mesh_device_type

__all__ = ["ElasticController", "MeshPlan"]


@dataclasses.dataclass(frozen=True)
class MeshPlan:
    data: int
    model: int
    pods: int = 1

    @property
    def chips(self) -> int:
        return self.data * self.model * self.pods

    def axes(self) -> Tuple[str, ...]:
        return ("pod", "data", "model") if self.pods > 1 else ("data", "model")

    def shape(self) -> Tuple[int, ...]:
        return ((self.pods, self.data, self.model) if self.pods > 1
                else (self.data, self.model))

    def build(self):
        """The plan's mesh; raises unless the default process group has
        exactly ``chips`` ranks."""
        from torch.distributed.device_mesh import init_device_mesh
        dt = mesh_device_type()
        if dist.get_world_size() != self.chips:
            raise RuntimeError(
                f"mesh plan {self.shape()} needs {self.chips} ranks; the "
                f"process group has {dist.get_world_size()}")
        return init_device_mesh(dt, self.shape(), mesh_dim_names=self.axes())


def _largest_pow2_leq(n: int) -> int:
    p = 1
    while p * 2 <= n:
        p *= 2
    return p


class ElasticController:
    """Tracks healthy capacity; proposes mesh plans; decides restarts."""

    def __init__(self, plan: MeshPlan, *, chips_per_host: int = 8,
                 min_data: int = 1):
        self.initial = plan
        self.current = plan
        self.chips_per_host = chips_per_host
        self.min_data = min_data
        self.total_hosts = plan.chips // chips_per_host
        self.healthy: set = set(range(self.total_hosts))

    # ------------------------------------------------------------- events --
    def host_failed(self, host_id: int) -> Optional[MeshPlan]:
        """Returns a new MeshPlan if a resize is needed, else None."""
        self.healthy.discard(host_id)
        return self._replan()

    def host_recovered(self, host_id: int) -> Optional[MeshPlan]:
        if host_id < self.total_hosts:
            self.healthy.add(host_id)
        return self._replan()

    def _replan(self) -> Optional[MeshPlan]:
        chips = len(self.healthy) * self.chips_per_host
        model = self.initial.model           # fixed: cheap axis is data
        pods = 1 if chips < self.initial.chips else self.initial.pods
        per_pod = chips // pods
        data_raw = per_pod // model
        if data_raw < self.min_data:
            raise RuntimeError(
                f"insufficient healthy capacity: {chips} chips < "
                f"{self.min_data * model} minimum")
        data = min(_largest_pow2_leq(data_raw), self.initial.data)
        new = MeshPlan(data=data, model=model, pods=pods)
        if new == self.current:
            return None
        self.current = new
        return new

    # ------------------------------------------------------------ summary --
    def status(self) -> Dict:
        return {
            "healthy_hosts": len(self.healthy),
            "total_hosts": self.total_hosts,
            "current_mesh": self.current.shape(),
            "degraded": self.current != self.initial,
        }
