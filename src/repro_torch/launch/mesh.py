"""Production mesh construction over the default process group.

The port of ``repro.launch.mesh``: a jax ``Mesh`` becomes a
``torch.distributed.device_mesh.DeviceMesh`` with the same shape and axis
names, so that the port's dry-run records name the same cells as the
reference's. These are FUNCTIONS, not constants: importing this module
touches no process group. A mesh needs the default process group to hold
exactly its ranks (``init_device_mesh`` raises otherwise): ``torchrun``'s
ranks on a multi-card host, the dry run's ``fake`` group of 256 or 512
ranks in one process, one rank (``init_single_rank_group``), or the
allocation fabric's K ranks (``make_allocation_mesh``: a ``("shard",)``
mesh of one rank a replica, or None where there is no such group).

Mesh shapes:
  single pod:  (data=16, model=16)            = 256 chips
  multi-pod:   (pod=2, data=16, model=16)     = 512 chips

Axis roles:
  pod   -- pure data parallel across pods; the slowest hop gets the
           least frequent collective (one gradient reduction a step).
  data  -- FSDP: parameters and optimizer state sharded, gathered per layer.
  model -- tensor parallel: heads / d_ff / vocab / experts.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

__all__ = ["make_allocation_mesh", "make_production_mesh", "make_smoke_mesh",
           "mesh_chips", "mesh_name", "mesh_device_type",
           "init_single_rank_group"]


def mesh_device_type() -> str:
    """``"cuda"`` when the default group runs NCCL, else ``"cpu"`` (gloo,
    fake). Raises when no default group exists."""
    if not dist.is_initialized():
        raise RuntimeError(
            "no default process group: start the ranks with torchrun, or "
            "call init_single_rank_group() for one rank")
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def init_single_rank_group(device_type: str = "cuda") -> None:
    """A default process group of one rank (NCCL on the card, gloo on the
    CPU) over an in-memory store: a 1x1 mesh with no launcher. Raises if
    a default group already exists."""
    if dist.is_initialized():
        raise RuntimeError("a default process group already exists")
    if device_type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("a NCCL group needs a CUDA card")
    dist.init_process_group("nccl" if device_type == "cuda" else "gloo",
                            store=dist.HashStore(), rank=0, world_size=1)


def make_production_mesh(*, multi_pod: bool = False) -> DeviceMesh:
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return init_device_mesh(mesh_device_type(), shape, mesh_dim_names=axes)


def make_smoke_mesh(shape: Tuple[int, ...] = (1, 1),
                    axes: Tuple[str, ...] = ("data", "model")) -> DeviceMesh:
    """A small mesh over the default group's ranks."""
    return init_device_mesh(mesh_device_type(), shape, mesh_dim_names=axes)


def make_allocation_mesh(n_shards: int) -> Optional[DeviceMesh]:
    """Mesh for the sharded allocation fabric: the 1-D ``("shard",)`` mesh
    over the default group when that group holds exactly ``n_shards > 1``
    ranks, one rank a replica (``torchrun`` with K ranks on K cards, or K
    gloo ranks). Otherwise None: there is no default group, one shard, or
    a group of another size, and ``ShardedAllocationService`` decides
    every shard on this rank's device.

    The reference builds its mesh whenever the host has at least
    ``n_shards`` devices, since one jax process holds them all. The port
    runs one rank a device, and a fabric's collectives must take in every
    rank of the group that runs it, so it asks for a group of exactly
    ``n_shards`` ranks; a larger group (an LM job's, say) gets None."""
    if n_shards <= 1 or not dist.is_initialized() \
            or dist.get_world_size() != n_shards:
        return None
    return init_device_mesh(mesh_device_type(), (n_shards,),
                            mesh_dim_names=("shard",))


def mesh_chips(mesh: DeviceMesh) -> int:
    return int(mesh.mesh.numel())


def mesh_name(mesh: DeviceMesh) -> str:
    """"16x16", "2x16x16": the mesh's shape as the records name it."""
    return "x".join(str(v) for v in mesh.mesh.shape)
