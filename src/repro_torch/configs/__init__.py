"""Architecture config registry: ``--arch <id>`` resolution.

Copied from the reference's ``repro.configs`` with its ten architecture
modules; ``get_config``, ``SHAPES`` and ``OPT_PACKS`` are unchanged.
``get_config`` also resolves the architectures only the port serves
(``PORT_ARCH_MODULES``: granite-4.0-h-small), which ``ARCH_IDS``, the
reference's list that the dry run and the sharding tables walk, leaves
out.
"""
from __future__ import annotations

import importlib

from repro_torch.configs.base import (
    DEFAULT_RULES,
    LOGICAL_AXES,
    SHAPES,
    ModelConfig,
    ShapeConfig,
    cell_is_runnable,
)

# arch id -> module name
ARCH_MODULES = {
    "qwen2-72b": "qwen2_72b",
    "command-r-35b": "command_r_35b",
    "granite-34b": "granite_34b",
    "minitron-8b": "minitron_8b",
    "zamba2-2.7b": "zamba2_2p7b",
    "moonshot-v1-16b-a3b": "moonshot_v1_16b_a3b",
    "qwen3-moe-235b-a22b": "qwen3_moe_235b_a22b",
    "whisper-small": "whisper_small",
    "qwen2-vl-7b": "qwen2_vl_7b",
    "mamba2-1.3b": "mamba2_1p3b",
}

ARCH_IDS = tuple(ARCH_MODULES)

# architectures the port serves that the reference has no module for
PORT_ARCH_MODULES = {
    "granite-4.0-h-small": "granite_4_0_h_small",
}

# Beyond-paper-baseline optimization packs of the reference, applied by
# ``get_config(..., optimized=True)``. The baseline configs stay
# paper-faithful.
OPT_PACKS = {
    # MoE: batch-local dispatch wants a non-seq-sharded residual;
    # dots-remat avoids recompute all-gathers; capacity 1.0 trims dispatch
    # buffers and expert FLOPs; grad_accum=4 restores the per-device
    # activation fit that dropping seq_sp costs.
    "qwen3-moe-235b-a22b": dict(sharding_overrides={"seq_sp": None},
                                remat_policy="dots", capacity_factor=1.0,
                                grad_accum=4),
    "moonshot-v1-16b-a3b": dict(sharding_overrides={"seq_sp": None},
                                remat_policy="dots", capacity_factor=1.0,
                                grad_accum=4),
    # dense: dots-remat; kv replication 8->16 heads shards the decode
    # cache 16-way.
    "qwen2-72b": dict(remat_policy="dots", kv_head_replication=2),
    "command-r-35b": dict(remat_policy="dots", kv_head_replication=2),
    "minitron-8b": dict(remat_policy="dots", kv_head_replication=2),
    "qwen2-vl-7b": dict(remat_policy="dots", kv_head_replication=4),
}

# Mesh-specific overlays of the reference's multi-pod meshes: the best
# sharding is a property of the mesh as well as the arch.
OPT_PACKS_MULTIPOD = {
    "qwen2-72b": dict(sharding_overrides={"seq_sp": None}, grad_accum=4),
}


def get_config(arch: str, smoke: bool = False, optimized: bool = False,
               multi_pod: bool = False) -> ModelConfig:
    """Resolve an ``--arch`` id (full config, or the reduced smoke config)."""
    import dataclasses
    key = arch.removesuffix("-smoke")
    modules = {**ARCH_MODULES, **PORT_ARCH_MODULES}
    if key not in modules:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(modules)}")
    mod = importlib.import_module(f"repro_torch.configs.{modules[key]}")
    cfg = mod.SMOKE_CONFIG if (smoke or arch.endswith("-smoke")) else mod.CONFIG
    if optimized and key in OPT_PACKS:
        cfg = dataclasses.replace(cfg, **OPT_PACKS[key])
        if multi_pod and key in OPT_PACKS_MULTIPOD:
            cfg = dataclasses.replace(cfg, **OPT_PACKS_MULTIPOD[key])
    return cfg


def get_shape(name: str) -> ShapeConfig:
    return SHAPES[name]


__all__ = [
    "ARCH_IDS",
    "ARCH_MODULES",
    "PORT_ARCH_MODULES",
    "DEFAULT_RULES",
    "LOGICAL_AXES",
    "SHAPES",
    "ModelConfig",
    "ShapeConfig",
    "cell_is_runnable",
    "get_config",
    "get_shape",
]
