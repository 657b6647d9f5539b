"""Parameter schema: one source of truth for shapes and initialisation.

A schema is a tree (nested dicts) of ``ParamSpec``; ``init_params``
materialises it. The reference's logical axes are kept on each spec, so a
schema reads the same in both packages, but nothing here shards: the port
serves on one card. Mesh, shardings and ``Sharder`` come with the
multi-card LM slice; until then no function of the port takes a ``shard``
argument.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Optional, Tuple, Union

import torch

__all__ = ["ParamSpec", "init_params", "map_specs"]


@dataclasses.dataclass(frozen=True)
class ParamSpec:
    shape: Tuple[int, ...]
    axes: Tuple[Optional[str], ...]   # logical axis name per dim (None = replicated)
    init: str = "normal"              # normal | zeros | ones | scaled
    scale: float = 1.0

    def __post_init__(self):
        assert len(self.shape) == len(self.axes), (self.shape, self.axes)


def map_specs(fn: Callable[[ParamSpec], Any], schema) -> Any:
    """Apply ``fn`` to every spec of a schema, visiting dict keys in sorted
    order (the order in which JAX flattens the reference's trees)."""
    if isinstance(schema, ParamSpec):
        return fn(schema)
    return {k: map_specs(fn, schema[k]) for k in sorted(schema)}


def init_params(schema, generator: torch.Generator,
                dtype: Union[str, torch.dtype],
                device: Union[str, torch.device, None] = None) -> Any:
    """Materialise a schema with the reference's law: zeros, ones, or a
    normal of std ``scale / sqrt(fan_in)``, where fan_in is the first dim
    of a matrix (so the stacked layer axis for block weights, as in the
    reference) and the last dim of a vector. Drawn in float32 from
    ``generator`` on its own device, then cast to ``dtype`` on ``device``
    (the generator's by default). A leaf whose first axis is ``"layers"``
    is drawn one layer's slice at a time (the std still that of the whole
    leaf), so the float32 transient is one layer's: a stacked expert leaf
    of moonshot-v1-16b-a3b is 8.9 G elements. The numbers differ from the
    reference's ``jax.random`` draws; the law is the same."""
    dtype = getattr(torch, dtype) if isinstance(dtype, str) else dtype
    device = generator.device if device is None else torch.device(device)

    def normal(shape, std):
        w = torch.randn(shape, generator=generator, dtype=torch.float32,
                        device=generator.device)
        return w.mul_(std)

    def one(spec: ParamSpec) -> torch.Tensor:
        if spec.init == "zeros":
            return torch.zeros(spec.shape, dtype=dtype, device=device)
        if spec.init == "ones":
            return torch.ones(spec.shape, dtype=dtype, device=device)
        fan_in = spec.shape[0] if len(spec.shape) > 1 else max(spec.shape[-1], 1)
        std = spec.scale / math.sqrt(fan_in)
        if spec.axes[0] != "layers":
            return normal(spec.shape, std).to(device=device, dtype=dtype)
        out = torch.empty(spec.shape, dtype=dtype, device=device)
        for layer in out:
            layer.copy_(normal(spec.shape[1:], std))
        return out

    return map_specs(one, schema)
