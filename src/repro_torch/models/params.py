"""Parameter schema: one source of truth for shapes, logical axes and init.

A schema is a tree (nested dicts) of ``ParamSpec``. From it we derive:
  * ``init_params``     -- materialised tensors,
  * ``param_shapes``    -- ``meta`` tensors (the dry run: no allocation),
  * ``param_axes``      -- the logical-axes tree,
  * ``param_specs``     -- each leaf's partition spec on a mesh,
  * ``param_shardings`` -- each leaf's DTensor placements on a mesh.

A partition spec is the reference's ``PartitionSpec`` as a tuple, one
entry per tensor dim: None (replicated), a mesh-dim name, or a tuple of
names (sharded over those mesh dims, the first outermost). Its placements
are one ``Shard(d)`` or ``Replicate()`` per mesh dim of the
``DeviceMesh``; a dim sharded over ("pod", "data") is ``Shard(d)`` on
both, which DTensor splits pod-major, as the spec means. ``Sharder`` is
the reference's ``with_sharding_constraint`` as ``DTensor.redistribute``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Mapping, Optional, Sequence, Tuple, Union

import torch
from torch.distributed.tensor import (DTensor, Partial, Placement, Replicate,
                                      Shard)

__all__ = ["ParamSpec", "init_params", "map_specs", "param_shapes",
           "param_axes", "logical_to_spec", "filter_rules_for_mesh",
           "fit_spec", "spec_to_placements", "param_specs",
           "param_shardings", "Sharder", "NULL_SHARDER"]

Spec = Tuple[Union[None, str, Tuple[str, ...]], ...]


@dataclasses.dataclass(frozen=True)
class ParamSpec:
    shape: Tuple[int, ...]
    axes: Tuple[Optional[str], ...]   # logical axis name per dim (None = replicated)
    # normal | zeros | ones | scaled, and the hybrid_moe family's laws:
    # fan_in | a_log | dt_bias (see ``init_params``)
    init: str = "normal"
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
    reference's ``jax.random`` draws; the law is the same.

    The hybrid_moe family, which the reference lacks, has laws of its own:
    ``"fan_in"`` is a normal of std ``scale / sqrt(shape[-2])``, the
    contraction dim of a (..., in, out) weight whatever leads it; and
    Mamba-2's published ones, ``"a_log"`` log U(1, 16) and ``"dt_bias"``
    the inverse softplus of a step size log-uniform in [1e-3, 1e-1]."""
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
        if spec.init in ("a_log", "dt_bias"):
            u = torch.rand(spec.shape, generator=generator,
                           dtype=torch.float32, device=generator.device)
            if spec.init == "a_log":
                w = torch.log(1.0 + 15.0 * u)
            else:
                step = torch.exp(math.log(1e-3) + u * math.log(100.0))
                w = step + torch.log(-torch.expm1(-step))
            return w.to(device=device, dtype=dtype)
        if spec.init == "fan_in":
            fan_in = spec.shape[-2]
        else:
            fan_in = (spec.shape[0] if len(spec.shape) > 1
                      else max(spec.shape[-1], 1))
        std = spec.scale / math.sqrt(fan_in)
        if spec.axes[0] != "layers":
            return normal(spec.shape, std).to(device=device, dtype=dtype)
        out = torch.empty(spec.shape, dtype=dtype, device=device)
        for layer in out:
            layer.copy_(normal(spec.shape[1:], std))
        return out

    return map_specs(one, schema)


def param_shapes(schema, dtype: Union[str, torch.dtype]) -> Any:
    """The schema as ``meta`` tensors of ``dtype``: shapes and types, no
    memory (the reference's ``ShapeDtypeStruct`` tree)."""
    dtype = getattr(torch, dtype) if isinstance(dtype, str) else dtype
    return map_specs(lambda s: torch.empty(s.shape, dtype=dtype,
                                           device="meta"), schema)


def param_axes(schema) -> Any:
    return map_specs(lambda s: s.axes, schema)


def logical_to_spec(axes: Sequence[Optional[str]],
                    rules: Mapping[str, Any]) -> Spec:
    """Map logical axis names to a partition spec via the rule table.

    Duplicate mesh axes (illegal in a partition spec) keep the first
    occurrence; later dims fall back to replication."""
    used: set = set()
    out = []
    for name in axes:
        mesh_axes = rules.get(name) if name else None
        if mesh_axes is None:
            out.append(None)
            continue
        if isinstance(mesh_axes, str):
            mesh_axes = (mesh_axes,)
        picked = tuple(a for a in mesh_axes if a not in used)
        used.update(picked)
        if not picked:
            out.append(None)
        elif len(picked) == 1:
            out.append(picked[0])
        else:
            out.append(picked)
    return tuple(out)


def _mesh_axes(mesh) -> Tuple[str, ...]:
    return tuple(mesh.mesh_dim_names or ())


def _mesh_sizes(mesh) -> dict:
    return dict(zip(_mesh_axes(mesh), mesh.mesh.shape))


def filter_rules_for_mesh(rules: Mapping[str, Any], mesh) -> dict:
    """Drop mesh axes that the mesh lacks (e.g. 'pod' on single-pod)."""
    ok = set(_mesh_axes(mesh))

    def fix(v):
        if v is None:
            return None
        if isinstance(v, str):
            return v if v in ok else None
        if not isinstance(v, (tuple, list)):
            return v        # non-axis option (e.g. pad_kv_cache flag)
        kept = tuple(a for a in v if a in ok)
        return kept if kept else None

    return {k: fix(v) for k, v in rules.items()}


def fit_spec(shape: Sequence[int], spec: Spec, mesh) -> Spec:
    """``spec`` with every dim that its mesh axes do not divide replicated,
    never unevenly sharded (keeps whisper's 12 heads off a 16-way axis)."""
    sizes = _mesh_sizes(mesh)
    fixed = []
    for dim, axis in zip(shape, spec):
        if axis is None:
            fixed.append(None)
            continue
        names = (axis,) if isinstance(axis, str) else axis
        total = math.prod(sizes[n] for n in names)
        fixed.append(axis if dim % total == 0 else None)
    return tuple(fixed)


def spec_to_placements(spec: Spec, mesh) -> tuple:
    """One ``Shard(d)`` or ``Replicate()`` per mesh dim."""
    out = [Replicate()] * len(_mesh_axes(mesh))
    index = {a: i for i, a in enumerate(_mesh_axes(mesh))}
    for d, axis in enumerate(spec):
        for name in ((axis,) if isinstance(axis, str) else axis or ()):
            out[index[name]] = Shard(d)
    return tuple(out)


def param_specs(schema, mesh, rules: Mapping[str, Any]) -> Any:
    """Each leaf's partition spec on ``mesh`` (divisibility-fitted)."""
    rules = filter_rules_for_mesh(rules, mesh)
    return map_specs(lambda s: fit_spec(
        s.shape, logical_to_spec(s.axes, rules), mesh), schema)


def param_shardings(schema, mesh, rules: Mapping[str, Any]) -> Any:
    """Each leaf's DTensor placements on ``mesh``."""
    sharder = Sharder(mesh, rules)
    return map_specs(lambda s: sharder.placements(s.shape, *s.axes), schema)


def _grad_placements(in_placements) -> tuple:
    """The placements of a local region's input gradients. Where the
    region splits its work along a mesh dim (an input is sharded on it),
    an input replicated on that dim gets only its share of the gradient
    from each rank: a ``Partial`` sum (the SSD scan's B and C over head
    shards, the MoE's tokens over expert shards, the decay rates over
    batch shards). Elsewhere the gradient keeps the input's placements."""
    split = {i for pl in in_placements if pl is not None
             for i, q in enumerate(pl) if isinstance(q, Shard)}
    return tuple(None if pl is None else tuple(
        Partial() if isinstance(q, Replicate) and i in split else q
        for i, q in enumerate(pl)) for pl in in_placements)


class _DenseGrad(torch.autograd.Function):
    """Identity whose backward makes the gradient contiguous."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g.contiguous()


class Sharder:
    """The reference's sharding constraint from logical axes: identity
    without a mesh; with one, ``x.redistribute`` to the placements the
    axes name (an indivisible dim replicated). ``x`` must then be a
    DTensor on that mesh."""

    def __init__(self, mesh, rules: Mapping[str, Any]):
        self.mesh = mesh
        self.rules = (filter_rules_for_mesh(rules, mesh) if mesh is not None
                      else dict(rules))

    def placements(self, shape: Sequence[int], *axes: Optional[str]) -> tuple:
        assert len(axes) == len(shape), (axes, tuple(shape))
        return spec_to_placements(
            fit_spec(shape, logical_to_spec(axes, self.rules), self.mesh),
            self.mesh)

    def __call__(self, x: torch.Tensor, *axes: Optional[str]) -> torch.Tensor:
        if self.mesh is None:
            return x
        if not isinstance(x, DTensor):
            raise TypeError(
                f"Sharder on a mesh takes DTensors; got a {type(x).__name__} "
                f"of shape {tuple(x.shape)} for axes {axes}")
        return x.redistribute(self.mesh, self.placements(x.shape, *axes))

    def view(self, x: torch.Tensor, shape: Sequence[int],
             *axes: Optional[str]) -> torch.Tensor:
        """``shard(x.view(shape), *axes)``, with ``x`` redistributed first
        so that DTensor can take the view: a dim that the view splits is
        sharded as the leading factor the axes name (q's (B, S, H * hd)
        as its H heads), or replicated where they name none (whisper's 12
        heads on a 16-way axis). The shape must keep the sharded dims'
        index: only trailing dims are split."""
        if self.mesh is None:
            return x.view(shape)
        target = self.placements(shape, *axes)
        for q in target:
            if isinstance(q, Shard) and (tuple(shape[:q.dim])
                                         != tuple(x.shape[:q.dim])):
                raise ValueError(f"view {tuple(x.shape)} -> {tuple(shape)} "
                                 f"moves sharded dim {q.dim}")
        return x.redistribute(self.mesh, target).view(shape)

    def local(self, fn: Callable, args: Sequence[Any],
              in_placements: Sequence[Optional[tuple]], out_placements):
        """``fn(*args)`` on the local shards: off a mesh, ``fn(*args)``;
        on one, ``local_map`` with each DTensor argument redistributed to
        its placements first (the reference's constraint at the region's
        entry) and the outputs wrapped with ``out_placements``. For the
        ops DTensor has no strategy for, and the kernels, which launch on
        local storage."""
        if self.mesh is None:
            return fn(*args)
        from torch.distributed.tensor.experimental import local_map
        if out_placements and isinstance(out_placements[0], Placement):
            out_placements = (out_placements,)      # one output

        def dense_out(*a):
            # a DTensor's views assume its local shard is laid out densely:
            # so are the region's outputs and its inputs' gradients
            out = fn(*(_DenseGrad.apply(t) if isinstance(t, torch.Tensor)
                       and t.requires_grad else t for t in a))
            if isinstance(out, torch.Tensor):
                return out.contiguous()
            return tuple(o.contiguous() if isinstance(o, torch.Tensor) else o
                         for o in out)

        return local_map(dense_out, out_placements=out_placements,
                         in_placements=tuple(in_placements),
                         in_grad_placements=_grad_placements(in_placements),
                         device_mesh=self.mesh,
                         redistribute_inputs=True)(*args)


NULL_SHARDER = Sharder(None, {})
