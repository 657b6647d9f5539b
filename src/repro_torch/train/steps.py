"""Step factories: train, prefill and decode as plain functions.

The port of ``repro.train.steps``. PyTorch runs eagerly, so there is
nothing to ``jit``; the factories keep the reference's shape
(``fn(state, batch)``, ``fn(params, batch)``) so that ``launch.train`` and
``launch.serve`` read the same in both packages. The train state is
updated in place (the reference donates its state to the jitted step):
``train_step`` returns the same ``TrainState`` with its parameters, m, v
and step advanced. The AdamW configuration belongs to the state's
optimizer, as a ``torch.optim`` optimizer holds its own, so
``make_train_step`` takes none (the reference's takes ``opt_cfg``).

With a mesh (a ``DeviceMesh`` with the reference's axis names), the
factories build a ``Sharder`` for the model's constraint sites, and the
state and batch are DTensors (``shard_state``, ``shard_batch``) with the
placements ``state_shardings`` and ``batch_shardings`` give: AdamW then
runs on the local shards, each gradient redistributed to its
parameter's placements first (the data-parallel reduction).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import torch

from torch.distributed.tensor import DTensor, Replicate, distribute_tensor
from torch.distributed.tensor.experimental import implicit_replication

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.models import model_api
from repro_torch.models.params import Sharder
from repro_torch.optim.adamw import AdamW, AdamWConfig

__all__ = ["TrainState", "tree_leaves", "tree_unflatten", "init_train_state",
           "train_state_from_params", "state_leaves", "state_from_leaves",
           "make_train_state_specs", "state_shardings", "batch_shardings",
           "shard_state", "shard_batch", "make_train_step",
           "make_prefill_step", "make_decode_step"]


def tree_leaves(tree) -> List[torch.Tensor]:
    """The tensors of a nested dict, keys in sorted order (the order in
    which JAX flattens the reference's trees)."""
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in tree_leaves(tree[k])]
    return [tree]


def tree_unflatten(like, leaves: Sequence[torch.Tensor]):
    """The nested dict of ``like``'s structure holding ``leaves`` in
    ``tree_leaves`` order."""
    it = iter(leaves)

    def build(t):
        if isinstance(t, dict):
            return {k: build(t[k]) for k in sorted(t)}
        return next(it)

    out = build(like)
    assert next(it, None) is None, "more leaves than the tree holds"
    return out


@dataclasses.dataclass
class TrainState:
    """Parameters (a tree of leaf tensors that require grad), the AdamW
    state over ``tree_leaves(params)`` (float32 m and v, and its count) and
    the step."""
    params: Any
    opt: AdamW
    step: int = 0


def init_train_state(cfg: ModelConfig, generator: torch.Generator,
                     device: Union[str, torch.device, None] = None,
                     opt_cfg: Optional[AdamWConfig] = None) -> TrainState:
    """Seeded weights (``model_api.init``) on ``device``, the card unless
    ``"cpu"``, and an AdamW with ``opt_cfg`` (the reference's default if
    None) and zero float32 m and v."""
    return train_state_from_params(model_api.init(cfg, generator, device),
                                   opt_cfg)


def train_state_from_params(params, opt_cfg: Optional[AdamWConfig] = None
                            ) -> TrainState:
    """A fresh train state (zero m and v, step 0) around ``params``, whose
    leaves are made to require grad, updated by an AdamW with ``opt_cfg``
    (the reference's default if None)."""
    leaves = tree_leaves(params)
    for t in leaves:
        t.requires_grad_(True)
    return TrainState(params=params,
                      opt=AdamW(leaves, opt_cfg or AdamWConfig()))


def state_leaves(state: TrainState) -> List[torch.Tensor]:
    """The train state as a flat list in the order in which JAX flattens
    the reference's ``TrainState``: the parameters (``tree_leaves``), the
    optimizer's count (int32, 0-d), its m and v (float32, the parameters'
    order), then the step (int32, 0-d). The tensors are the state's own,
    not copies. A ``state_shardings`` tree (its ``opt`` a dict) flattens
    in the same order."""
    opt = state.opt
    if isinstance(opt, dict):
        return [*tree_leaves(state.params), opt["count"],
                *tree_leaves(opt["m"]), *tree_leaves(opt["v"]), state.step]
    dev = opt.params[0].device
    scalar = lambda n: torch.tensor(n, dtype=torch.int32, device=dev)
    return ([*tree_leaves(state.params), scalar(opt.count), *opt.m, *opt.v,
             scalar(state.step)])


def state_from_leaves(leaves: Sequence[torch.Tensor],
                      like: TrainState) -> TrainState:
    """The train state held by ``leaves`` (``state_leaves``' order), with
    ``like``'s parameter tree and AdamW configuration: its parameters
    require grad and its AdamW holds the given m, v and count."""
    n = len(like.opt.params)
    assert len(leaves) == 3 * n + 2, (len(leaves), n)
    params = tree_unflatten(like.params, leaves[:n])
    for t in leaves[:n]:
        t.requires_grad_(True)
    opt = AdamW(leaves[:n], like.opt.cfg, m=leaves[n + 1:2 * n + 1],
                v=leaves[2 * n + 1:3 * n + 1], count=int(leaves[n]))
    return TrainState(params=params, opt=opt, step=int(leaves[-1]))


def make_train_state_specs(cfg: ModelConfig) -> TrainState:
    """The train state as ``meta`` tensors: parameters, float32 m and v,
    no memory (the dry run's stand-in)."""
    return train_state_from_params(model_api.specs(cfg))


def state_shardings(cfg: ModelConfig, mesh) -> TrainState:
    """Placements of the train state on ``mesh``: m and v as their
    parameters, the count and the step replicated. Its ``opt`` is a dict
    {"count", "m", "v"}; ``state_leaves`` flattens it."""
    ps = model_api.shardings(cfg, mesh)
    rep = (Replicate(),) * mesh.ndim
    return TrainState(params=ps, opt={"count": rep, "m": ps, "v": ps},
                      step=rep)


def batch_shardings(cfg: ModelConfig, shape: ShapeConfig, mesh):
    """Placements of the input batch (``model_api.input_specs``), each dim
    that its mesh axes do not divide replicated (global_batch=1
    long-context decode cannot shard on data). GQA caches whose kv-head
    count does not divide the model axis use ``cfg.kv_head_replication``
    rather than uneven sharding."""
    shard = Sharder(mesh, cfg.rules())
    ax = model_api.input_axes(cfg, shape)
    specs = model_api.input_specs(cfg, shape)

    def one(a, spec):
        if isinstance(spec, model_api.Cache):
            return model_api.Cache(**{
                f: one(getattr(a, f), t) for f in spec.__dataclass_fields__
                if (t := getattr(spec, f)) is not None})
        if isinstance(spec, dict):
            return {k: one(a[k], spec[k]) for k in spec}
        return shard.placements(spec.shape, *a)

    return one(ax, specs)


def shard_state(state: TrainState, cfg: ModelConfig, mesh) -> TrainState:
    """``state`` (full tensors, the same on every rank) as DTensors on
    ``mesh`` with ``state_shardings``' placements; a new state whose
    parameters require grad."""
    sh = state_leaves(state_shardings(cfg, mesh))
    leaves = [distribute_tensor(t.detach(), mesh, p, src_data_rank=None)
              for t, p in zip(state_leaves(state), sh)]
    return state_from_leaves(leaves, state)


def shard_batch(batch: Dict[str, torch.Tensor], cfg: ModelConfig, mesh
                ) -> Dict[str, torch.Tensor]:
    """A concrete batch (full tensors, the same on every rank) as DTensors
    on ``mesh``, batch-sharded as ``batch_shardings`` shards it."""
    shard = Sharder(mesh, cfg.rules())
    ax = model_api.batch_axes(batch)
    return {k: distribute_tensor(t, mesh, shard.placements(t.shape, *ax[k]),
                                 src_data_rank=None)
            for k, t in batch.items()}


def _microbatches(batch, k: int, cfg: ModelConfig, mesh):
    """The reference's split of every batch leaf along axis 0 into ``k``
    contiguous microbatches (raising where its reshape does). On a mesh
    the leaves are gathered first (tokens: a few MB) and each microbatch
    is sharded again, so that microbatch ``i`` holds the same global rows
    as the reference's."""
    bad = {n: tuple(t.shape) for n, t in batch.items() if t.shape[0] % k}
    if bad:
        raise ValueError(f"grad_accum {k} does not divide axis 0 of "
                         f"the batch leaves {bad}")
    if mesh is None:
        splits = {n: t.chunk(k) for n, t in batch.items()}
        return [{n: s[i] for n, s in splits.items()} for i in range(k)]
    full = {n: t.full_tensor() if isinstance(t, DTensor) else t
            for n, t in batch.items()}
    splits = {n: t.chunk(k) for n, t in full.items()}
    return [shard_batch({n: s[i] for n, s in splits.items()}, cfg, mesh)
            for i in range(k)]


def make_train_step(cfg: ModelConfig, mesh=None):
    """Returns train_step(state, batch) -> (state, metrics), the AdamW
    update taken with the state's optimizer and its configuration. With
    ``mesh``, state and batch are DTensors on it."""
    mod = model_api.get_module(cfg)
    shard = Sharder(mesh, cfg.rules())

    def grads_of(leaves, params, batch):
        total, metrics = mod.forward_train(params, batch, cfg, shard)
        if mesh is None:
            return torch.autograd.grad(total, leaves), metrics
        # the backward (remat's recompute included) meets the host-made
        # constants that the forward took as replicated
        with implicit_replication():
            grads = torch.autograd.grad(total, leaves)
        grads = tuple(g.redistribute(p.device_mesh, p.placements)
                      for g, p in zip(grads, leaves))
        return grads, metrics

    def train_step(state: TrainState, batch) -> Tuple[TrainState, Dict[str, Any]]:
        leaves = state.opt.params
        if cfg.grad_accum > 1:
            k = cfg.grad_accum
            grads = [torch.zeros_like(p, dtype=torch.float32) for p in leaves]
            for mb in _microbatches(batch, k, cfg, mesh):
                g, metrics = grads_of(leaves, state.params, mb)
                for acc, gi in zip(grads, g):
                    acc.add_(gi)
                del g
            for acc in grads:
                acc.div_(k)
        else:
            grads, metrics = grads_of(leaves, state.params, batch)
        metrics = {n: v.detach() for n, v in metrics.items()}
        metrics.update(state.opt.update(grads))
        del grads
        if mesh is not None:      # every rank reads the same numbers
            metrics = {n: v.full_tensor() if isinstance(v, DTensor) else v
                       for n, v in metrics.items()}
        state.step += 1
        return state, metrics

    return train_step


def make_prefill_step(cfg: ModelConfig, mesh=None):
    mod = model_api.get_module(cfg)
    shard = Sharder(mesh, cfg.rules())

    def prefill_step(params, batch, **kw):
        return mod.prefill(params, batch, cfg, shard, **kw)

    return prefill_step


def make_decode_step(cfg: ModelConfig, mesh=None):
    mod = model_api.get_module(cfg)
    shard = Sharder(mesh, cfg.rules())

    def decode_step(params, batch, **kw):
        cache = batch["cache"]
        rest = {k: v for k, v in batch.items() if k != "cache"}
        return mod.decode_step(params, rest, cache, cfg, shard, **kw)

    return decode_step
