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
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import model_api
from repro_torch.optim.adamw import AdamW, AdamWConfig

__all__ = ["TrainState", "tree_leaves", "tree_unflatten", "init_train_state",
           "train_state_from_params", "state_leaves", "state_from_leaves",
           "make_train_step", "make_prefill_step", "make_decode_step"]


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
    not copies."""
    opt = state.opt
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


def make_train_step(cfg: ModelConfig):
    """Returns train_step(state, batch) -> (state, metrics), the AdamW
    update taken with the state's optimizer and its configuration."""
    mod = model_api.get_module(cfg)

    def grads_of(leaves, params, batch):
        total, metrics = mod.forward_train(params, batch, cfg)
        return torch.autograd.grad(total, leaves), metrics

    def train_step(state: TrainState, batch) -> Tuple[TrainState, Dict[str, Any]]:
        leaves = state.opt.params
        if cfg.grad_accum > 1:
            k = cfg.grad_accum
            splits = {n: t.chunk(k) for n, t in batch.items()}
            grads = [torch.zeros_like(p, dtype=torch.float32) for p in leaves]
            for i in range(k):
                g, metrics = grads_of(
                    leaves, state.params, {n: s[i] for n, s in splits.items()})
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
        state.step += 1
        return state, metrics

    return train_step


def make_prefill_step(cfg: ModelConfig):
    mod = model_api.get_module(cfg)

    def prefill_step(params, batch):
        return mod.prefill(params, batch, cfg)

    return prefill_step


def make_decode_step(cfg: ModelConfig):
    mod = model_api.get_module(cfg)

    def decode_step(params, batch):
        cache = batch["cache"]
        rest = {k: v for k, v in batch.items() if k != "cache"}
        return mod.decode_step(params, rest, cache, cfg)

    return decode_step
