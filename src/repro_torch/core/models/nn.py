"""Feed-forward NN over aggregated job-level features -> scaled PCC params.

Also hosts the generic minibatch trainer (`fit_model`) shared with the GNN:
eager PyTorch steps through the repo's own optimizer
(``repro_torch.optim.AdamW``), one of the three §4.5 losses, and the
reference's deterministic host-side shuffling.

Layout note: the reference keeps each layer's weight as an (in, out) matrix
and computes ``x @ w + b``; ``nn.Linear`` keeps (out, in) and computes
``x @ weight.T + bias`` — the same function (see ``convert.py``).
"""
from __future__ import annotations

import dataclasses
import math
import time
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

from repro_torch.core.losses import LossWeights, make_loss
from repro_torch.core.pcc import PCCScaler
from repro_torch.optim.adamw import AdamW, AdamWConfig

__all__ = ["NNConfig", "MLP", "init_linear", "fit_model"]


@dataclasses.dataclass(frozen=True)
class NNConfig:
    hidden: Tuple[int, ...] = (32, 16)
    lr: float = 3e-3
    epochs: int = 60
    batch_size: int = 256
    loss: str = "lf2"
    weights: LossWeights = LossWeights()
    seed: int = 0


def init_linear(layer: nn.Linear, generator: torch.Generator) -> nn.Linear:
    """The reference's init: N(0, 1) / sqrt(fan_in) weights, zero biases."""
    with torch.no_grad():
        fan_in = layer.weight.shape[1]
        layer.weight.copy_(torch.randn(layer.weight.shape, generator=generator)
                           / math.sqrt(fan_in))
        layer.bias.zero_()
    return layer


class MLP(nn.Module):
    """ReLU MLP; ``layers[i]`` is the reference's ``params[f"l{i}"]``."""

    def __init__(self, in_dim: int, hidden: Tuple[int, ...], out_dim: int = 2,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        g = torch.Generator().manual_seed(0) if generator is None else generator
        dims = (in_dim,) + tuple(hidden) + (out_dim,)
        self.layers = nn.ModuleList(
            init_linear(nn.Linear(dims[i], dims[i + 1]), g)
            for i in range(len(dims) - 1))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n = len(self.layers)
        for i, layer in enumerate(self.layers):
            x = layer(x)
            if i < n - 1:
                x = torch.relu(x)
        return x


def fit_model(apply_fn: Callable[[nn.Module, Dict[str, torch.Tensor]],
                                 torch.Tensor],
              module: nn.Module, inputs: Dict[str, np.ndarray],
              batch_extras: Dict[str, np.ndarray], scaler: PCCScaler,
              cfg: NNConfig) -> Dict[str, Any]:
    """Generic trainer for PCC-parameter models; trains ``module`` in place.

    apply_fn(module, model_inputs) -> (B, 2) scaled predictions.
    inputs: arrays the model consumes (all shaped (N, ...)).
    batch_extras: target_z / observed_alloc / observed_runtime / xgb_runtime.
    Inputs go to the module's device once; each batch is gathered there by
    the indices of the reference's ``RandomState(cfg.seed)`` permutation,
    and ``nb = n // batch_size`` drops the tail, as the reference does.
    Returns history {loss curves, epoch_time_s}.
    """
    dev = next(module.parameters()).device
    loss_fn = make_loss(cfg.loss, scaler, cfg.weights)
    opt = AdamW(module.parameters(),
                AdamWConfig(lr=cfg.lr, weight_decay=0.0, clip_norm=1.0,
                            warmup_steps=20, total_steps=10**9))  # flat lr
    to_dev = lambda v: torch.as_tensor(np.asarray(v, np.float32)).to(dev)
    inputs_d = {k: to_dev(v) for k, v in inputs.items()}
    extras_d = {k: to_dev(v) for k, v in batch_extras.items()}

    n = next(iter(batch_extras.values())).shape[0]
    nb = max(1, n // cfg.batch_size)

    rng = np.random.RandomState(cfg.seed)
    history = {"loss": [], "epoch_time_s": []}
    for _ in range(cfg.epochs):
        t0 = time.time()
        order = torch.from_numpy(rng.permutation(n)).to(dev)
        ep_loss = torch.zeros((), device=dev)
        for b in range(nb):
            sel = order[b * cfg.batch_size:(b + 1) * cfg.batch_size]
            model_in = {k: v[sel] for k, v in inputs_d.items()}
            extras = {k: v[sel] for k, v in extras_d.items()}
            module.zero_grad(set_to_none=True)
            loss, _ = loss_fn(apply_fn(module, model_in), extras)
            loss.backward()
            opt.step()
            ep_loss += loss.detach()
        history["loss"].append(float(ep_loss) / nb)   # one sync per epoch
        history["epoch_time_s"].append(time.time() - t0)
    return history
