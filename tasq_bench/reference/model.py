"""The PCC models' forward passes and the parameter decode, in plain
PyTorch on the host.

``Weights`` holds the benchmark's drawn tensors by name (``nn``: the MLP's
layers; ``gnn``: the GCN layers, the context matrix and the MLP head),
each weight as (out, in) beside its bias. The forward runs in float64
(the reference) or in float32 with every product's operands rounded to
TF32's 10-bit mantissa (the control: TF32 is the next precision below the
float32 the configurations state, with TF32 off).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

import numpy as np
import torch

__all__ = ["Scaler", "Weights", "nn_z", "gnn_z", "decode", "tf32"]


@dataclasses.dataclass(frozen=True)
class Scaler:
    """The PCC target scaling: a = -softplus(za sd_a + mu_a), b = exp(zb
    sd_b + mu_b)."""
    mu_a: float
    sd_a: float
    mu_b: float
    sd_b: float


@dataclasses.dataclass
class Weights:
    family: str
    tensors: Dict[str, torch.Tensor]     # name -> host float64 tensor
    mlp: List[str]                       # layer names of the (head) MLP
    gcn: List[str] = dataclasses.field(default_factory=list)


def tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 ``x`` rounded to nearest on a 10-bit mantissa (TF32)."""
    bits = x.to(torch.float32).contiguous().view(torch.int32)
    bits = (bits + 0x1000) & ~0x1FFF
    return bits.view(torch.float32)


def _matmul(x, w, control):
    if control:
        return tf32(x) @ tf32(w)
    return x @ w


def _linear(x, w: Dict[str, torch.Tensor], name, control):
    return _matmul(x, w[name + ".weight"].T, control) + w[name + ".bias"]


def _cast(w: Weights, control: bool) -> Dict[str, torch.Tensor]:
    dt = torch.float32 if control else torch.float64
    return {k: v.to(dt) for k, v in w.tensors.items()}


def _mlp(x, w, names, control):
    for i, name in enumerate(names):
        x = _linear(x, w, name, control)
        if i < len(names) - 1:
            x = torch.relu(x)
    return x


def nn_z(features: np.ndarray, mu: np.ndarray, sd: np.ndarray, w: Weights,
         control: bool = False) -> torch.Tensor:
    """(B, 51) raw job features -> (B, 2) scaled parameters."""
    t = _cast(w, control)
    dt = torch.float32 if control else torch.float64
    x = torch.as_tensor(np.asarray(features), dtype=dt)
    x = (x - torch.as_tensor(mu, dtype=dt)) / torch.as_tensor(sd, dtype=dt)
    return _mlp(x, t, w.mlp, control)


def gnn_z(feat: np.ndarray, adj: np.ndarray, mask: np.ndarray, w: Weights,
          control: bool = False) -> torch.Tensor:
    """(B, N, 49) operator features, (B, N, N) normalised adjacency, (B, N)
    node mask -> (B, 2): GCN layers, global-context attention pooling,
    MLP head (SimGNN, paper section 4.4)."""
    t = _cast(w, control)
    dt = torch.float32 if control else torch.float64
    h = torch.as_tensor(np.asarray(feat), dtype=dt)
    a = torch.as_tensor(np.asarray(adj), dtype=dt)
    m = torch.as_tensor(np.asarray(mask), dtype=dt)
    for name in w.gcn:
        h = torch.relu(_linear(_matmul(a, h, control), t, name, control))
        h = h * m[..., None]
    mean_h = h.sum(1) / torch.clamp(m.sum(1, keepdim=True), min=1.0)
    ctx = torch.tanh(_matmul(mean_h, t["w_ctx"], control))
    att = torch.sigmoid(_matmul(h, ctx[..., None], control)[..., 0]) * m
    g = _matmul(att[:, None, :], h, control)[:, 0]
    return _mlp(g, t, w.mlp, control)


def decode(z: torch.Tensor, s: Scaler) -> Tuple[np.ndarray, np.ndarray]:
    """(B, 2) scaled parameters -> (a, b) as float64 numpy arrays."""
    za, zb = z[..., 0], z[..., 1]
    a = -torch.logaddexp(za * s.sd_a + s.mu_a, torch.zeros((), dtype=z.dtype))
    b = torch.exp(zb * s.sd_b + s.mu_b)
    return a.double().numpy(), b.double().numpy()
