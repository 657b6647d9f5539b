"""Graph neural network over operator-level features + plan DAG (paper §4.4).

SimGNN-style three-stage architecture (Figure 9):
  1. GCN neighbor aggregation (Kipf-Welling) -> node embeddings;
  2. global-context attention pooling: context c = tanh(mean(H) W_c); node
     attention = sigmoid(H c); graph embedding = attention-weighted sum;
  3. MLP head -> the two scaled PCC parameters.

Operates on padded batches: features (B, N, P), normalized adjacency
(B, N, N), node mask (B, N). Masked nodes contribute nothing to means,
attention, or sums. The adjacency product is a plain batched matmul
(``torch.bmm``), as it is a plain einsum in the reference.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple

import torch
from torch import nn

from repro_torch.core.models.nn import MLP, init_linear

__all__ = ["GNNConfig", "GNN"]


@dataclasses.dataclass(frozen=True)
class GNNConfig:
    gcn_dims: Tuple[int, ...] = (64, 64, 32)
    head_hidden: Tuple[int, ...] = (16,)
    seed: int = 0


class GNN(nn.Module):
    """``gcn[i]`` is the reference's ``params["gcn"][f"g{i}"]``, ``w_ctx``
    its (D, D) context matrix, ``head`` its MLP head."""

    def __init__(self, in_dim: int, cfg: GNNConfig,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        g = (torch.Generator().manual_seed(cfg.seed) if generator is None
             else generator)
        dims = (in_dim,) + tuple(cfg.gcn_dims)
        self.gcn = nn.ModuleList(
            init_linear(nn.Linear(dims[i], dims[i + 1]), g)
            for i in range(len(dims) - 1))
        d = cfg.gcn_dims[-1]
        self.w_ctx = nn.Parameter(torch.randn((d, d), generator=g)
                                  / math.sqrt(d))
        self.head = MLP(d, cfg.head_hidden, 2, generator=g)

    def forward(self, model_in: Dict[str, torch.Tensor]) -> torch.Tensor:
        """model_in: features (B,N,P), adj (B,N,N), mask (B,N) -> (B,2)."""
        h = model_in["features"]
        adj = model_in["adj"]
        node_mask = model_in["mask"]
        mask = node_mask[..., None]                          # (B, N, 1)

        for layer in self.gcn:
            h = torch.relu(layer(torch.bmm(adj, h)))
            h = h * mask                                     # re-zero padding

        # global-context attention pooling
        denom = torch.clamp(torch.sum(mask, dim=1), min=1.0)  # (B, 1)
        mean_h = torch.sum(h, dim=1) / denom                 # (B, D)
        ctx = torch.tanh(mean_h @ self.w_ctx)                # (B, D)
        att = torch.sigmoid(torch.einsum("bnd,bd->bn", h, ctx))
        att = att * node_mask
        g = torch.einsum("bn,bnd->bd", att, h)               # (B, D)
        return self.head(g)
